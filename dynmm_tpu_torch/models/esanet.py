"""ESANet pieces shared by the dual-encoder models (port of
``dynmm_tpu/models/esanet.py``): config, decoder, encoders, fusion cells,
skip projections and context module.

Eval forward only: the decoder's ``side_output`` convs exist (their
weights load) but run only in training, which is not ported yet, nor is the
static ``ESANet``. ``low_res`` returns the H/4 logits. The port builds the
flagship's family: SE-add fusion, additive skips and a PPM context module.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch.nn as nn

from dynmm_tpu_torch.models.context import get_context_module
from dynmm_tpu_torch.models.resnet import NonBottleneck1D, ResNet, make_resnet
from dynmm_tpu_torch.nn.layers import ConvBNAct, SqueezeAndExciteFusionAdd, Upsample


@dataclasses.dataclass(frozen=True)
class ESANetConfig:
    """Architecture hyper-parameters (defaults: the flagship)."""

    height: int = 480
    width: int = 640
    num_classes: int = 40
    encoder_rgb: str = "resnet34"
    encoder_depth: str = "resnet34"
    encoder_block: str = "NonBottleneck1D"
    channels_decoder: Sequence[int] = (512, 256, 128)
    nr_decoder_blocks: Sequence[int] = (3, 3, 3)
    activation: str = "relu"
    encoder_decoder_fusion: str = "add"
    context_module: str = "ppm"
    fuse_depth_in_rgb_encoder: str = "SE-add"
    upsampling: str = "learned-3x3-zeropad"


class DecoderModule(nn.Module):
    """3×3 ConvBNAct → N NonBottleneck1D blocks → ×2 upsample → + skip."""

    def __init__(self, channels_in: int, channels_dec: int, nr_blocks: int,
                 num_classes: int, upsampling_mode: str,
                 activation: str = "relu"):
        super().__init__()
        self.conv3x3 = ConvBNAct(channels_in, channels_dec, 3,
                                 activation=activation)
        self.decoder_blocks = nn.ModuleList(
            NonBottleneck1D(channels_dec, channels_dec, activation=activation)
            for _ in range(nr_blocks))
        self.side_output = nn.Conv2d(channels_dec, num_classes, 1)
        self.upsample = Upsample(upsampling_mode, channels_dec)

    def forward(self, x, skip, use_kernels: bool = True):
        out = self.conv3x3(x)
        for block in self.decoder_blocks:
            out = block(out, use_kernels=use_kernels)
        return self.upsample(out, use_kernels=use_kernels) + skip


class Decoder(nn.Module):
    """Three decoder modules + 3×3 output conv + two ×2 upsamples."""

    def __init__(self, channels_in: int, channels_decoder: Sequence[int],
                 nr_decoder_blocks: Sequence[int], num_classes: int,
                 upsampling_mode: str, activation: str = "relu"):
        super().__init__()
        ins = (channels_in, channels_decoder[0], channels_decoder[1])
        for i in range(3):
            setattr(self, f"decoder_module_{i + 1}", DecoderModule(
                ins[i], channels_decoder[i], nr_decoder_blocks[i],
                num_classes, upsampling_mode, activation))
        self.conv_out = nn.Conv2d(channels_decoder[2], num_classes, 3,
                                  padding=1)
        self.upsample1 = Upsample(upsampling_mode, num_classes)
        self.upsample2 = Upsample(upsampling_mode, num_classes)

    def forward(self, enc_outs, use_kernels: bool = True,
                low_res: bool = False):
        """Logits at full resolution, or with ``low_res`` the H/4 logits
        after ``conv_out`` (the two 40-channel upsamples skipped)."""
        out, skip_16, skip_8, skip_4 = enc_outs
        out = self.decoder_module_1(out, skip_16, use_kernels)
        out = self.decoder_module_2(out, skip_8, use_kernels)
        out = self.decoder_module_3(out, skip_4, use_kernels)
        out = self.conv_out(out)
        if low_res:
            return out
        out = self.upsample1(out, use_kernels=use_kernels)
        return self.upsample2(out, use_kernels=use_kernels)


def build_encoder(cfg: ESANetConfig, which: str) -> ResNet:
    """RGB (3-ch) or depth (1-ch) encoder per the config."""
    return make_resnet(getattr(cfg, f"encoder_{which}"),
                       block=cfg.encoder_block,
                       input_channels=3 if which == "rgb" else 1,
                       activation=cfg.activation)


class _DualEncoderParts(nn.Module):
    """Encoders, SE fusion cells, skip projections, context module and
    decoder of the dual-encoder ESANet family, under the reference's torch
    names."""

    def __init__(self, cfg: ESANetConfig):
        super().__init__()
        if (cfg.fuse_depth_in_rgb_encoder, cfg.encoder_decoder_fusion) != (
                "SE-add", "add"):
            raise NotImplementedError(
                "the port builds SE-add fusion with additive skips; "
                f"got {cfg.fuse_depth_in_rgb_encoder!r}, "
                f"{cfg.encoder_decoder_fusion!r}")
        self.cfg = cfg
        self.encoder_rgb = build_encoder(cfg, "rgb")
        self.encoder_depth = build_encoder(cfg, "depth")
        ch = self.encoder_rgb.down_channels
        for i, c in enumerate([64, ch[4], ch[8], ch[16], ch[32]]):
            setattr(self, f"se_layer{i}",
                    SqueezeAndExciteFusionAdd(c, activation=cfg.activation))
        cd = cfg.channels_decoder
        for i, (c_enc, c_dec) in enumerate(
                ((ch[4], cd[2]), (ch[8], cd[1]), (ch[16], cd[0])), start=1):
            setattr(self, f"skip_layer{i}", None if c_enc == c_dec else
                    nn.Sequential(ConvBNAct(c_enc, c_dec, 1,
                                            activation=cfg.activation)))
        # learned-3x3 upsampling cannot upscale the non-×2 context maps
        context_upsampling = ("nearest" if "learned-3x3" in cfg.upsampling
                              else cfg.upsampling)
        self.context_module = get_context_module(
            cfg.context_module, ch[32], cd[0], activation=cfg.activation,
            upsampling_mode=context_upsampling)
        self.decoder = Decoder(cd[0], cd, cfg.nr_decoder_blocks,
                               cfg.num_classes, cfg.upsampling, cfg.activation)

    def fuse(self, idx: int, rgb, depth, use_kernels: bool = True):
        """Unmixed SE-add fusion ``se(rgb) + se(depth)`` of stage ``idx``."""
        return getattr(self, f"se_layer{idx}")(rgb, depth, use_kernels)

    def skip(self, idx: int, fused):
        layer = getattr(self, f"skip_layer{idx}")
        return fused if layer is None else layer(fused)

    def head(self, fused, skips, use_kernels: bool = True,
             low_res: bool = False):
        """Context module + decoder over the stage-4 fusion and skips 3..1."""
        return self.decoder([self.context_module(fused), skips[2], skips[1],
                             skips[0]], use_kernels, low_res)
