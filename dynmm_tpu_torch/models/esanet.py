"""ESANet pieces shared by the dual-encoder models (port of
``dynmm_tpu/models/esanet.py``): config, decoder, encoders, fusion cells,
skip projections and context module.

In eval the decoder returns the logits (``low_res``: the H/4 logits). In
training (``module.training``) it also returns the class maps of its three
``side_output`` 1×1 convs, each taken on its module's map before the
upsample: ``(out, down_8, down_16, down_32)``, from decoder modules 3, 2
and 1. Fusion is ``SE-add`` (the SE cells: ``channel_sums`` +
``stem_fuse_pool`` at the stem, ``se_fuse_mixed`` after each stage) or
plain ``add`` (``stem_fuse_pool`` with unit scales at the stem, PyTorch
adds after); ``encoder_decoder_fusion`` other than ``add`` builds no skip
projections and the decoder ignores the skips; the context module is PPM,
APPM or none. ``ESANet`` is the static baseline: depth always fused.

``ESANetConfig.activation`` is relu, swish (alias silu) or hswish in any
casing, normalised when the config is made. The TPU kernels of the SE cell
and the NBt1D block fuse relu, so a swish or hswish net runs those cells
in PyTorch ops (the SE MLP with the net's activation) and NBt1D blocks on
their cuDNN convs; its stem keeps ``channel_sums`` and ``stem_fuse_pool``
and its decoder ``learned_upsample``, which compute no activation.

``ESANetConfig.dtype`` is the compute dtype (parameters stay fp32): None or
fp32, or bf16 in eval and in training for every model of the family (the
global-gate SkipGateESANet, the static ESANet, the local-gate SkipESANet
and ESANetOneModality), whose modules the constructor puts in bf16
(``compute_in``, ``nn/layers.py::set_compute_dtype``). A bf16 train step
rounds where the JAX model at ``dtype=bfloat16`` does (``nn/layers.py``).

``ESANetConfig.quant`` (``nn/quant.py``): None, ``"calib"`` or ``"int8"``
for the convs the JAX model quantizes: the encoder stages' (every block's,
downsamples included), the decoder's ``conv3x3`` and NBt1D blocks,
``conv_out`` and the skip projections. The stems, the context module, the
gate, the SE MLPs, ``side_output`` and the upsamples stay float. The
global-gate SkipGateESANet and the static ESANet (each fp32 or bf16)
take it; the local-gate SkipESANet and ESANetOneModality raise, as the JAX
factory refuses the one and has no quantized conv in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn

from dynmm_tpu_torch.kernels.stem_fuse import stem_add_pool
from dynmm_tpu_torch.models.context import get_context_module
from dynmm_tpu_torch.models.resnet import NonBottleneck1D, ResNet, make_resnet
from dynmm_tpu_torch.nn.layers import (Conv2d, ConvBNAct,
                                       SqueezeAndExciteFusionAdd, Upsample,
                                       activation_name, nchw, nhwc,
                                       set_compute_dtype)


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
    dtype: torch.dtype | None = None  # compute dtype; params stay fp32
    # int8 post-training quantization (nn/quant.py): None | "calib" | "int8"
    # for the encoder stages' convs, the decoder's ConvBNActs, NBt1D blocks
    # and conv_out, and the skip projections
    quant: str | None = None

    def __post_init__(self):
        # one name a net: "ReLU" is relu, "silu" is swish (the JAX table)
        object.__setattr__(self, "activation",
                           activation_name(self.activation))


def compute_in(module: nn.Module, cfg: ESANetConfig) -> None:
    """Serve ``module``'s maps in ``cfg.dtype`` (bf16 copies of its conv
    weights); fp32 leaves it as built."""
    if cfg.dtype not in (None, torch.float32):
        set_compute_dtype(module, cfg.dtype)


def require_no_quant(cfg: ESANetConfig, model: str) -> None:
    """Raise on a quant mode for ``model`` (the JAX factory quantizes the
    global-gate SkipGateESANet and the static ESANet only)."""
    if cfg.quant is not None:
        raise NotImplementedError(
            f"--quant supports global-gate / static models only, not {model}")


class DecoderModule(nn.Module):
    """3×3 ConvBNAct → N NonBottleneck1D blocks → ×2 upsample → + skip
    (the skip only under ``encoder_decoder_fusion == "add"``)."""

    def __init__(self, channels_in: int, channels_dec: int, nr_blocks: int,
                 num_classes: int, upsampling_mode: str,
                 activation: str = "relu", encoder_decoder_fusion: str = "add",
                 quant: str | None = None):
        super().__init__()
        self.add_skip = encoder_decoder_fusion == "add"
        self.conv3x3 = ConvBNAct(channels_in, channels_dec, 3,
                                 activation=activation, quant=quant)
        self.decoder_blocks = nn.ModuleList(
            NonBottleneck1D(channels_dec, channels_dec, activation=activation,
                            quant=quant)
            for _ in range(nr_blocks))
        self.side_output = Conv2d(channels_dec, num_classes, 1)
        self.upsample = Upsample(upsampling_mode, channels_dec)

    def forward(self, x, skip, use_kernels: bool = True):
        """The upsampled map plus ``skip``; in training also the
        ``side_output`` map taken before the upsample."""
        out = self.conv3x3(x)
        for block in self.decoder_blocks:
            out = block(out, use_kernels=use_kernels)
        up = self.upsample(out, use_kernels=use_kernels)
        if self.add_skip:
            up = up + skip
        return (up, self.side_output(out)) if self.training else up


class Decoder(nn.Module):
    """Three decoder modules + 3×3 output conv + two ×2 upsamples."""

    def __init__(self, channels_in: int, channels_decoder: Sequence[int],
                 nr_decoder_blocks: Sequence[int], num_classes: int,
                 upsampling_mode: str, activation: str = "relu",
                 encoder_decoder_fusion: str = "add",
                 quant: str | None = None):
        super().__init__()
        ins = (channels_in, channels_decoder[0], channels_decoder[1])
        for i in range(3):
            setattr(self, f"decoder_module_{i + 1}", DecoderModule(
                ins[i], channels_decoder[i], nr_decoder_blocks[i],
                num_classes, upsampling_mode, activation,
                encoder_decoder_fusion, quant))
        self.conv_out = Conv2d(channels_decoder[2], num_classes, 3,
                               padding=1, quant=quant)
        self.upsample1 = Upsample(upsampling_mode, num_classes)
        self.upsample2 = Upsample(upsampling_mode, num_classes)

    def forward(self, enc_outs, use_kernels: bool = True,
                low_res: bool = False):
        """Logits at full resolution, or with ``low_res`` the H/4 logits
        after ``conv_out`` (the two 40-channel upsamples skipped). In
        training: ``(out, down_8, down_16, down_32)`` at full resolution."""
        out, skip_16, skip_8, skip_4 = enc_outs
        if self.training:
            out, down_32 = self.decoder_module_1(out, skip_16, use_kernels)
            out, down_16 = self.decoder_module_2(out, skip_8, use_kernels)
            out, down_8 = self.decoder_module_3(out, skip_4, use_kernels)
        else:
            out = self.decoder_module_1(out, skip_16, use_kernels)
            out = self.decoder_module_2(out, skip_8, use_kernels)
            out = self.decoder_module_3(out, skip_4, use_kernels)
        out = self.conv_out(out)
        if low_res and not self.training:
            return out
        out = self.upsample1(out, use_kernels=use_kernels)
        out = self.upsample2(out, use_kernels=use_kernels)
        return (out, down_8, down_16, down_32) if self.training else out


def build_encoder(cfg: ESANetConfig, which: str,
                  input_channels: int | None = None) -> ResNet:
    """RGB (3-ch) or depth (1-ch) encoder per the config."""
    if input_channels is None:
        input_channels = 3 if which == "rgb" else 1
    return make_resnet(getattr(cfg, f"encoder_{which}"),
                       block=cfg.encoder_block, input_channels=input_channels,
                       activation=cfg.activation, quant=cfg.quant)


class _Head(nn.Module):
    """Skip projections, context module and decoder over one encoder's
    channels (``down_channels``), shared by every model of the family."""

    def _build_head(self, cfg: ESANetConfig, ch: dict[int, int],
                    skip_layers: bool | None = None) -> None:
        """``skip_layers``: build the projections where the widths differ
        (default: under additive encoder-decoder fusion only)."""
        cd = cfg.channels_decoder
        if skip_layers is None:
            skip_layers = cfg.encoder_decoder_fusion == "add"
        for i, (c_enc, c_dec) in enumerate(
                ((ch[4], cd[2]), (ch[8], cd[1]), (ch[16], cd[0])), start=1):
            setattr(self, f"skip_layer{i}", None if (
                c_enc == c_dec or not skip_layers) else
                nn.Sequential(ConvBNAct(c_enc, c_dec, 1,
                                        activation=cfg.activation,
                                        quant=cfg.quant)))
        # learned-3x3 upsampling cannot upscale the non-×2 context maps
        context_upsampling = ("nearest" if "learned-3x3" in cfg.upsampling
                              else cfg.upsampling)
        self.context_module, channels_after = get_context_module(
            cfg.context_module, ch[32], cd[0],
            (cfg.height // 32, cfg.width // 32), activation=cfg.activation,
            upsampling_mode=context_upsampling)
        self.decoder = Decoder(channels_after, cd, cfg.nr_decoder_blocks,
                               cfg.num_classes, cfg.upsampling, cfg.activation,
                               cfg.encoder_decoder_fusion, cfg.quant)

    def skip(self, idx: int, fused):
        layer = getattr(self, f"skip_layer{idx}")
        return fused if layer is None else layer(fused)

    def head(self, fused, skips, use_kernels: bool = True,
             low_res: bool = False):
        """Context module (if any) + decoder over the stage-4 map and skips
        3..1."""
        if self.context_module is not None:
            fused = self.context_module(fused)
        return self.decoder([fused, skips[2], skips[1], skips[0]],
                            use_kernels, low_res)

    def _nhwc(self, out):
        """The decoder's output in the public NHWC layout (a tuple of the
        four scales in training)."""
        if self.training:
            return tuple(p.permute(0, 2, 3, 1) for p in out)
        return out.permute(0, 2, 3, 1)


class _DualEncoderParts(_Head):
    """Encoders, fusion cells, skip projections, context module and decoder
    of the dual-encoder ESANet family, under the reference's torch names.
    ``SE-add`` fusion builds ``se_layer0..4``; plain ``add`` builds none."""

    def __init__(self, cfg: ESANetConfig):
        super().__init__()
        if cfg.fuse_depth_in_rgb_encoder not in ("SE-add", "add"):
            raise ValueError("fuse_depth_in_rgb_encoder must be 'SE-add' or "
                             f"'add', got {cfg.fuse_depth_in_rgb_encoder!r}")
        self.cfg = cfg
        self.plain_add = cfg.fuse_depth_in_rgb_encoder == "add"
        self.encoder_rgb = build_encoder(cfg, "rgb")
        self.encoder_depth = build_encoder(cfg, "depth")
        ch = self.encoder_rgb.down_channels
        if not self.plain_add:
            for i, c in enumerate([64, ch[4], ch[8], ch[16], ch[32]]):
                setattr(self, f"se_layer{i}",
                        SqueezeAndExciteFusionAdd(c, activation=cfg.activation))
        self._build_head(cfg, ch)
        compute_in(self, cfg)

    def stem_pool(self, rgb, depth, use_kernels: bool = True):
        """Stem tail: (pool(fuse(rgb, depth)), pool(depth)), NCHW; the
        ``channel_sums`` + ``stem_fuse_pool`` cell for SE-add,
        ``stem_fuse_pool`` with unit scales for add."""
        if not self.plain_add:
            return self.se_layer0.fuse_and_pool(rgb, depth, use_kernels)
        fused, dpool = stem_add_pool(nhwc(rgb), nhwc(depth), use_kernels)
        return nchw(fused), nchw(dpool)

    def fuse(self, idx: int, rgb, depth, use_kernels: bool = True):
        """Unmixed fusion of stage ``idx``: ``se(rgb) + se(depth)`` or
        ``rgb + depth``."""
        if self.plain_add:
            return rgb + depth
        return getattr(self, f"se_layer{idx}")(rgb, depth, use_kernels)

    def fuse_mixed(self, idx: int, rgb, depth, w_rgb,
                   use_kernels: bool = True):
        """``w·rgb + (1−w)·fuse(rgb, depth)``, ``w_rgb`` (B,): the
        ``se_fuse_mixed`` cell for SE-add; ``rgb + (1−w)·depth`` for add."""
        if self.plain_add:
            return rgb + (1.0 - w_rgb.to(rgb.dtype))[:, None, None, None] * depth
        return getattr(self, f"se_layer{idx}").fuse_mixed(rgb, depth, w_rgb,
                                                           use_kernels)


class ESANet(_DualEncoderParts):
    """The static ESANet: depth fused after the stem and every stage. Public
    layout is NHWC: ``forward(rgb (B,H,W,3), depth (B,H,W,1))`` → logits
    (B,H,W,classes) (H/4 with ``low_res``); in training the four scales
    ``(out, down_8, down_16, down_32)``, every cell on its plain version."""

    def forward(self, rgb, depth, low_res: bool = False,
                use_kernels: bool = True):
        use_kernels = use_kernels and not self.training
        rgb = self.encoder_rgb.stem(nchw(rgb))
        depth = self.encoder_depth.stem(nchw(depth))
        rgb, depth = self.stem_pool(rgb, depth, use_kernels)
        skips = []
        for i in (1, 2, 3, 4):
            rgb = getattr(self.encoder_rgb, f"layer{i}")(rgb, use_kernels)
            depth = getattr(self.encoder_depth, f"layer{i}")(depth,
                                                             use_kernels)
            rgb = self.fuse(i, rgb, depth, use_kernels)
            if i < 4:
                skips.append(self.skip(i, rgb))
        return self._nhwc(self.head(rgb, skips, use_kernels, low_res))
