"""ESANetOneModality — the single-encoder (rgb-only or depth-only)
baseline (port of ``dynmm_tpu/models/one_modality.py``; the reference's
``FusionDynMM/src/models/model_one_modality.py``).

One ResNet encoder on a 3-channel (rgb) or 1-channel (depth) image, with
``weighting_in_encoder == "SE-add"`` a ``SqueezeAndExcitation``
recalibration after the stem and each stage (the single-map ``fused_se``
cell on the card), then the family's skips, context module and decoder.
Unlike the dual-encoder models, the skip projections are built whatever
``encoder_decoder_fusion`` says (the decoder then ignores the skips), as in
the reference. In bf16 (``ESANetConfig.dtype``) the stem casts the image
and every cell serves bf16 maps; the SE cells are ``fused_se``'s bf16
form, whose MLP runs in fp32 on the fp32 weights (the Pallas function's
rounding, where the JAX module runs it on bf16 copies).
"""

from __future__ import annotations

from dynmm_tpu_torch.models.esanet import (ESANetConfig, _Head, build_encoder,
                                           compute_in, require_no_quant)
from dynmm_tpu_torch.nn.layers import (SqueezeAndExcitation, max_pool_3x3_s2,
                                       nchw)


class ESANetOneModality(_Head):
    """Public layout is NHWC: ``forward(image (B,H,W,input_channels))`` →
    logits (B,H,W,classes) (H/4 with ``low_res``); in training the four
    scales, every cell on its plain version."""

    def __init__(self, cfg: ESANetConfig, input_channels: int = 3,
                 weighting_in_encoder: str = "None"):
        require_no_quant(cfg, "ESANetOneModality, which has no quantized "
                              "conv in the JAX package either")
        super().__init__()
        self.cfg = cfg
        self.encoder = build_encoder(cfg, "rgb", input_channels)
        ch = self.encoder.down_channels
        self.se = weighting_in_encoder == "SE-add"
        if self.se:
            for i, c in enumerate([64, ch[4], ch[8], ch[16], ch[32]]):
                setattr(self, f"se_layer{i}",
                        SqueezeAndExcitation(c, activation=cfg.activation))
        self._build_head(cfg, ch, skip_layers=True)
        compute_in(self, cfg)

    def _se(self, i: int, x, use_kernels: bool):
        if not self.se:
            return x
        return getattr(self, f"se_layer{i}").recalibrate(x, use_kernels)

    def forward(self, image, low_res: bool = False, use_kernels: bool = True):
        use_kernels = use_kernels and not self.training
        out = self._se(0, self.encoder.stem(nchw(image)), use_kernels)
        out = max_pool_3x3_s2(out)
        skips = []
        for i in (1, 2, 3, 4):
            out = getattr(self.encoder, f"layer{i}")(out, use_kernels)
            out = self._se(i, out, use_kernels)
            if i < 4:
                skips.append(self.skip(i, out))
        return self._nhwc(self.head(out, skips, use_kernels, low_res))
