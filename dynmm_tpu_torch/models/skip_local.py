"""SkipESANet — fusion-level DynMM with local per-stage gates (port of
``dynmm_tpu/models/skip_local.py``; the reference's
``FusionDynMM/src/models/model_skip_mod.py``).

Four ``SqueezeAndExciteReweigh`` gates: gate 0 sees the two stem maps,
gate i the outputs of stage i, and gate i's weights mix the fusion after
stage i + 1. ``block_rule[i]`` ∈ {0: rgb only, 1: always fuse, 2: dynamic,
``w_0·rgb + w_1·(rgb + depth)``}. A dynamic stage passes its fuse weight on
as ``prev_weight`` (unless ``ini_stage``), which scales the next gates'
fuse column; rules 0 and 1 keep the last dynamic stage's ``prev_weight``,
as the reference does. Fusion is plain add throughout, whatever
``fuse_depth_in_rgb_encoder`` says: the model builds its parts from the
config with ``add`` fusion, so it has no SE fusion cells and its stem runs
``stem_fuse_pool`` with unit scales.

The gates sample Gumbel noise from the ``torch.Generator`` the caller
passes (``random_policy``: uniform branch choices). In bf16 the gates
compute in bf16 as the JAX gates do (the SE weight, its sigmoid, the
logits and the Gumbel softmax), and so do the mix weights and
``prev_weight``. ``test`` makes every
sample hard. There is no resource loss: in training ``forward`` returns the
four-scale predictions alone, every cell on its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from dynmm_tpu_torch.models.esanet import (ESANetConfig, _DualEncoderParts,
                                           compute_in, require_no_quant)
from dynmm_tpu_torch.nn.layers import SqueezeAndExciteReweigh, nchw


class SkipESANet(_DualEncoderParts):
    """Local-gate fusion-level DynMM. Public layout is NHWC:
    ``forward(rgb (B,H,W,3), depth (B,H,W,1), generator)`` → logits
    (B,H,W,classes), or ``(logits, weights)`` with ``return_weights``
    (four (B, 2) tensors)."""

    def __init__(self, cfg: ESANetConfig,
                 block_rule: Sequence[int] = (1, 1, 1, 1)):
        require_no_quant(cfg, "the local-gate SkipESANet")
        super().__init__(dataclasses.replace(cfg,
                                             fuse_depth_in_rgb_encoder="add"))
        self.block_rule = tuple(int(r) for r in block_rule)
        if len(self.block_rule) != 4 or not set(self.block_rule) <= {0, 1, 2}:
            raise ValueError(f"block_rule must be 4 of 0/1/2, got {block_rule}")
        ch = self.encoder_rgb.down_channels
        for i, c in enumerate([64, ch[4], ch[8], ch[16]]):
            gate = SqueezeAndExciteReweigh(c, activation=cfg.activation)
            compute_in(gate, cfg)
            setattr(self, f"gate_layer{i}", gate)

    def forward(self, rgb, depth, generator: torch.Generator,
                temp: float = 1.0, hard: bool = False,
                ini_stage: bool = False, random_policy: bool = False,
                test: bool = False, return_weights: bool = False,
                use_kernels: bool = True):
        use_kernels = use_kernels and not self.training
        gate_kw = dict(temp=temp, hard=hard, random_policy=random_policy,
                       test=test, use_kernels=use_kernels)
        rgb = self.encoder_rgb.stem(nchw(rgb))
        depth = self.encoder_depth.stem(nchw(depth))
        weights = [self.gate_layer0(rgb, depth, generator, **gate_kw)]
        fused, depth = self.stem_pool(rgb, depth, use_kernels)

        skips = []
        prev_weight = None
        for i in (1, 2, 3, 4):
            rgb = getattr(self.encoder_rgb, f"layer{i}")(fused, use_kernels)
            depth = getattr(self.encoder_depth, f"layer{i}")(depth,
                                                             use_kernels)
            rule, w = self.block_rule[i - 1], weights[i - 1]
            if rule == 0:
                fused = rgb
            elif rule == 1:
                fused = rgb + depth
            else:
                w0 = w[:, 0, None, None, None].to(rgb.dtype)
                w1 = w[:, 1, None, None, None].to(rgb.dtype)
                fused = w0 * rgb + w1 * (rgb + depth)
                prev_weight = None if ini_stage else w[:, 1]
            if i < 4:
                weights.append(getattr(self, f"gate_layer{i}")(
                    rgb, depth, generator, prev_weight=prev_weight,
                    **gate_kw))
                skips.append(self.skip(i, fused))
        out = self._nhwc(self.head(fused, skips, use_kernels))
        return (out, weights) if return_weights else out
