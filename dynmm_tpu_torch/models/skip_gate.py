"""SkipGateESANet — fusion-level DynMM with a global 5-way gate (port of
``dynmm_tpu/models/skip_gate.py``, dense eval forward).

One gate, computed after the stem from both modality maps, weights 5 paths
("fuse depth for the first k stages", k ∈ {0..4}). The dense forward
computes every branch and mixes with cumulative gate weights: block i's
unfused rgb branch gets ``Σ_{j<i} w_j`` for i = 1..3, and block 4 takes
``1 − w_4`` (the reference's quirk, kept as it is). With the hard gate the
one-hot weights make the mix exact, which is the served path.

Kernel sites on that path: the stem cell (``channel_sums`` +
``stem_fuse_pool``), every stride-1 NonBottleneck1D block (two
``nbt1d_pair``), the four gate-mixed SE fusion cells (``se_fuse_mixed``) and
the five learned upsamples (``learned_upsample``). ``use_kernels=False``
runs the plain PyTorch version of each instead, on the same weights.

``forward_switch*``, ``forward_routed_compact``, training (the resource
loss and its ``FLOP_TABLES``) and ``ini_stage`` exploration are not ported
yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dynmm_tpu_torch.core.gates import diff_softmax
from dynmm_tpu_torch.models.esanet import ESANetConfig, _DualEncoderParts
from dynmm_tpu_torch.nn.layers import BatchNorm2d, nchw


class GlobalGate(nn.Module):
    """concat(rgb, depth) at 1/4 res → 2 × (5×5/2 conv → BN → tanh) → global
    average pool → 1×1 conv to ``branch_num`` logits → DiffSoftmax. Runs in
    fp32; one conv on the concatenation equals the JAX split sum."""

    def __init__(self, in_channels: int = 64, branch_num: int = 5,
                 hidden_dim: int = 8):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(2 * in_channels, hidden_dim, 5, stride=2),
            BatchNorm2d(hidden_dim), nn.Tanh(),
            nn.Conv2d(hidden_dim, hidden_dim, 5, stride=2),
            BatchNorm2d(hidden_dim), nn.Tanh())
        self.fc = nn.Conv2d(hidden_dim, branch_num, 1, bias=False)

    def logits(self, rgb, depth):
        x = self.conv(torch.cat([rgb.float(), depth.float()], dim=1))
        return self.fc(x.mean(dim=(2, 3), keepdim=True))[:, :, 0, 0]

    def forward(self, rgb, depth, temp: float = 1.0, hard: bool = False):
        return diff_softmax(self.logits(rgb, depth), tau=temp, hard=hard,
                            dim=-1)


class SkipGateESANet(_DualEncoderParts):
    """Fusion-level DynMM segmentation net. Public layout is NHWC:
    ``forward(rgb (B,H,W,3), depth (B,H,W,1))`` → logits (B,H,W,classes)."""

    def __init__(self, cfg: ESANetConfig):
        super().__init__(cfg)
        self.gate_layer = GlobalGate(branch_num=5)

    def _stems(self, rgb, depth, use_kernels: bool = True):
        """NHWC images → the two pooled stem maps (NCHW)."""
        rgb = self.encoder_rgb.stem(nchw(rgb))
        depth = self.encoder_depth.stem(nchw(depth))
        return self.se_layer0.fuse_and_pool(rgb, depth, use_kernels)

    def _fuse_mixed(self, i: int, rgb, depth, w_rgb, use_kernels: bool = True):
        """``w·rgb + (1−w)·se_fuse(rgb, depth)``, ``w_rgb`` (B,)."""
        return getattr(self, f"se_layer{i}").fuse_mixed(rgb, depth, w_rgb,
                                                         use_kernels)

    def gate_weights(self, rgb, depth, temp: float = 1.0, hard: bool = False,
                     baseline: bool = False):
        """(B, 5) path weights from the pooled stem maps; ``baseline``
        forces path 4 (static ESANet)."""
        if baseline:
            w = torch.zeros((rgb.shape[0], 5), device=rgb.device,
                            dtype=rgb.dtype)
            w[:, 4] = 1.0
            return w
        return self.gate_layer(rgb, depth, temp=temp, hard=hard)

    def gate_only(self, rgb, depth, temp: float = 1.0,
                  use_kernels: bool = True):
        """Stems + hard gate: (B, 5) one-hot path weights."""
        r, d = self._stems(rgb, depth, use_kernels)
        return self.gate_weights(r, d, temp=temp, hard=True)

    def forward(self, rgb, depth, temp: float = 1.0, hard: bool = False,
                baseline: bool = False, return_weight: bool = False,
                use_kernels: bool = True):
        """Dense eval forward. Returns NHWC logits, or ``(logits, weight)``."""
        rgb, depth = self._stems(rgb, depth, use_kernels)
        weight = self.gate_weights(rgb, depth, temp=temp, hard=hard,
                                   baseline=baseline)
        skips = []
        fused = rgb
        for i in (1, 2, 3):
            rgb = getattr(self.encoder_rgb, f"layer{i}")(fused, use_kernels)
            depth = getattr(self.encoder_depth, f"layer{i}")(depth, use_kernels)
            # cumulative probability that the gate stopped fusing before i
            fused = self._fuse_mixed(i, rgb, depth, weight[:, :i].sum(dim=1),
                                     use_kernels)
            skips.append(self.skip(i, fused))
        rgb = self.encoder_rgb.layer4(fused, use_kernels)
        depth = self.encoder_depth.layer4(depth, use_kernels)
        fused = self._fuse_mixed(4, rgb, depth, 1.0 - weight[:, 4], use_kernels)
        out = self.head(fused, skips, use_kernels).permute(0, 2, 3, 1)
        return (out, weight) if return_weight else out
