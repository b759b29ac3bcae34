"""Stem SE-fusion + dual max-pool kernel (``csrc/stem_fuse.cu``).

Port of ``dynmm_tpu/kernels/stem_fuse.py``. The stem cell of the main path
(``SkipGateESANet._stems``) at (B, 240, 320, 64) runs in three steps:

1. ``channel_sums`` of both stem maps in one launch (``kernels/se.py``);
2. the tiny SE MLP on (B, 64) in PyTorch ops (``se_gate_from_sums``), as the
   JAX cell leaves it to XLA, on the net's activation (relu, swish or
   hswish);
3. ``stem_fuse_pool``: one launch that scale-adds the maps and max-pools
   (3×3, stride 2, pad 1, −inf padding) both the fused map and raw depth,
   writing only the two pooled maps.

Plain ``add`` fusion takes the same pooling launch with unit scales
(``stem_add_pool``: x·1.0 is exact). Maps are NHWC fp32 or bf16; C % 4 == 0
on the card. At bf16 the scales are rounded to bf16 (the JAX cell's
``.astype(rgb.dtype)``) and ``rgb·s_r``, ``depth·s_d`` and their sum are
each rounded to bf16, in the kernel and in the plain version alike (the
Pallas function's per-op bf16 arithmetic); the max-pools are exact.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from dynmm_tpu_torch.kernels import _build
from dynmm_tpu_torch.kernels.se import channel_sums, channel_sums_plain, se_scale


def _max_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def stem_fuse_pool_plain(rgb, depth, s_r, s_d):
    fused = rgb * s_r[:, None, None, :] + depth * s_d[:, None, None, :]
    return _max_pool_nhwc(fused), _max_pool_nhwc(depth)


def stem_fuse_pool(rgb: torch.Tensor, depth: torch.Tensor,
                   s_r: torch.Tensor, s_d: torch.Tensor):
    """(maxpool(rgb·s_r + depth·s_d), maxpool(depth)) for (B, H, W, C) maps
    and (B, C) scale vectors, all of one dtype (fp32 or bf16); pooled maps
    are (B, ⌈H/2⌉, ⌈W/2⌉, C)."""
    if torch.compiler.is_exporting():
        return torch.ops.dynmm.stem_fuse_pool(rgb, depth, s_r, s_d)
    if not _build.on_card(rgb, depth, s_r, s_d):
        return stem_fuse_pool_plain(rgb, depth, s_r, s_d)
    return launch_stem_fuse_pool(rgb, depth, s_r, s_d)


def launch_stem_fuse_pool(rgb, depth, s_r, s_d):
    """``stem_fuse_pool`` on the card: the checks and the launch."""
    b, h, w, c = rgb.shape
    same = (rgb.dtype,)
    _build.require(rgb, "rgb", dtypes=_build.MAPS)
    _build.require(depth, "depth", (b, h, w, c), dtypes=same)
    _build.require(s_r, "s_r", (b, c), dtypes=same)
    _build.require(s_d, "s_d", (b, c), dtypes=same)
    if c % 4:
        raise ValueError(f"stem_fuse_pool takes C % 4 == 0, got {c}")
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out_f = torch.empty((b, oh, ow, c), device=rgb.device, dtype=rgb.dtype)
    out_d = torch.empty_like(out_f)
    fn = _build.function("stem_fuse",
                         _build.symbol("dynmm_stem_fuse_pool", rgb), 6, 4)
    _build.check(fn(_build.ptr(rgb), _build.ptr(depth), _build.ptr(s_r),
                    _build.ptr(s_d), _build.ptr(out_f), _build.ptr(out_d),
                    b, h, w, c, _build.stream()), "stem_fuse_pool")
    _build.count("stem_fuse_pool", rgb)
    return out_f, out_d


def se_gate_from_sums(sums, hw: int, w1, b1, w2, b2,
                      act: Callable = torch.relu):
    """sigmoid(act(mean @ w1 + b1) @ w2 + b2) — the SE MLP on (B, C);
    ``act`` the net's activation (relu: the TPU kernel's). The mean takes
    the weights' dtype: fp32 in eval, bf16 in a bf16 train step (the JAX
    module's rounded mean)."""
    return se_scale((sums / float(hw)).to(w1.dtype), w1, b1, w2, b2, act)


def stem_se_fusion_pool(rgb, depth, wr1, br1, wr2, br2, wd1, bd1, wd2, bd2,
                        act: Callable = torch.relu,
                        use_kernels: bool = True):
    """The whole stem cell (JAX signature): SE-recalibrated add + both
    max-pools. The SE scales are computed in fp32 from the fp32 sums, with
    the MLP on ``act``, and rounded to the maps' dtype; neither kernel
    computes an activation, so every net's stem takes them.
    ``use_kernels=False`` runs the plain versions wherever the tensors
    lie."""
    b, h, w, _ = rgb.shape
    sums = channel_sums if use_kernels else channel_sums_plain
    pool = stem_fuse_pool if use_kernels else stem_fuse_pool_plain
    sums_r, sums_d = sums(rgb, depth)
    s_r = se_gate_from_sums(sums_r, h * w, wr1, br1, wr2, br2, act)
    s_d = se_gate_from_sums(sums_d, h * w, wd1, bd1, wd2, bd2, act)
    return pool(rgb, depth, s_r.to(rgb.dtype).contiguous(),
                s_d.to(rgb.dtype).contiguous())


def stem_add_pool(rgb, depth, use_kernels: bool = True):
    """The stem cell of plain ``add`` fusion: (maxpool(rgb + depth),
    maxpool(depth)), through ``stem_fuse_pool`` with unit scales."""
    pool = stem_fuse_pool if use_kernels else stem_fuse_pool_plain
    ones = rgb.new_ones((rgb.shape[0], rgb.shape[-1]))
    return pool(rgb, depth, ones, ones)
