"""Squeeze-and-excite kernels (``csrc/se.cu``): the two-map channel sums and
the gate-mixed SE fusion.

Ports of ``dynmm_tpu/kernels/stem_fuse.py::channel_sums`` and
``dynmm_tpu/kernels/se.py::fused_se``, the latter in the form the main
path's SE-add fusion cells take (``SqueezeAndExciteFusionAdd.fuse_mixed``):

    out = rgb·(w + (1−w)·s_r) + depth·((1−w)·s_d),
    s   = sigmoid(relu(mean_HW(x) @ w1 + b1) @ w2 + b2)

Maps are NHWC (B, H, W, C) fp32; SE weights take the JAX layout
``w1 (C, C/16)``, ``w2 (C/16, C)``. Each wrapper takes its plain version
for CPU tensors and launches its kernel for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from dynmm_tpu_torch.kernels import _build

_TARGET_BLOCKS = 4 * 132  # four blocks per SM of an H100


def _splits(batch: int, work: int, min_work: int) -> int:
    """Blocks per sample: enough to give the card ~4 per SM, none with
    fewer than ``min_work`` items."""
    return max(1, min(math.ceil(_TARGET_BLOCKS / batch), work // min_work))


# ---------------------------------------------------------------- sums
def channel_sums_plain(rgb: torch.Tensor, depth: torch.Tensor):
    return rgb.sum(dim=(1, 2)), depth.sum(dim=(1, 2))


def _launch_sums(a: torch.Tensor, b: torch.Tensor | None):
    bsz, c = a.shape[0], a.shape[-1]
    hw = a.numel() // (bsz * c)
    _build.require(a, "x")
    if b is not None:
        _build.require(b, "depth", tuple(a.shape))
    if c > 1024:
        raise ValueError(f"channel_sums takes C <= 1024, got {c}")
    splits = _splits(bsz, hw, 64)
    maps = 1 if b is None else 2
    partial = torch.empty((maps, bsz, splits, c), device=a.device,
                          dtype=torch.float32)
    out_a = torch.empty((bsz, c), device=a.device, dtype=torch.float32)
    out_b = None if b is None else torch.empty_like(out_a)
    fn = _build.function("se", "dynmm_channel_sums", 5, 4)
    _build.check(fn(_build.ptr(a), _build.ptr(b), _build.ptr(partial),
                    _build.ptr(out_a), _build.ptr(out_b), bsz, hw, c, splits,
                    _build.stream()), "channel_sums")
    _build.LAUNCHES["channel_sums"] += 1
    return out_a, out_b


def channel_sums(rgb: torch.Tensor, depth: torch.Tensor):
    """Per-sample per-channel fp32 sums of two (B, H, W, C) maps in one
    launch: ``(sums_rgb, sums_depth)``, each (B, C)."""
    if not _build.on_card(rgb, depth):
        return channel_sums_plain(rgb, depth)
    return _launch_sums(rgb, depth)


# ----------------------------------------------------------------- SE MLP
def se_scale(mean: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """sigmoid(relu(mean @ w1 + b1) @ w2 + b2) on (B, C)."""
    return torch.sigmoid(torch.relu(mean @ w1 + b1) @ w2 + b2)


def se_fuse_mixed_plain(rgb, depth, w_rgb, wr1, br1, wr2, br2,
                        wd1, bd1, wd2, bd2):
    s_r = se_scale(rgb.mean(dim=(1, 2)), wr1, br1, wr2, br2)
    s_d = se_scale(depth.mean(dim=(1, 2)), wd1, bd1, wd2, bd2)
    w = w_rgb[:, None].to(s_r.dtype)
    s_r = w + (1.0 - w) * s_r
    s_d = (1.0 - w) * s_d
    return rgb * s_r[:, None, None, :] + depth * s_d[:, None, None, :]


def _launch_mix(x_r, x_d, sums_r, sums_d, w_rgb, wr, wd):
    bsz, c = x_r.shape[0], x_r.shape[-1]
    hw = x_r.numel() // (bsz * c)
    if c % 4:
        raise ValueError(f"se mix takes C % 4 == 0, got {c}")
    cr = wr[0].shape[1]
    for i, (a, shape) in enumerate(zip(wr, ((c, cr), (cr,), (cr, c), (c,)))):
        _build.require(a, f"rgb SE weight {i}", shape)
    if x_d is not None:
        _build.require(x_d, "depth", tuple(x_r.shape))
        for i, (a, shape) in enumerate(zip(wd, ((c, cr), (cr,), (cr, c), (c,)))):
            _build.require(a, f"depth SE weight {i}", shape)
    if w_rgb is not None:
        _build.require(w_rgb, "w_rgb", (bsz,))
    out = torch.empty_like(x_r)
    chunks = _splits(bsz, hw * c // 4, 256)
    fn = _build.function("se", "dynmm_se_mix", 14, 5)
    _build.check(fn(_build.ptr(x_r), _build.ptr(x_d), _build.ptr(sums_r),
                    _build.ptr(sums_d), *map(_build.ptr, wr),
                    *(map(_build.ptr, wd) if wd else [None] * 4),
                    _build.ptr(w_rgb), _build.ptr(out), bsz, hw, c, cr,
                    chunks, _build.stream()), "se_mix")
    return out


def se_fuse_mixed(rgb, depth, w_rgb, wr1, br1, wr2, br2, wd1, bd1, wd2, bd2):
    """Gate-mixed SE-add fusion of two (B, H, W, C) maps; ``w_rgb`` (B,) is
    the weight on the unfused rgb branch. Two launches on the card: the
    shared ``channel_sums`` and the mix, which rebuilds both scale vectors
    from the sums in hand-written code."""
    args = (wr1, br1, wr2, br2, wd1, bd1, wd2, bd2)
    if not _build.on_card(rgb, depth, w_rgb, *args):
        return se_fuse_mixed_plain(rgb, depth, w_rgb, *args)
    _build.require(rgb, "rgb")
    sums_r, sums_d = _launch_sums(rgb, depth)
    out = _launch_mix(rgb, depth, sums_r, sums_d, w_rgb.float().contiguous(),
                      args[:4], args[4:])
    _build.LAUNCHES["se_fuse_mixed"] += 1
    return out


# ------------------------------------------------------------ single map
def se_reference(x, w1, b1, w2, b2):
    """Plain SE over (..., HW, C): x · sigmoid(relu(mean @ w1 + b1) @ w2 + b2)."""
    mean = x.mean(dim=-2, keepdim=True)
    return x * torch.sigmoid(torch.relu(mean @ w1 + b1) @ w2 + b2)


def fused_se(x, w1, b1, w2, b2):
    """Single-map SE with the JAX signature: x (HW, C) or (B, HW, C)."""
    if not _build.on_card(x, w1, b1, w2, b2):
        return se_reference(x, w1, b1, w2, b2)
    squeeze = x.dim() == 2
    xb = x[None] if squeeze else x
    _build.require(xb, "x")
    sums, _ = _launch_sums(xb, None)
    out = _launch_mix(xb, None, sums, None, None, (w1, b1, w2, b2), None)
    _build.LAUNCHES["fused_se"] += 1
    return out[0] if squeeze else out
