"""Squeeze-and-excite kernels (``csrc/se.cu``): the two-map channel sums and
the gate-mixed SE fusion.

Ports of ``dynmm_tpu/kernels/stem_fuse.py::channel_sums`` and
``dynmm_tpu/kernels/se.py::fused_se``, the latter in the form the main
path's SE-add fusion cells take (``SqueezeAndExciteFusionAdd.fuse_mixed``):

    out = rgb·(w + (1−w)·s_r) + depth·((1−w)·s_d),
    s   = sigmoid(relu(mean_HW(x) @ w1 + b1) @ w2 + b2)

Maps are NHWC (B, H, W, C), fp32 or bf16 (each kernel has a bf16 form);
SE weights stay fp32 and take the JAX layout ``w1 (C, C/16)``,
``w2 (C/16, C)``; the SE cell takes C ≤ ``SE_MAX_C`` (2048, ResNet50's
widest fusion cell). Each wrapper takes its plain version for CPU tensors
and launches its kernel for CUDA tensors (``launch_<name>``); while
``torch.export`` traces, it calls its ``dynmm::`` op (``ops.py``). Grids
are sized from the card's SM count; maps move in 16-byte accesses where C
and their alignment allow, in narrower ones otherwise
(``_access_width``).

At bf16 the plain versions round where the kernels round, which is where
the Pallas functions round: the sums are fp32; the SE cell rounds each
map's channel means (an fp32 mean) to bf16, runs the MLP in fp32 on the
fp32 weights, rounds the scale to bf16, and then computes the gate mix
``w + (1−w)·s``, ``(1−w)·s`` and ``rgb·s_r' + depth·s_d'`` op by op in
bf16, as the JAX model's ``fuse_mixed`` does. In fp32 (and float64) every
rounding point is the identity.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from dynmm_tpu_torch.kernels import _build


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in at least fp32 (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------- sums
def channel_sums_plain(rgb: torch.Tensor, depth: torch.Tensor):
    return wide(rgb).sum(dim=(1, 2)), wide(depth).sum(dim=(1, 2))


def channel_sums(rgb: torch.Tensor, depth: torch.Tensor):
    """Per-sample per-channel fp32 sums of two (B, H, W, C) fp32 or bf16
    maps (the stem cell's pass 1): ``(sums_rgb, sums_depth)``, each (B, C).
    One launch on the card: the last block of each (sample, map) adds the
    blocks' partial sums."""
    if torch.compiler.is_exporting():
        return torch.ops.dynmm.channel_sums(rgb, depth).unbind(0)
    if not _build.on_card(rgb, depth):
        return channel_sums_plain(rgb, depth)
    return launch_channel_sums(rgb, depth).unbind(0)


def launch_channel_sums(rgb: torch.Tensor, depth: torch.Tensor
                        ) -> torch.Tensor:
    """``channel_sums`` on the card: the checks and the launch; the two
    sums stacked, (2, B, C)."""
    bsz, c = rgb.shape[0], rgb.shape[-1]
    hw = rgb.numel() // (bsz * c)
    _build.require(rgb, "rgb", dtypes=_build.MAPS)
    _build.require(depth, "depth", tuple(rgb.shape), dtypes=(rgb.dtype,))
    if c > 1024:
        raise ValueError(f"channel_sums takes C <= 1024, got {c}")
    width = _access_width(c, (rgb, depth))
    splits = _sums_splits(bsz, hw, c, width, _build.sm_count(rgb))
    sums = torch.empty((2, bsz, c), device=rgb.device, dtype=torch.float32)
    partial = torch.empty(2 * bsz * splits * c, device=rgb.device,
                          dtype=torch.float32)
    fn = _build.function("se", _build.symbol("dynmm_channel_sums", rgb), 6, 5)
    out_r = sums.data_ptr()  # the depth sums follow, bsz·c floats on
    _build.check(fn(_build.ptr(rgb), _build.ptr(depth), _build.ptr(partial),
                    out_r, out_r + 4 * bsz * c,
                    _build.ptr(_counters(rgb.device, 2 * bsz, _SUMS_COUNTERS)),
                    bsz, hw, c, splits, width, _build.stream()),
                 "channel_sums")
    _build.count("channel_sums", rgb)
    return sums


# ----------------------------------------------------------------- SE MLP
class _LowpSigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` at bf16: the forward op by op, each step rounded
    as XLA computes it, the backward JAX's rule ``g · (s · (1 − s))``."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(−x))``: for bf16 rounded where XLA rounds
    ``jax.nn.sigmoid`` and its gradient (``torch.sigmoid`` rounds once);
    ``torch.sigmoid`` for wider dtypes."""
    if x.dtype == torch.bfloat16:
        return _LowpSigmoid.apply(x)
    return torch.sigmoid(x)


def se_scale(mean: torch.Tensor, w1, b1, w2, b2,
             act: Callable = torch.relu) -> torch.Tensor:
    """sigmoid(act(mean @ w1 + b1) @ w2 + b2) on (B, C); ``act`` is relu
    in the kernels (the TPU kernels' MLP), the net's activation in a swish
    or hswish cell. Computed in the dtype of the mean and the weights: fp32
    in eval, bf16 in a bf16 train step (the JAX module's roundings)."""
    return sigmoid(act(mean @ w1 + b1) @ w2 + b2)


def map_scale(x: torch.Tensor, w1, b1, w2, b2, dims=(1, 2),
              keepdim: bool = False, act: Callable = torch.relu
              ) -> torch.Tensor:
    """The SE scale of a map, in the map's dtype: the mean over ``dims``
    in at least fp32, rounded to the map's dtype, then the MLP (``se_scale``
    with ``act``) on the weights' dtype (fp32 in eval, the map's in a bf16
    train step), its output rounded to the map's dtype."""
    mean = wide(x).mean(dim=dims, keepdim=keepdim).to(x.dtype)
    mean = mean.to(torch.promote_types(mean.dtype, w1.dtype))
    return se_scale(mean, w1, b1, w2, b2, act).to(x.dtype)


def se_fuse_mixed_plain(rgb, depth, w_rgb, wr1, br1, wr2, br2,
                        wd1, bd1, wd2, bd2):
    s_r = map_scale(rgb, wr1, br1, wr2, br2)
    s_d = map_scale(depth, wd1, bd1, wd2, bd2)
    w = w_rgb[:, None].to(s_r.dtype)
    s_r = w + (1.0 - w) * s_r
    s_d = (1.0 - w) * s_d
    return rgb * s_r[:, None, None, :] + depth * s_d[:, None, None, :]


# blocks per SM the SE cell's grid aims at, and the fewest accesses (of the
# access width: 16 bytes, or 8 for a narrower bf16 map) of each map a block
# reads: more blocks per sample would add partial sums (2·C floats a block)
# that the sample's last block reads alone, at most MAX_PARTIALS floats
# below SE_SPLIT_C (from there the MLP launch adds them in parallel)
BLOCKS_PER_SM = 2
MIN_ITEMS = 2 * 256
MAX_PARTIALS = 32768
_SE_THREADS = 256  # csrc/se.cu's SE_THREADS
SE_MAX_C = 4 * _SE_THREADS * 2  # 4·SE_THREADS·SE_MAX_G: two float4s a thread
SE_SPLIT_C = 1024  # csrc/se.cu's SE_SPLIT_C: from here the MLPs' own launch
_SE_SLICE = 256  # csrc/se.cu's SE_SLICE
_SE_MLP_COUNTERS = 6  # csrc/se.cu's SE_MLP_COUNTERS

# channel_sums' grid: about SUMS_BLOCKS_PER_SM blocks per SM over the batch
# and both maps, each pixel lane of a block reading at least SUMS_UNROLL
# pixels, at most MAX_PARTIALS partial sums for the last block to add
SUMS_BLOCKS_PER_SM = 4
SUMS_UNROLL = 4  # csrc/se.cu's SUMS_UNROLL
_SUMS_THREADS = 256  # csrc/se.cu's SUMS_THREADS

# Tickets of the kernels' last-block finalizes, one buffer per device for
# the SE cell (_COUNTERS) and one for channel_sums (_SUMS_COUNTERS), so the
# two do not alias: zeroed once, grown with the batch; the kernels leave
# every counter at 0, so calls need no zeroing in between (and a CUDA graph
# can replay them). This assumes one stream at a time, as the port runs:
# launches in flight on two streams would share them.
_COUNTERS: dict[torch.device, torch.Tensor] = {}
_SUMS_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int, table: dict) -> torch.Tensor:
    buf = table.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 16), dtype=torch.int32, device=device)
        table[device] = buf
    return buf


def _access_width(c: int, maps) -> int:
    """Channels a thread moves in one access: the most, 16 bytes' worth
    down to one element, that C and every map's alignment allow."""
    esize = maps[0].element_size()
    n = 16 // esize
    while n > 1 and (c % n or any(t.data_ptr() % (n * esize) for t in maps)):
        n //= 2
    return n


def _sums_splits(bsz: int, hw: int, c: int, width: int, sms: int) -> int:
    """Blocks per (sample, map) of ``channel_sums``: SUMS_BLOCKS_PER_SM per
    SM over the batch and both maps, each pixel lane reading at least
    SUMS_UNROLL pixels, at most MAX_PARTIALS partial sums to add in the
    last block. Depends on the shape, the access width and the card only,
    so the summation order never depends on the data."""
    groups = c // width
    lanes = _SUMS_THREADS // groups if groups < _SUMS_THREADS else 1
    return max(1, min(math.ceil(SUMS_BLOCKS_PER_SM * sms / (2 * bsz)),
                      hw // (lanes * SUMS_UNROLL), MAX_PARTIALS // c))


def _se_splits(bsz: int, hw: int, c: int, sms: int, width: int = 4) -> int:
    """Blocks per sample of the SE cell's squeeze and mix: BLOCKS_PER_SM per
    SM over the batch, each reading at least MIN_ITEMS accesses of
    ``width`` channels of a map for every group a thread owns (one up to
    C = width·256, two above), at most one block per pixel and, below
    SE_SPLIT_C, at most MAX_PARTIALS partial sums for the sample's last
    block to add. Depends on the shape and the card only, so the summation
    order never depends on the data."""
    items = hw * (c // width)
    groups = -(-c // (width * _SE_THREADS))
    most = hw if c >= SE_SPLIT_C else min(hw, MAX_PARTIALS // (2 * c))
    return max(1, min(math.ceil(BLOCKS_PER_SM * sms / bsz),
                      items // (MIN_ITEMS * groups), most))


def _launch_se(x_r, x_d, w_rgb, wr, wd):
    """The SE launches: the squeeze (partial sums, then below C =
    SE_SPLIT_C the scales from the last block of each sample), from
    SE_SPLIT_C up the means and the MLPs of all samples in a launch of
    their own, and the mix."""
    bsz, c = x_r.shape[0], x_r.shape[-1]
    hw = x_r.numel() // (bsz * c)
    _build.require(x_r, "x", dtypes=_build.MAPS)
    if c % 4 or c > SE_MAX_C:
        raise ValueError(f"the SE cell takes C % 4 == 0 and C <= {SE_MAX_C}, "
                         f"got {c}")
    cr = wr[0].shape[-1]
    if not 1 <= cr <= _SE_THREADS:
        raise ValueError(f"the SE cell takes 1 <= C/r <= {_SE_THREADS}, "
                         f"got {cr}")
    shapes = ((c, cr), (cr,), (cr, c), (c,))
    for i, (a, shape) in enumerate(zip(wr, shapes)):
        _build.require(a, f"rgb SE weight {i}", shape)
    if x_d is not None:
        _build.require(x_d, "depth", tuple(x_r.shape), dtypes=(x_r.dtype,))
        for i, (a, shape) in enumerate(zip(wd, shapes)):
            _build.require(a, f"depth SE weight {i}", shape)
    if w_rgb is not None:
        _build.require(w_rgb, "w_rgb", (bsz,))
    # four channels in one access at least: 16 bytes in fp32, 8 in bf16
    width = _access_width(c, [t for t in (x_r, x_d) if t is not None])
    if width < 4:
        raise ValueError(f"the SE cell takes {4 * x_r.element_size()}-byte "
                         "aligned maps")
    splits = _se_splits(bsz, hw, c, _build.sm_count(x_r), width)
    # one fp32 scratch buffer: the partial sums, the scales, and from
    # SE_SPLIT_C up the means and the MLPs' layer-1 sums (pointers into it,
    # not views: a view costs the host more than the offset)
    sizes = [bsz * splits * 2 * c, bsz * 2 * c]
    if c >= SE_SPLIT_C:
        sizes += [bsz * 2 * c, -(-c // _SE_SLICE) * bsz * 2 * cr]
    scratch = torch.empty(sum(sizes), device=x_r.device, dtype=torch.float32)
    parts, at = [None] * 4, scratch.data_ptr()
    for i, size in enumerate(sizes):
        parts[i], at = at, at + 4 * size
    out = torch.empty_like(x_r)
    fn = _build.function("se", _build.symbol("dynmm_se_fuse", x_r), 17, 6)
    counters = _counters(x_r.device, max(bsz, _SE_MLP_COUNTERS),
                         _COUNTERS)
    _build.check(fn(_build.ptr(x_r), _build.ptr(x_d), *map(_build.ptr, wr),
                    *(map(_build.ptr, wd) if wd else [None] * 4),
                    _build.ptr(w_rgb), *parts,
                    _build.ptr(counters), _build.ptr(out),
                    bsz, hw, c, cr, splits, width, _build.stream()),
                 "se_fuse")
    return out


def se_fuse_mixed(rgb, depth, w_rgb, wr1, br1, wr2, br2, wd1, bd1, wd2, bd2):
    """Gate-mixed SE-add fusion of two (B, H, W, C) fp32 or bf16 maps;
    ``w_rgb`` (B,) is the weight on the unfused rgb branch. Two launches on
    the card below C = SE_SPLIT_C: the squeeze, whose last block per sample
    computes both scale vectors once, and the mix; from SE_SPLIT_C up a
    third between them runs the MLPs of every sample."""
    args = (rgb, depth, w_rgb, wr1, br1, wr2, br2, wd1, bd1, wd2, bd2)
    if torch.compiler.is_exporting():
        return torch.ops.dynmm.se_fuse_mixed(*args)
    if not _build.on_card(*args):
        return se_fuse_mixed_plain(*args)
    return launch_se_fuse_mixed(*args)


def launch_se_fuse_mixed(rgb, depth, w_rgb, wr1, br1, wr2, br2, wd1, bd1,
                         wd2, bd2):
    """``se_fuse_mixed`` on the card: the checks and the launches."""
    out = _launch_se(rgb, depth, w_rgb.float().contiguous(),
                     (wr1, br1, wr2, br2), (wd1, bd1, wd2, bd2))
    _build.count("se_fuse_mixed", rgb)
    return out


# ------------------------------------------------------------ single map
def se_reference(x, w1, b1, w2, b2):
    """Plain SE over (..., HW, C): x · sigmoid(relu(mean @ w1 + b1) @ w2 + b2),
    the scale rounded as ``map_scale`` rounds it."""
    return x * map_scale(x, w1, b1, w2, b2, dims=(-2,), keepdim=True)


def fused_se(x, w1, b1, w2, b2):
    """Single-map SE with the JAX signature: x (HW, C) or (B, HW, C); on
    the card the same launches as ``se_fuse_mixed`` with w = 0."""
    if x.dim() == 2:
        return fused_se(x[None], w1, b1, w2, b2)[0]
    if torch.compiler.is_exporting():
        return torch.ops.dynmm.fused_se(x, w1, b1, w2, b2)
    if not _build.on_card(x, w1, b1, w2, b2):
        return se_reference(x, w1, b1, w2, b2)
    return launch_fused_se(x, w1, b1, w2, b2)


def launch_fused_se(x, w1, b1, w2, b2):
    """``fused_se`` of a (B, HW, C) map on the card: the checks and the
    launches."""
    out = _launch_se(x, None, None, (w1, b1, w2, b2), None)
    _build.count("fused_se", x)
    return out
