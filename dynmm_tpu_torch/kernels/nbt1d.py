"""NonBottleneck1D block kernels (``csrc/nbt1d_block.cu``, ``csrc/nbt1d.cu``).

A stride-1 NonBottleneck1D block in eval is two conv pairs,

    pair 1: h   = relu((1×3(relu(3×1(x) + b1)) + b2)·s1 + t1)
    pair 2: out = relu((1×3(relu(3×1(h) + b3)) + b4)·s2 + t2 + x)

``nbt1d_fused`` (port of ``dynmm_tpu/kernels/nbt1d.py::fused_nbt1d``) runs
the whole block in one launch, its intermediates kept in shared memory;
``nbt1d_pair`` (port of ``fused_nbt1d_twopass``'s ``_run_pair``) runs one
pair per launch. ``nbt1d_block`` picks between them by channel count. Taps
are packed (3, C_in, C_out) — ``w[d]`` is the tap at row (3×1) or column
(1×3) offset d−1 — and BN is folded into the affine (s, t) with eps 1e-3
(``fold_bn``). Both conversions happen once, when the weights are loaded.
Maps are NHWC fp32. There is no bf16 form: the TPU kernels have none (their
fp32 stores into a bf16 output fail, ``dynmm_tpu/kernels/nbt1d.py:103``,
``:210``), so a bf16 map on the card raises and a bf16 block runs its
unfused convs (``models/resnet.py``), as the JAX model's bf16 block does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dynmm_tpu_torch.kernels import _build

# Widest block ``nbt1d_block`` sends to the one-launch kernel, set by speed
# (``bench_nbt1d.py``, ``chip_smoke.py``; NVIDIA H100 80GB HBM3, 700.00 W).
# The kernel runs at every C (its tiles shrink to fit shared memory), on the
# tensor cores as the pair does, but it computes each tile's halo pixels
# twice: 52 items of 32 pixels × 32 channels for 40 useful ones at C = 64,
# and more at wider levels, where tiles are smaller. At B=8 it took
# 1.7-1.8×, 2.0×, 6.6-6.8× and 8.3-8.4× the time of two ``nbt1d_pair`` calls
# at C = 64, 128, 256 and 512, and 1.2-1.3× at C = 64, B=1. So no level is
# faster on it; C = 64 (6 of the flagship's 35 stride-1 blocks) stays on it,
# its one served level, and the wider blocks take two pair calls.
NBT1D_FUSED_MAX_C = 64


def fold_bn(scale, bias, mean, var, eps: float = 1e-3):
    """BN running stats → per-channel affine (s, t): y = x·s + t."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


def nbt1d_pair_plain(x, wr, br, wc, bc, s, t, identity=None):
    xn = x.permute(0, 3, 1, 2)
    w_row = wr.permute(2, 1, 0).unsqueeze(-1)  # (C_out, C_in, 3, 1)
    w_col = wc.permute(2, 1, 0).unsqueeze(-2)  # (C_out, C_in, 1, 3)
    h = torch.relu(F.conv2d(xn, w_row, br, padding=(1, 0)))
    h = F.conv2d(h, w_col, bc, padding=(0, 1)).permute(0, 2, 3, 1)
    h = h * s + t
    if identity is not None:
        h = h + identity
    return torch.relu(h)


def _require_fp32(x: torch.Tensor, name: str) -> None:
    if x.dtype == torch.bfloat16:
        raise TypeError(f"{name}: the TPU kernel has no bf16 form; a bf16 "
                        "NonBottleneck1D block runs its unfused convs")


def nbt1d_pair(x: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
               wc: torch.Tensor, bc: torch.Tensor, s: torch.Tensor,
               t: torch.Tensor, identity: torch.Tensor | None = None
               ) -> torch.Tensor:
    """One conv pair on x (N, H, W, C): 3×1 + br → relu → 1×3 + bc →
    ·s + t [+ identity] → relu.

    On the card one call is two launches of one implicit-GEMM conv kernel
    (3×1 into a scratch h, then 1×3), in 3xTF32 on the tensor cores; it
    counts as one ``nbt1d_pair`` launch."""
    args = (x, wr, br, wc, bc, s, t, identity)
    if torch.compiler.is_exporting():
        return torch.ops.dynmm.nbt1d_pair(*args)
    if not _build.on_card(*args):
        return nbt1d_pair_plain(*args)
    return launch_nbt1d_pair(*args)


def launch_nbt1d_pair(x, wr, br, wc, bc, s, t, identity=None):
    """``nbt1d_pair`` on the card: the checks, the scratch map and the two
    launches."""
    n, h, w, c = x.shape
    _require_fp32(x, "nbt1d_pair")
    _build.require(x, "x")
    for name, a in (("wr", wr), ("wc", wc)):
        _build.require(a, name, (3, c, c))
    for name, a in (("br", br), ("bc", bc), ("s", s), ("t", t)):
        _build.require(a, name, (c,))
    if identity is not None:
        _build.require(identity, "identity", (n, h, w, c))
    scratch, out = torch.empty_like(x), torch.empty_like(x)
    fn = _build.function("nbt1d", "dynmm_nbt1d_pair", 10, 4)
    _build.check(fn(_build.ptr(x), _build.ptr(identity), _build.ptr(wr),
                    _build.ptr(br), _build.ptr(wc), _build.ptr(bc),
                    _build.ptr(s), _build.ptr(t), _build.ptr(scratch),
                    _build.ptr(out), n, h, w, c, _build.stream()),
                 "nbt1d_pair")
    _build.LAUNCHES["nbt1d_pair"] += 1
    return out


def nbt1d_fused_plain(x, w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2):
    """The whole block in PyTorch convs (JAX ``reference_nbt1d``)."""
    h = nbt1d_pair_plain(x, w1, b1, w2, b2, s1, t1)
    return nbt1d_pair_plain(h, w3, b3, w4, b4, s2, t2, identity=x)


def nbt1d_fused(x: torch.Tensor, w1, b1, w2, b2, s1, t1, w3, b3, w4, b4,
                s2, t2, band_rows: int = 0) -> torch.Tensor:
    """Whole stride-1 block on x (N, H, W, C) or (H, W, C) in one launch
    (JAX ``fused_nbt1d`` signature), in 3xTF32 on the tensor cores.
    ``band_rows``: output rows of a thread block's tile; 0 lets the kernel
    pick them. A tile that does not fit in shared memory raises."""
    params = (w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2)
    if x.dim() == 3:
        return nbt1d_fused(x[None], *params, band_rows=band_rows)[0]
    if torch.compiler.is_exporting():
        return torch.ops.dynmm.nbt1d_fused(x, *params, band_rows)
    if not _build.on_card(x, *params):
        return nbt1d_fused_plain(x, *params)
    return launch_nbt1d_fused(x, *params, band_rows)


def launch_nbt1d_fused(x, w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2,
                       band_rows: int = 0) -> torch.Tensor:
    """``nbt1d_fused`` of an (N, H, W, C) map on the card: the checks and
    the launch."""
    params = (w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2)
    n, h, w, c = x.shape
    _require_fp32(x, "nbt1d_fused")
    _build.require(x, "x")
    for i, a in enumerate(params):
        _build.require(a, f"block parameter {i}",
                       (3, c, c) if i in (0, 2, 6, 8) else (c,))
    out = torch.empty_like(x)
    fn = _build.function("nbt1d_block", "dynmm_nbt1d_block", 14, 5)
    _build.check(fn(_build.ptr(x), *map(_build.ptr, params), _build.ptr(out),
                    n, h, w, c, band_rows, _build.stream()), "nbt1d_fused")
    _build.LAUNCHES["nbt1d_fused"] += 1
    return out


def nbt1d_block(x, w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2,
                use_kernels: bool = True):
    """Stride-1 NonBottleneck1D block on x (N, H, W, C): one
    ``nbt1d_fused`` launch up to ``NBT1D_FUSED_MAX_C`` channels, two
    ``nbt1d_pair`` launches above. ``use_kernels=False`` runs the plain
    versions wherever the tensors lie."""
    if x.shape[-1] <= NBT1D_FUSED_MAX_C:
        block = nbt1d_fused if use_kernels else nbt1d_fused_plain
        return block(x, w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2)
    pair = nbt1d_pair if use_kernels else nbt1d_pair_plain
    h = pair(x, w1, b1, w2, b2, s1, t1)
    return pair(h, w3, b3, w4, b4, s2, t2, identity=x)
