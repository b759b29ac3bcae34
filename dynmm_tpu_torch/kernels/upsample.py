"""Learned ×2 upsample kernel (``csrc/upsample.cu``).

Port of ``dynmm_tpu/kernels/upsample.py::fused_learned_upsample``: nearest
×2 then a zero-padded depthwise 3×3 conv plus bias ('learned-3x3-zeropad'),
computed as four 2×2 polyphase stencils over the source so the 4× nearest
intermediate is never written. Covers all five upsample sites of the main
path, the 40-channel logits maps included: a thread owns 4 channels of one
output column and slides its window of source cells down a strip of source
rows (see ``csrc/upsample.cu``).

The bf16 form takes a bf16 map with bf16 taps and bias (the bf16-cast
parameters that the JAX model and the Pallas function both see; the Pallas
function takes taps of the map's dtype only). It sums taps and products in
fp32 and rounds each output once, at the store: closer to the JAX model's
XLA depthwise conv, which accumulates in fp32, than to the Pallas
function's op-by-op bf16 arithmetic (up to ~1e-2 of max |out| apart).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dynmm_tpu_torch.kernels import _build
from dynmm_tpu_torch.kernels.se import wide


def learned_upsample_plain(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 then depthwise 3×3 with padding 1. x (N, H, W, C),
    kernel (3, 3, C), bias (C,). Computes in at least fp32 and rounds the
    output once to x's dtype, as the kernel does."""
    c = x.shape[-1]
    up = wide(x).permute(0, 3, 1, 2).repeat_interleave(2, dim=2)
    up = up.repeat_interleave(2, dim=3)
    w = wide(kernel).permute(2, 0, 1).unsqueeze(1)  # (C, 1, 3, 3)
    out = F.conv2d(up, w.to(up.dtype), wide(bias).to(up.dtype), padding=1,
                   groups=c)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def learned_upsample(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """x (H, W, C) or (N, H, W, C); kernel (3, 3, C); bias (C,), all fp32
    or all bf16 → (..., 2H, 2W, C) of x's dtype."""
    if x.dim() == 3:
        return learned_upsample(x[None], kernel, bias)[0]
    if torch.compiler.is_exporting():
        return torch.ops.dynmm.learned_upsample(x, kernel, bias)
    if not _build.on_card(x, kernel, bias):
        return learned_upsample_plain(x, kernel, bias)
    return launch_learned_upsample(x, kernel, bias)


def launch_learned_upsample(x: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """``learned_upsample`` of an (N, H, W, C) map on the card: the checks
    and the launch."""
    n, h, w, c = x.shape
    _build.require(x, "x", dtypes=_build.MAPS)
    _build.require(kernel, "kernel", (3, 3, c), dtypes=(x.dtype,))
    _build.require(bias, "bias", (c,), dtypes=(x.dtype,))
    if 4 * h * w * c >= 2 ** 31:
        raise ValueError("learned_upsample indexes a sample in 32 bits: "
                         f"4·H·W·C = {4 * h * w * c} elements is too many")
    out = torch.empty((n, 2 * h, 2 * w, c), device=x.device, dtype=x.dtype)
    fn = _build.function("upsample",
                         _build.symbol("dynmm_learned_upsample", x), 4, 5)
    _build.check(fn(_build.ptr(x), _build.ptr(kernel), _build.ptr(bias),
                    _build.ptr(out), n, h, w, c, _build.sm_count(x),
                    _build.stream()),
                 "learned_upsample")
    _build.count("learned_upsample", x)
    return out
