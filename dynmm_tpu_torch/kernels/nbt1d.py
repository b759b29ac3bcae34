"""NonBottleneck1D conv-pair kernel (``csrc/nbt1d.cu``).

Port of ``dynmm_tpu/kernels/nbt1d.py::fused_nbt1d_twopass``: a stride-1
NonBottleneck1D block in eval is two conv pairs,

    pair 1: h   = relu((1×3(relu(3×1(x) + b1)) + b2)·s1 + t1)
    pair 2: out = relu((1×3(relu(3×1(h) + b3)) + b4)·s2 + t2 + x)

each one launch. Taps are packed (3, C_in, C_out) — ``w[d]`` is the tap at
row (3×1) or column (1×3) offset d−1 — and BN is folded into the affine
(s, t) with eps 1e-3 (``fold_bn``). Both conversions happen once, when the
weights are loaded. Maps are NHWC fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dynmm_tpu_torch.kernels import _build


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


def nbt1d_pair(x: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
               wc: torch.Tensor, bc: torch.Tensor, s: torch.Tensor,
               t: torch.Tensor, identity: torch.Tensor | None = None
               ) -> torch.Tensor:
    """One conv pair on x (N, H, W, C): 3×1 + br → relu → 1×3 + bc →
    ·s + t [+ identity] → relu."""
    if not _build.on_card(x, wr, br, wc, bc, s, t, identity):
        return nbt1d_pair_plain(x, wr, br, wc, bc, s, t, identity)
    n, h, w, c = x.shape
    _build.require(x, "x")
    for name, a in (("wr", wr), ("wc", wc)):
        _build.require(a, name, (3, c, c))
    for name, a in (("br", br), ("bc", bc), ("s", s), ("t", t)):
        _build.require(a, name, (c,))
    if identity is not None:
        _build.require(identity, "identity", (n, h, w, c))
    out = torch.empty_like(x)
    fn = _build.function("nbt1d", "dynmm_nbt1d_pair", 9, 4)
    _build.check(fn(_build.ptr(x), _build.ptr(identity), _build.ptr(wr),
                    _build.ptr(br), _build.ptr(wc), _build.ptr(bc),
                    _build.ptr(s), _build.ptr(t), _build.ptr(out),
                    n, h, w, c, _build.stream()), "nbt1d_pair")
    _build.LAUNCHES["nbt1d_pair"] += 1
    return out


def nbt1d_block(x, w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2,
                use_kernels: bool = True):
    """Stride-1 NonBottleneck1D block (JAX ``fused_nbt1d_twopass``
    signature) as two pairs. ``use_kernels=False`` runs the plain versions
    wherever the tensors lie."""
    pair = nbt1d_pair if use_kernels else nbt1d_pair_plain
    h = pair(x, w1, b1, w2, b2, s1, t1)
    return pair(h, w3, b3, w4, b4, s2, t2, identity=x)
