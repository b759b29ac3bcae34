"""Post-training int8 quantization of the serving path (port of
``dynmm_tpu/nn/quant.py``).

Symmetric, zero-point-free, consumer-side activation quantization:

* weights: per-output-channel scales ``max|w| / 127`` (``weight_scales``),
  ``w_q = round(w / s_w)`` clipped to ±127 (``quantize_symmetric``);
* activations: one calibrated scale a conv input, ``x_q = round(x / s_in)``;
* ``conv_int8``: the int8 conv with exact int32 sums, then
  ``y = acc · (s_in · s_w) + bias`` in fp32, cast to the map's dtype.

Between convs everything stays float (BN, activations, SE cells, residual
adds). The conv itself is an int8 im2col of ``x_q`` (NHWC, taps in
(kh, kw, c) order) times the (K, C_out) weight matrix (``int_mm``):
``torch._int_mm`` (cuBLASLt) on the card, and on the CPU a float64 GEMM of
the int8 values, since oneDNN's ``_int_mm`` saturates its pair sums under
AVX2; both exact. An fp32 conv of the integer values would not be: the
decoder's 3×3 over 512 channels sums 4608 products up to 127² (7.4e7),
beyond fp32's exact integers (2^24). ``_int_mm`` takes M > 16 rows and K, N multiples of
8 on the card; ``conv_int8`` pads the im2col with zero columns and rows and
the weight matrix with zero rows, which leaves the int32 sums unchanged, on
every device alike.

The port's ``nn/layers.py::Conv2d`` is the ``QConv``: its ``quant`` is None
(float), ``"calib"`` (the float conv, plus running maxima of ``|x|/127``
into ``in_scale`` and of the ``CALIB_PERCENTILES`` quantiles of ``|x|``,
over 127, into ``in_pct``) or ``"int8"``. The quant buffers (``in_scale``,
``in_pct``, the packed ``w_mat`` with ``w_scale``) are non-persistent: the
state_dict is the float model's, as the flax ``params`` are;
``utils/weights.py`` carries them as the flax ``quant`` collection.
``INT8_CONVS`` counts the int8 convs run, by device type; a program that
``torch.export`` traced counts none (its int8 convs are its
``aten._int_mm`` nodes, on the CPU its float64 ``aten.mm`` ones).
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

QUANT_MODES = (None, "calib", "int8")
# the percentile grid recorded during calibration (utils.quantize
# select_scales swaps one of them into in_scale)
CALIB_PERCENTILES = (99.0, 99.9, 99.99)
# torch._int_mm's shape rules on the card: M > 16, K and N multiples of 8
MIN_ROWS = 17
ALIGN = 8

INT8_CONVS: collections.Counter = collections.Counter()


def weight_scales(weight: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-output-channel symmetric scales of an OIHW kernel: (C_out,)."""
    s = weight.float().abs().amax(dim=(1, 2, 3)) / 127.0
    return torch.clamp_min(s, eps)


def quantize_symmetric(x: torch.Tensor, scale) -> torch.Tensor:
    """round(x / scale) clipped to ±127 as int8 (round half to even, as
    ``jnp.round``; a division, not a product with the reciprocal)."""
    q = torch.round(x.float() / scale)
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def quantize_weight(weight: torch.Tensor):
    """(w_q OIHW int8, s_w (C_out,)) of a float OIHW kernel."""
    s_w = weight_scales(weight)
    return quantize_symmetric(weight, s_w[:, None, None, None]), s_w


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def gemm_weight(w_q: torch.Tensor) -> torch.Tensor:
    """The (N, K) int8 matrix of an OIHW int8 kernel, K in im2col's
    (kh, kw, c) order, zero-padded to multiples of 8 on both axes
    (``_int_mm`` takes its transpose)."""
    o, c, kh, kw = w_q.shape
    w = w_q.permute(0, 2, 3, 1).reshape(o, kh * kw * c)
    k = kh * kw * c
    return F.pad(w, (0, _ceil(k, ALIGN) - k, 0, _ceil(o, ALIGN) - o)
                 ).contiguous()


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def im2col(x_q: torch.Tensor, kernel_size, stride=1, padding=0,
           dilation=1) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(A, (B, Ho, Wo)): the (B·Ho·Wo, K_pad) int8 im2col of an NHWC map,
    rows in (b, ho, wo) order, columns the (kh, kw, c) taps then zeros up
    to a multiple of 8. A 1×1 stride-1 conv of C % 8 == 0 is a view."""
    (kh, kw), (sh, sw) = _pair(kernel_size), _pair(stride)
    (ph, pw), (dh, dw) = _pair(padding), _pair(dilation)
    if ph or pw:
        x_q = F.pad(x_q, (0, 0, pw, pw, ph, ph))
    b, hp, wp, c = x_q.shape
    ho = (hp - dh * (kh - 1) - 1) // sh + 1
    wo = (wp - dw * (kw - 1) - 1) // sw + 1
    cols = [x_q[:, i * dh:i * dh + sh * (ho - 1) + 1:sh,
                j * dw:j * dw + sw * (wo - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    k = kh * kw * c
    if _ceil(k, ALIGN) != k:
        cols.append(x_q.new_zeros((b, ho, wo, _ceil(k, ALIGN) - k)))
    a = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return a.reshape(b * ho * wo, -1), (b, ho, wo)


def int_mm(a: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """(M, N_pad) int32 = a (M, K_pad) int8 · w_matᵀ, w_mat (N_pad, K_pad)
    int8. On the card ``_int_mm``, with M padded to ``MIN_ROWS`` by zero
    rows; on the CPU a float64 GEMM of the int8 values, exact since every
    partial sum is an integer below K·127² < 2^53 (oneDNN's ``_int_mm``
    saturates under AVX2)."""
    if a.device.type == "cpu":
        return torch.mm(a.double(), w_mat.double().t()).to(torch.int32)
    m = a.shape[0]
    if m < MIN_ROWS:
        a = F.pad(a, (0, 0, 0, MIN_ROWS - m))
    return torch._int_mm(a, w_mat.t())[:m]


def conv_int8_gemm(x_q: torch.Tensor, w_mat: torch.Tensor, n: int,
                   kernel_size, stride=1, padding=0, dilation=1):
    """(acc (B·Ho·Wo, n) int32, (B, Ho, Wo)) of an NHWC int8 map and a
    ``gemm_weight`` matrix of ``n`` output channels; counts one int8 conv."""
    a, shape = im2col(x_q, kernel_size, stride, padding, dilation)
    if not torch.compiler.is_exporting():  # an exported graph holds no count
        INT8_CONVS[x_q.device.type] += 1
    return int_mm(a, w_mat)[:, :n], shape


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, stride=1, padding=0,
              dilation=1) -> torch.Tensor:
    """The int32 conv of an int8 NCHW map and an int8 OIHW kernel (torch's
    symmetric ``padding``), exact: NCHW in channels_last memory."""
    acc, (b, ho, wo) = conv_int8_gemm(
        x_q.permute(0, 2, 3, 1).contiguous(), gemm_weight(w_q),
        w_q.shape[0], w_q.shape[2:], stride, padding, dilation)
    return acc.reshape(b, ho, wo, -1).permute(0, 3, 1, 2)


def quantile_linear(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (method 'linear') of a flat fp32 tensor, in
    its fp32 arithmetic: index ``q·(n − 1)`` in fp32, the sorted values at
    its floor and ceiling weighted ``1 − f`` and ``f``. Through ``sort``:
    ``torch.quantile`` refuses more than 2^24 elements."""
    n = x.numel()
    pos = q * (torch.tensor(float(n), dtype=torch.float32) - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    low = low.clamp(0, n - 1).long().to(x.device)
    high = high.clamp(0, n - 1).long().to(x.device)
    s = torch.sort(x).values
    return s[low] * w_low.to(x.device) + s[high] * w_high.to(x.device)


def observe(in_scale: torch.Tensor, in_pct: torch.Tensor,
            x: torch.Tensor) -> None:
    """Calibration: raise ``in_scale`` to ``max|x| / 127`` and ``in_pct``
    to the ``CALIB_PERCENTILES`` quantiles of ``|x|`` over 127, in place
    (running maxima over batches)."""
    ax = x.detach().float().abs().reshape(-1)
    torch.maximum(in_scale, ax.max() / 127.0, out=in_scale)
    q = torch.tensor(CALIB_PERCENTILES, dtype=torch.float32) / 100.0
    torch.maximum(in_pct, quantile_linear(ax, q) / 127.0, out=in_pct)
