"""FLOP counting (port of ``dynmm_tpu/utils/flops.py``; the reference's
``thop.profile`` scripts ``ModalityDynMM/multimedia/count_flop.py`` and
``affect/count_flop.py``).

``count_flops`` runs a callable once under ``torch.utils.flop_counter.
FlopCounterMode`` (no autograd) and returns the FLOPs it counted;
``count_macs`` halves them (1 MAC = 2 FLOPs), thop's convention, which the
reference's tables use.

What the count covers: products and convolutions (``mm``, ``addmm``,
``bmm``, ``einsum`` through them, ``convolution``) at 2 FLOPs a multiply-add,
plus the elementwise arithmetic and reductions of ``ELEMENTWISE`` at XLA's
rule of 1 FLOP an element (bias adds, relu, residual adds, masking, the
softmax's max, shift, sum and division, layer and batch norm's arithmetic).
Like XLA's cost analysis, which the JAX package reads, it counts no
transcendental (exp, log, tanh, sin, rsqrt) and no data movement. It
counts each op's arithmetic at a lower bound of XLA's (the layer norm at
7 FLOPs an element where XLA counts 7.5, the softmax at 4 where XLA counts
4.5), so it reads at most XLA's: on the routers at B=1 (CPU) the MM-IMDB
text, image and gate figures equal the JAX script's (0.69096, 4.99432,
0.56308 M-MACs) and the late fusion reads 10.29608 against 10.31091; the
CMU-MOSEI text and fusion branches 29.86057 and 66.05816 against 29.88506
and 66.12421, its gate 0.59636 against 0.61083 (2.4 % low: a 10-wide
transformer, whose masking and normalisation XLA counts at more ops an
element). Products alone read 0.02-12.5 % low. The CLIs
(``cli/imdb_count_flop.py``, ``cli/affect_count_flop.py``) count one
branch at a time: a forward that computes every branch and then selects
one counts them all, where XLA removes the dead branch.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def _elements(*args, out_shape=None, **kwargs) -> int:
    return _numel(out_shape)


def _reduction(x, *args, out_shape=None, **kwargs) -> int:
    return _numel(x) - _numel(out_shape)


def _mean(x, *args, out_shape=None, **kwargs) -> int:
    return _numel(x)  # the sum, then one division an output


def _addmm(bias, a, b, *args, out_shape=None, **kwargs) -> int:
    return 2 * a[0] * a[1] * b[1] + a[0] * b[1]


def _softmax(x, dim, *args, out_shape=None, **kwargs) -> int:
    n = _numel(x)
    rows = n // x[dim]
    return 4 * n - 2 * rows  # max, x − max, sum, division (exp is not one)


def _layer_norm(x, shape, weight=None, bias=None, *args, out_shape=None,
                **kwargs) -> int:
    # x², the two means, x − mean, · rsqrt(var + eps) [, · scale, + bias]
    return (7 if weight is not None else 5) * _numel(x)


def _batch_norm(x, weight=None, bias=None, *args, out_shape=None,
                **kwargs) -> int:
    # eval: (x − mean) · (rsqrt(var + eps) [· scale]) [+ bias]
    return (3 if weight is not None else 2) * _numel(x)


# XLA's cost analysis counts 1 FLOP an element for elementwise arithmetic
# and reductions, and none for transcendentals (exp, log, tanh, sin, rsqrt)
# or data movement; these are the ops of the modality routers' forwards.
ELEMENTWISE = {
    **{op: _elements for op in (aten.add, aten.sub, aten.mul, aten.div,
                                aten.relu, aten.clamp, aten.maximum,
                                aten.minimum, aten.neg,
                                aten.masked_fill)},
    **{op: _reduction for op in (aten.amax, aten.amin, aten.sum)},
    aten.mean: _mean,
    aten.addmm: _addmm,
    aten._softmax: _softmax,
    aten.native_layer_norm: _layer_norm,
    aten.native_batch_norm: _batch_norm,
}


def count_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn(*args, **kwargs)``: products,
    convolutions, and the elementwise arithmetic and reductions of
    ``ELEMENTWISE``."""
    with torch.no_grad(), FlopCounterMode(
            display=False, custom_mapping=ELEMENTWISE) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def count_macs(fn: Callable, *args, **kwargs) -> float:
    """thop-convention multiply-accumulates (= FLOPs / 2)."""
    return count_flops(fn, *args, **kwargs) / 2.0


def count_params(module: torch.nn.Module) -> int:
    """The number of parameter entries (the flax ``params`` collection's
    size; buffers such as BN statistics do not count)."""
    return sum(p.numel() for p in module.parameters())
