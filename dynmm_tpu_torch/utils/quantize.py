"""Post-training int8 calibration of a model's quantized convs (port of
``dynmm_tpu/utils/quantize.py``; the convs are ``nn/layers.py::Conv2d``
with a ``quant`` mode, ``nn/quant.py``).

    model = SkipGateESANet(dataclasses.replace(cfg, quant="int8"))
    quantize_int8(model, [(rgb, depth), ...], "percentile", 99.9, hard=True)

is eval.py's and predict.py's ``--quant int8`` step, in three parts:

    calibrate(model, [(rgb, depth), ...], hard=True)   # fp32, dense forward
    select_scales(model, "percentile", 99.9)           # or keep "absmax"
    pack_int8(model)                                   # int8 weights, once

Where the JAX functions take and return the flax ``quant`` collection, these
work on the model's own buffers in place (``utils/weights.py`` carries them
to and from that collection). ``calibrate`` runs the dense forward with
every quantized conv in ``"calib"`` mode and the model in fp32 whatever its
compute dtype (the JAX ``quant='calib', dtype=None`` twin), so the scales
cover every routed path; it starts from the scales the model holds
(resumable, running maxima). Afterwards the convs are back in ``"int8"``
and the model in its compute dtype.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Sequence

import torch
import torch.nn as nn

from dynmm_tpu_torch.nn.layers import Conv2d, Packed, set_compute_dtype
from dynmm_tpu_torch.nn.quant import CALIB_PERCENTILES, quantize_weight


def quant_convs(model: nn.Module) -> list[tuple[str, Conv2d]]:
    """(name, conv) of every quantized conv of ``model``, in module order."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, Conv2d) and m.quant is not None]


def _compute_dtype(model: nn.Module):
    return next((m.compute_dtype for m in model.modules()
                 if isinstance(m, (Conv2d, Packed))), None)


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """Every quantized conv of ``model`` in ``"calib"`` mode and the model
    in eval and fp32 for the block; ``"int8"``, its compute dtype and its
    train/eval mode after."""
    convs = [m for _, m in quant_convs(model)]
    if not convs:
        raise ValueError("calibrate needs a model built with quant "
                         "(ESANetConfig(quant='int8'))")
    dtype, training = _compute_dtype(model), model.training
    for m in convs:
        m.quant = "calib"
    set_compute_dtype(model, None)
    model.eval()
    try:
        yield model
    finally:
        for m in convs:
            m.quant = "int8"
        set_compute_dtype(model, dtype)
        model.train(training)


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[Sequence], **kwargs) -> int:
    """Raise each quantized conv's ``in_scale`` (abs-max over 127) and
    ``in_pct`` (the ``CALIB_PERCENTILES`` grid over 127) to the running
    maxima over ``batches``, positional input tuples preprocessed exactly
    like the serving inputs, through the dense forward with ``kwargs``.
    Returns the number of batches."""
    n = 0
    with calibrating(model):
        for inputs in batches:
            model(*inputs, **kwargs)
            n += 1
    if not n:
        raise ValueError("calibrate() needs at least one batch")
    return n


@torch.no_grad()
def select_scales(model: nn.Module, estimator: str = "absmax",
                  percentile: float = 99.9) -> nn.Module:
    """Resolve the calibration estimator into ``in_scale``: ``absmax``
    keeps it; ``percentile`` sets every conv's ``in_scale`` to
    ``max(in_pct[i], 1e-12)``, i the index of ``percentile`` in
    ``CALIB_PERCENTILES``. Returns ``model``."""
    if estimator == "absmax":
        return model
    if estimator != "percentile":
        raise ValueError(f"unknown calib estimator {estimator!r}")
    if percentile not in CALIB_PERCENTILES:
        raise ValueError(
            f"--calib_percentile must be one of {CALIB_PERCENTILES} "
            f"(got {percentile}); the grid is recorded during calibration")
    idx = CALIB_PERCENTILES.index(percentile)
    for _, m in quant_convs(model):
        m.in_scale.copy_(torch.clamp_min(m.in_pct[idx], 1e-12))
    return model


@torch.no_grad()
def pack_int8(model: nn.Module) -> nn.Module:
    """Quantize every quantized conv's weight once (``Conv2d.pack``: the
    int8 GEMM matrix with its per-output-channel ``w_scale``) where it is
    not packed yet (idempotent): the int8 forward then reads the int8
    weight instead of quantizing the float one each call, bit-identical.
    Returns ``model``."""
    convs = quant_convs(model)
    if not convs:
        raise ValueError("pack_int8 needs a model with quantized convs")
    for _, m in convs:
        if m.w_mat is None:
            m.pack(*quantize_weight(m.weight))
    return model


def quant_sanity(model: nn.Module) -> int:
    """The number of quantized convs with a positive ``in_scale``; 0 means
    calibration never reached a quantized conv."""
    return sum(int(m.in_scale.item() > 0.0) for _, m in quant_convs(model))


def quantize_int8(model: nn.Module, batches: Iterable[Sequence],
                  estimator: str = "absmax", percentile: float = 99.9,
                  **kwargs) -> int:
    """``--quant int8``: ``calibrate`` over ``batches`` with ``kwargs``,
    ``select_scales(estimator, percentile)``, then ``pack_int8``. Returns
    ``quant_sanity``."""
    calibrate(model, batches, **kwargs)
    select_scales(model, estimator, percentile)
    pack_int8(model)
    return quant_sanity(model)
