"""Weight initialisation from an explicit ``torch.Generator``.

``apply_he_init`` is ``--he_init`` (port of
``dynmm_tpu/utils/init.py::apply_he_init``; the reference's
``build_model.py:152-178``). ``flax_default_init`` draws the modality-level
models' parameters as flax initialises them (the JAX package's routers and
experts are built with flax's defaults): dense layers, the GRU cells'
orthogonal hidden kernels and the fusions' raw parameters.

Kaiming-normal (fan-out, relu) re-draw of conv kernels, except the SE
blocks (sigmoid-terminated), the learned upsamples, output layers
(``out_channels == n_classes``) and kernels with one input channel and more
than 8 outputs (the JAX rule for depthwise convs, which also leaves the
depth stem's 1-channel conv as it is); BN and biases stay. The draws come
from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from dynmm_tpu_torch.nn.layers import pack_weights
from dynmm_tpu_torch.utils.weights import torch_to_flax_key


def _skipped_subtree(name: str) -> bool:
    parts = torch_to_flax_key(name).split(".")[:-1]
    return any(p.startswith("se_") or p.startswith("upsample") for p in parts)


@torch.no_grad()
def apply_he_init(model: nn.Module, generator: torch.Generator,
                  n_classes: int) -> None:
    """Re-draw the model's conv kernels in place (see the module
    docstring), then rebuild its packed weight copies."""
    for name, p in model.named_parameters():
        if not name.endswith(".weight") or p.dim() != 4 or _skipped_subtree(name):
            continue
        c_out, c_in, kh, kw = p.shape
        if c_out == n_classes or (c_in == 1 and c_out > 8):
            continue
        std = math.sqrt(2.0 / (kh * kw * c_out))
        draw = torch.randn(p.shape, generator=generator,
                           device=generator.device, dtype=p.dtype)
        p.copy_(draw * std)
    pack_weights(model)


def _orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal()`` of a square (or any 2-D) shape: Q of the QR
    of a standard normal draw, columns signed by diag(R)."""
    rows, cols = shape
    big, small = max(rows, cols), min(rows, cols)
    a = torch.randn(big, small, generator=generator, dtype=torch.float64,
                    device=generator.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q if rows >= cols else q.T


@torch.no_grad()
def flax_default_init(model: nn.Module, generator: torch.Generator) -> None:
    """Every ``nn.Linear`` as flax's ``Dense`` defaults: kernel
    ``lecun_normal`` (a normal truncated to ±2 standard deviations, scaled
    to variance 1/fan_in), bias 0. LayerNorm and BN keep their ones and
    zeros, which are flax's too. Then flax's own initialisers where a
    module has them: a ``GRUCell``'s ``hr``/``hz``/``hn`` kernels
    ``orthogonal``; ``LowRankTensorFusion``'s factors and rank weights
    ``normal(0.02)``, its bias 0; ``MultiplicativeInteractions2Modal``'s
    ``W`` and ``V`` ``normal(0.01)``, ``U`` and ``b`` 0."""
    from dynmm_tpu_torch.nn.fusions import (LowRankTensorFusion,
                                            MultiplicativeInteractions2Modal)
    from dynmm_tpu_torch.nn.sequence import GRUCell

    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    for m in model.modules():
        if not isinstance(m, nn.Linear):
            continue
        w = m.weight
        u = torch.rand(w.shape, generator=generator, dtype=torch.float64,
                       device=generator.device)
        z = math.sqrt(2) * torch.erfinv(2 * (lo + (hi - lo) * u) - 1)
        # .87962566103423978: the std of a standard normal truncated to ±2
        std = math.sqrt(1.0 / w.shape[1]) / .87962566103423978
        w.copy_((z * std).to(w.dtype))
        if m.bias is not None:
            m.bias.zero_()

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=generator.device) * std)

    for m in model.modules():
        if isinstance(m, GRUCell):
            for d in (m.hr, m.hz, m.hn):
                d.weight.copy_(_orthogonal(d.weight.shape, generator))
        elif isinstance(m, LowRankTensorFusion):
            for i in range(m.n_mod):
                normal(getattr(m, f"factor{i}"), 0.02)
            normal(m.rank_weights, 0.02)
            m.bias.zero_()
        elif isinstance(m, MultiplicativeInteractions2Modal):
            normal(m.W, 0.01)
            normal(m.V, 0.01)
            m.U.zero_()
            m.b.zero_()
