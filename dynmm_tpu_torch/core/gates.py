"""Differentiable gate ops with straight-through gradients (port of
``dynmm_tpu/core/gates.py``).

``straight_through`` is ``y_hard - y_soft.detach() + y_soft``: the value of
the hard one-hot with the gradient of the soft distribution. Randomness
takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def straight_through(y_hard: torch.Tensor, y_soft: torch.Tensor
                     ) -> torch.Tensor:
    """Value of ``y_hard``, gradient of ``y_soft``."""
    return y_hard - y_soft.detach() + y_soft


def hard_one_hot(y_soft: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """One-hot of the argmax along ``dim`` (ties go to the first index),
    same shape and dtype as ``y_soft``."""
    index = y_soft.argmax(dim=dim, keepdim=True)
    return torch.zeros_like(y_soft).scatter_(dim, index, 1.0)


class _LowpSoftmax(torch.autograd.Function):
    """``jax.nn.softmax`` below fp32, forward and backward rounded op by op
    as XLA rounds them: ``e = exp(x − max)`` (the max held constant), its
    sum ``s`` (an fp32 accumulation), ``e / s``; the backward is the
    quotient's and ``exp``'s, ``(g / s − Σ(g · s⁻² · e)) · e``, with
    ``s⁻² = 1 / (s · s)``."""

    @staticmethod
    def forward(ctx, x, dim):
        e = torch.exp(x - x.amax(dim=dim, keepdim=True))
        s = e.sum(dim=dim, keepdim=True)
        ctx.save_for_backward(e, s)
        ctx.dim = dim
        return e / s

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        gs = -(g * (1.0 / (s * s)) * e).sum(dim=ctx.dim, keepdim=True)
        return (g / s + gs) * e, None


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``F.softmax``; below fp32 (bf16) in ``jax.nn.softmax``'s order of
    operations, each rounding to ``x``'s dtype: exp(x − max), its sum (an
    fp32 accumulation), the quotient, and their gradients.
    ``F.softmax`` rounds its output alone, one bf16 step away from JAX's."""
    if x.dtype in (torch.float32, torch.float64):
        return F.softmax(x, dim=dim)
    return _LowpSoftmax.apply(x, dim)


def diff_softmax(logits: torch.Tensor, tau: float = 1.0, hard: bool = False,
                 dim: int = -1) -> torch.Tensor:
    """Temperature softmax with optional straight-through hard one-hot."""
    y_soft = F.softmax(logits / tau, dim=dim)
    if not hard:
        return y_soft
    return straight_through(hard_one_hot(y_soft, dim=dim), y_soft)


def sample_gumbel(shape, generator: torch.Generator, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Standard Gumbel(0, 1) noise, ``-log(-log(U))``."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    u = u.clamp_min(1e-20)
    return -torch.log(-torch.log(u))


def gumbel_softmax(logits: torch.Tensor, generator: torch.Generator,
                   tau: float = 1.0, hard: bool = False, dim: int = -1
                   ) -> torch.Tensor:
    """Gumbel-softmax sample with optional straight-through hard one-hot,
    drawing its noise from ``generator`` on the generator's device."""
    g = sample_gumbel(logits.shape, generator,
                      dtype=torch.promote_types(logits.dtype, torch.float32),
                      device=generator.device).to(logits.device)
    y_soft = softmax((logits + g.to(logits.dtype)) / tau, dim=dim)
    if not hard:
        return y_soft
    return straight_through(hard_one_hot(y_soft, dim=dim), y_soft)
