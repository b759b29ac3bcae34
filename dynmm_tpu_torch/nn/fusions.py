"""Multimodal fusions (port of ``dynmm_tpu/nn/fusions.py``; MultiBench's
``fusions.common_fusions``): ``Concat`` (the routers' late fusion),
``ConcatEarly``, ``LowRankTensorFusion`` and
``MultiplicativeInteractions2Modal`` (the ``_mm`` experts).

The last two keep flax's raw parameters under their flax names and shapes
(``factor{i}`` (R, d+1, out), ``rank_weights`` (1, R), ``bias`` (1, out);
``W`` (d2, d1, out), ``U`` (d1, out), ``V`` (d2, out), ``b`` (out,)) and
the JAX package's einsum orders. A torch module is built with its input
widths, so each constructor takes them; ``utils/init.py`` draws flax's
initial values.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


class Concat(nn.Module):
    """Late fusion: flatten each modality's representation and concatenate
    them on the feature axis."""

    def forward(self, modalities: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([m.reshape(m.shape[0], -1) for m in modalities],
                         dim=-1)


class ConcatEarly(nn.Module):
    """Early fusion: concatenate the raw streams on the last axis
    (sequences stay (batch, time, Σ feat))."""

    def forward(self, modalities: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(modalities), dim=-1)


class LowRankTensorFusion(nn.Module):
    """Low-rank tensor fusion (Liu et al. 2018): each flattened modality,
    with a 1 appended, through its rank-R factor stack (``bd,rdo->rbo``),
    the product over modalities, then the rank-weighted sum
    (``rbo,r->bo``) plus ``bias``. ``in_dims``: the modalities' flattened
    widths."""

    flax_tree = True  # parameters named after the flax tree

    def __init__(self, in_dims: Sequence[int], output_dim: int,
                 rank: int = 16):
        super().__init__()
        self.n_mod = len(in_dims)
        for i, d in enumerate(in_dims):
            self.register_parameter(f"factor{i}", nn.Parameter(
                torch.zeros(rank, d + 1, output_dim)))
        self.rank_weights = nn.Parameter(torch.zeros(1, rank))
        self.bias = nn.Parameter(torch.zeros(1, output_dim))

    def forward(self, modalities: Sequence[torch.Tensor]) -> torch.Tensor:
        batch = modalities[0].shape[0]
        fused = None
        for i, m in enumerate(modalities):
            m = m.reshape(batch, -1)
            m1 = torch.cat([m, m.new_ones(batch, 1)], dim=-1)
            proj = torch.einsum("bd,rdo->rbo", m1, getattr(self, f"factor{i}"))
            fused = proj if fused is None else fused * proj
        out = torch.einsum("rbo,r->bo", fused, self.rank_weights[0])
        return out + self.bias


class MultiplicativeInteractions2Modal(nn.Module):
    """Bilinear ('matrix') interaction of two modalities, ``out = x1 · (W ⋅
    x2 + U) + (V ⋅ x2 + b)``: ``bd,dio->bio`` then ``bi,bio->bo``
    (MultiBench ``MultiplicativeInteractions2Modal([d1, d2], out,
    'matrix')``)."""

    flax_tree = True  # parameters named after the flax tree

    def __init__(self, in_dims: Sequence[int], output_dim: int):
        super().__init__()
        d1, d2 = in_dims
        self.W = nn.Parameter(torch.zeros(d2, d1, output_dim))
        self.U = nn.Parameter(torch.zeros(d1, output_dim))
        self.V = nn.Parameter(torch.zeros(d2, output_dim))
        self.b = nn.Parameter(torch.zeros(output_dim))

    def forward(self, modalities: Sequence[torch.Tensor]) -> torch.Tensor:
        x1 = modalities[0].reshape(modalities[0].shape[0], -1)
        x2 = modalities[1].reshape(modalities[1].shape[0], -1)
        wx2 = torch.einsum("bd,dio->bio", x2, self.W)
        out = torch.einsum("bi,bio->bo", x1, wx2 + self.U[None])
        return out + x2 @ self.V + self.b
