"""MulT, the multimodal transformer with cross-modal attention (Tsai et al.
2019; port of ``dynmm_tpu/models/mult.py``): ``affect_mm --fusion 4``,
``MULTModel`` with embed 40, 10 heads, 4 layers and one output over the
(visual 35, audio 74, text 300) streams.

Per-modality bias-free projections to ``embed_dim`` plus sinusoidal
positions; for every target modality i, a cross-modal transformer
``cross_i_j`` from i's queries to each other modality j's keys and values;
the concatenation of those streams through a ``self_i`` transformer of
width (n − 1)·``embed_dim`` on (h, h) (it keeps both of its layer norms,
``ln_q`` and ``ln_kv``, though they see the same input); the last valid
step (with ``lengths``; else the last padded step); the concatenation of
the n summaries through a residual MLP and ``out_layer``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynmm_tpu_torch.nn.mlp import Dropout
from dynmm_tpu_torch.nn.sequence import (LN_EPS, MultiHeadDotProductAttention,
                                         last_valid, length_mask,
                                         sinusoidal_positions)


class CrossModalLayer(nn.Module):
    """Pre-norm cross-attention block: ``target + attn(ln_q(target),
    ln_kv(source))``, then ``x + ffn2(relu(ffn1(ln_ffn(x))))``."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.1):
        super().__init__()
        self.ln_q = nn.LayerNorm(dim, eps=LN_EPS)
        self.ln_kv = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadDotProductAttention(dim, num_heads,
                                                 dropout_rate=dropout_rate)
        self.ln_ffn = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn1 = nn.Linear(dim, dim * 4)
        self.ffn2 = nn.Linear(dim * 4, dim)

    def forward(self, target: torch.Tensor, source: torch.Tensor,
                source_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = target + self.attn(self.ln_q(target), source_mask,
                               self.ln_kv(source))
        return x + self.ffn2(F.relu(self.ffn1(self.ln_ffn(x))))


class CrossModalTransformer(nn.Module):
    """``layers`` ``CrossModalLayer``s ``layer{i}`` over one source."""

    def __init__(self, dim: int, num_heads: int, layers: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            setattr(self, f"layer{i}",
                    CrossModalLayer(dim, num_heads, dropout_rate))

    def forward(self, target: torch.Tensor, source: torch.Tensor,
                source_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = target
        for i in range(self.layers):
            h = getattr(self, f"layer{i}")(h, source, source_mask)
        return h


class MULTModel(nn.Module):
    """MulT fusion head: n (batch, time, d_i) streams → (batch,
    ``output_dim``). ``in_dims``: the streams' feature widths."""

    flax_tree = True  # submodules named after the flax tree

    def __init__(self, in_dims: Sequence[int] = (35, 74, 300),
                 embed_dim: int = 40, num_heads: int = 10, layers: int = 4,
                 output_dim: int = 1, dropout_rate: float = 0.1):
        super().__init__()
        n = self.n_mod = len(in_dims)
        self.embed_dim = embed_dim
        for i, d in enumerate(in_dims):
            setattr(self, f"proj{i}", nn.Linear(d, embed_dim, bias=False))
        cross = (n - 1) * embed_dim
        for i in range(n):
            for j in range(n):
                if i != j:
                    setattr(self, f"cross_{i}_{j}", CrossModalTransformer(
                        embed_dim, num_heads, layers, dropout_rate))
            setattr(self, f"self_{i}", CrossModalTransformer(
                cross, num_heads, max(layers // 2, 1), dropout_rate))
        fused = n * cross
        self.out_proj1 = nn.Linear(fused, fused)
        self.drop = Dropout(dropout_rate)
        self.out_proj2 = nn.Linear(fused, fused)
        self.out_layer = nn.Linear(fused, output_dim)

    def forward(self, modalities: Sequence[torch.Tensor],
                lengths: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        n = self.n_mod
        masks = [None if lengths is None else length_mask(lengths[i],
                                                          m.shape[1])
                 for i, m in enumerate(modalities)]
        streams = []
        for i, m in enumerate(modalities):
            h = getattr(self, f"proj{i}")(m)
            streams.append(h + sinusoidal_positions(
                m.shape[1], self.embed_dim, h.dtype, h.device)[None])
        summaries = []
        for i in range(n):
            h = torch.cat([getattr(self, f"cross_{i}_{j}")(
                streams[i], streams[j], masks[j]) for j in range(n) if j != i],
                dim=-1)
            h = getattr(self, f"self_{i}")(h, h, masks[i])
            summaries.append(h[:, -1] if lengths is None
                             else last_valid(h, lengths[i]))
        fused = torch.cat(summaries, dim=-1)
        y = self.out_proj2(self.drop(F.relu(self.out_proj1(fused))))
        return self.out_layer(fused + y)
