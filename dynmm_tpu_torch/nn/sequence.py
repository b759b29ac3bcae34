"""Sequence encoders with explicit length masks (port of
``dynmm_tpu/nn/sequence.py``): ``length_mask``, ``last_valid``,
``sinusoidal_positions`` and the pre-norm ``Transformer`` of the CMU-MOSEI
routers.

Every sequence op takes a fixed-shape (batch, time, feat) tensor and
``lengths`` (batch,) ints. Flax's conventions are kept where they change a
number:

* ``LayerNorm`` eps is 1e-6 (flax's default), not torch's 1e-5.
* The attention is flax's ``MultiHeadDotProductAttention``: separate
  ``query``/``key``/``value`` projections with biases, the query divided by
  √head_dim, padded keys masked with the dtype's most negative value (not
  −inf: a row with no valid key gets uniform weights, never NaN), and an
  ``out`` projection from the concatenated heads.

The masked ``GRU``/``GRUWithLinear`` wait (ROADMAP A8).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(batch, max_len) bool mask: True where t < length."""
    t = torch.arange(max_len, device=lengths.device)
    return t[None, :] < lengths[:, None]


def last_valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``x[b, lengths[b] − 1, :]`` for each b (clipped into the sequence)."""
    idx = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def sinusoidal_positions(time: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(time, dim) sinusoidal position embeddings: sines of the first
    ⌈dim/2⌉ frequencies, then cosines, cut to ``dim``."""
    pos = torch.arange(time, dtype=dtype, device=device)[:, None]
    half = (dim + 1) // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=dtype, device=device)
                      / max(half, 1))
    angles = pos * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)[:, :dim]


class MultiHeadDotProductAttention(nn.Module):
    """Flax's self-attention, ``qkv_features`` = ``out_features`` = ``dim``:
    ``query``/``key``/``value`` are (dim → heads·head_dim) projections (flax
    kernels (dim, heads, head_dim)), ``out`` maps heads·head_dim → dim
    (flax kernel (heads, head_dim, dim))."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        split = (b, t, self.num_heads, self.head_dim)
        q = self.query(x).view(split) / math.sqrt(self.head_dim)
        k = self.key(x).view(split)
        v = self.value(x).view(split)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :],
                                        torch.finfo(scores.dtype).min)
        attn = F.softmax(scores, dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out(y.reshape(b, t, -1))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm block: ``x + attn(ln1(x))``, then
    ``x + ffn2(relu(ffn1(ln2(x))))``."""

    def __init__(self, dim: int, num_heads: int, ffn_mult: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadDotProductAttention(dim, num_heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn1 = nn.Linear(dim, dim * ffn_mult)
        self.ffn2 = nn.Linear(dim * ffn_mult, dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask)
        return x + self.ffn2(F.relu(self.ffn1(self.ln2(x))))


class Transformer(nn.Module):
    """Sequence-summary transformer (MultiBench ``Transformer(n_features,
    dim)``): ``proj`` (bias-free) to ``dim``, sinusoidal positions,
    ``num_layers`` encoder blocks ``layer{i}`` over the valid steps,
    ``ln_out``, and the last valid step as the (batch, dim) summary."""

    flax_tree = True  # submodules named after the flax tree

    def __init__(self, in_features: int, dim: int, num_layers: int = 3,
                 num_heads: int = 2):
        super().__init__()
        self.dim, self.num_layers = dim, num_layers
        self.proj = nn.Linear(in_features, dim, bias=False)
        for i in range(num_layers):
            setattr(self, f"layer{i}", TransformerEncoderLayer(dim, num_heads))
        self.ln_out = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        if lengths is None:
            lengths = torch.full((b,), t, dtype=torch.long, device=x.device)
        mask = length_mask(lengths, t)
        h = self.proj(x)
        h = h + sinusoidal_positions(t, self.dim, h.dtype, h.device)[None]
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i}")(h, mask)
        return last_valid(self.ln_out(h), lengths)
