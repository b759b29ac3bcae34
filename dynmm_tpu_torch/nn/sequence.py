"""Sequence encoders with explicit length masks (port of
``dynmm_tpu/nn/sequence.py``): ``length_mask``, ``last_valid``,
``sinusoidal_positions``, the masked ``GRU``/``GRUWithLinear`` of the
CMU-MOSEI experts and the pre-norm ``Transformer`` of the routers.

Every sequence op takes a fixed-shape (batch, time, feat) tensor and
``lengths`` (batch,) ints. Flax's conventions are kept where they change a
number:

* ``LayerNorm`` eps is 1e-6 (flax's default), not torch's 1e-5.
* The attention is flax's ``MultiHeadDotProductAttention``: separate
  ``query``/``key``/``value`` projections with biases, the query divided by
  √head_dim, padded keys masked with the dtype's most negative value (not
  −inf: a row with no valid key gets uniform weights, never NaN), dropout
  on the attention weights with one (query, key) mask for the whole batch
  and every head (flax's ``broadcast_dropout``), and an ``out`` projection
  from the concatenated heads. Keys and values may come from another
  sequence (MulT's cross-modal attention).
* The GRU cell is flax's ``GRUCell``: ``ir``/``iz``/``in`` input denses
  with biases, ``hr``/``hz`` hidden denses without, ``hn`` with a bias that
  sits inside ``r · (…)``; ``h' = (1 − z)·n + z·h``. Past a sequence's end
  the state freezes (``torch.where`` on the step mask), so the full
  sequence repeats the last valid state there, where
  ``pack_padded_sequence`` would give zeros.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynmm_tpu_torch.nn.mlp import Dropout

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
    """Flax's attention, ``qkv_features`` = ``out_features`` = ``dim``:
    ``query``/``key``/``value`` are (dim → heads·head_dim) projections
    (flax kernels (dim, heads, head_dim)), ``out`` maps heads·head_dim →
    dim (flax kernel (heads, head_dim, dim)). ``forward(x, mask, kv)``:
    queries from ``x``, keys and values from ``kv`` (default ``x``; the
    same width, another length), ``mask`` (batch, kv time) over the
    keys."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.drop = Dropout(dropout_rate, broadcast_dims=(0, 1))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if kv is None else kv
        b, t, _ = x.shape
        heads = (self.num_heads, self.head_dim)
        q = self.query(x).view(b, t, *heads) / math.sqrt(self.head_dim)
        k = self.key(kv).view(b, kv.shape[1], *heads)
        v = self.value(kv).view(b, kv.shape[1], *heads)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :],
                                        torch.finfo(scores.dtype).min)
        attn = self.drop(F.softmax(scores, dim=-1))
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


class GRUCell(nn.Module):
    """flax's ``GRUCell`` (see the module docstring); ``in`` is a Python
    keyword, so that submodule is reached with ``getattr``."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            setattr(self, name, nn.Linear(in_dim, hidden_dim))
        self.hr = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.hz = nn.Linear(hidden_dim, hidden_dim, bias=False)
        self.hn = nn.Linear(hidden_dim, hidden_dim)


class _Scan(nn.Module):
    """The flax ``scan`` scope that holds the step's ``cell``."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.cell = GRUCell(in_dim, hidden_dim)


class GRU(nn.Module):
    """Masked GRU encoder (MultiBench ``GRU(indim, hiddim, dropout,
    has_padding, flatten, last_only)``): the last valid state (``last_only``,
    the experts' mode), the flattened (batch, time·hidden) sequence
    (``flatten``), or the (batch, time, hidden) sequence. With ``dropout``
    the last state and the sequence each get their own mask, as in the JAX
    package.

    The input projections of every step are one product before the loop
    over time; each step is one product of the state with the three hidden
    denses."""

    flax_tree = True  # submodules named after the flax tree

    def __init__(self, in_dim: int, hidden_dim: int, dropout: bool = False,
                 dropout_rate: float = 0.1, flatten: bool = False,
                 last_only: bool = True):
        super().__init__()
        self.hidden_dim, self.flatten, self.last_only = (hidden_dim, flatten,
                                                         last_only)
        self.scan = _Scan(in_dim, hidden_dim)
        self.drop_last = Dropout(dropout_rate) if dropout else None
        self.drop_seq = Dropout(dropout_rate) if dropout else None

    def states(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(last state (B, H), every step's state (B, T, H)), after
        dropout."""
        b, t, _ = x.shape
        cell = self.scan.cell
        if lengths is None:
            lengths = torch.full((b,), t, dtype=torch.long, device=x.device)
        mask = length_mask(lengths, t)[..., None]
        dense_i = [getattr(cell, n) for n in ("ir", "iz", "in")]
        gates = F.linear(x, torch.cat([d.weight for d in dense_i]),
                         torch.cat([d.bias for d in dense_i])).chunk(3, dim=-1)
        zeros = torch.zeros_like(cell.hn.bias)  # only hn has a bias
        w_h = torch.cat([cell.hr.weight, cell.hz.weight, cell.hn.weight])
        b_h = torch.cat([zeros, zeros, cell.hn.bias])
        h = x.new_zeros(b, self.hidden_dim)
        seq = []
        for s in range(t):
            h_r, h_z, h_n = F.linear(h, w_h, b_h).chunk(3, dim=-1)
            r = torch.sigmoid(gates[0][:, s] + h_r)
            z = torch.sigmoid(gates[1][:, s] + h_z)
            n = torch.tanh(gates[2][:, s] + r * h_n)
            h = torch.where(mask[:, s], (1.0 - z) * n + z * h, h)
            seq.append(h)
        h_seq = torch.stack(seq, dim=1)
        if self.drop_last is not None:
            h, h_seq = self.drop_last(h), self.drop_seq(h_seq)
        return h, h_seq

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        h_last, h_seq = self.states(x, lengths)
        if self.last_only:
            return h_last
        if self.flatten:
            return h_seq.reshape(x.shape[0], -1)
        return h_seq


class GRUWithLinear(nn.Module):
    """``GRU`` then a dense ``linear`` (MultiBench ``GRUWithLinear``);
    ``time`` sizes the dense of a flattened sequence."""

    flax_tree = True  # submodules named after the flax tree

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dropout: bool = False, dropout_rate: float = 0.1,
                 flatten: bool = False, last_only: bool = True,
                 time: Optional[int] = None):
        super().__init__()
        self.gru = GRU(in_dim, hidden_dim, dropout, dropout_rate, flatten,
                       last_only)
        width = hidden_dim * (time if flatten and not last_only else 1)
        self.linear = nn.Linear(width, out_dim)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.linear(self.gru(x, lengths))
