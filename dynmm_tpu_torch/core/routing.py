"""Row permutes of the routed strategies (port of
``dynmm_tpu/core/routing.py::permute_rows`` and ``scatter_rows``).

The JAX package writes both as one-hot contractions so XLA keeps its tiled
layout; in PyTorch they are a gather and a scatter along axis 0, which move
each row once and are exact for any values (no 0·NaN terms).
``compact_two_branch`` waits for the modality-level slice.
"""

from __future__ import annotations

import torch


def permute_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` along axis 0."""
    return x.index_select(0, perm)


def scatter_rows(contrib: torch.Tensor, order: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Sorted-prefix rows back at their original batch positions:
    ``contrib`` (cap, *D) holds original samples ``order[:cap]``; returns
    (n, *D) with ``out[order[p]] = contrib[p]`` for p < cap, zeros
    elsewhere."""
    out = contrib.new_zeros((n, *contrib.shape[1:]))
    return out.index_copy_(0, order[:contrib.shape[0]], contrib)
