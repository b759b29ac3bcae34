"""Row permutes of the routed strategies and the modality routers' bucket
compaction (port of ``dynmm_tpu/core/routing.py``: ``permute_rows``,
``scatter_rows``, ``compact_two_branch``).

The JAX package writes the permutes as one-hot contractions so XLA keeps
its tiled layout; in PyTorch they are a gather and a scatter along axis 0,
which move each row once and are exact for any values (no 0·NaN terms).

``compact_two_branch`` sorts the batch by routing decision (a stable sort,
as ``jnp.argsort``), runs the expensive branch on a prefix and the cheap one
on the suffix, each at the smallest rung of a capacity ladder that holds its
participants, and puts the rows back in the caller's order. Where the JAX
package picks the rung with a chain of ``lax.cond``s on the device, the port
reads the expensive branch's count on the host, once per request.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

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


def _tree_map(fn: Callable, tree):
    """``fn`` on every tensor of nested lists and tuples (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def compact_two_branch(k: torch.Tensor, inputs, cheap_fn: Callable,
                       expensive_fn: Callable,
                       caps: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Per-sample two-way routed execution with bucket compaction.

    ``k`` (B,) ints: 1 routes a sample to ``expensive_fn``, 0 to
    ``cheap_fn``. ``inputs``: nested lists/tuples of tensors with leading
    batch dim B (None allowed). Each ``fn(inputs_slice) -> (n, *out)`` runs
    on a contiguous slice of the sorted batch: the expensive branch on the
    first ``cap_e`` rows, the cheap one on the last ``cap_c``, each the
    smallest rung ≥ its participants (a rung of 0 runs nothing) of the
    ladder ``caps`` plus B (default ``(0, B//4, B//2, 3B//4, B)``; an entry
    outside [0, B] raises). Returns (B, *out) in the caller's sample order;
    each row equals its branch run alone on that sample.
    """
    bs = k.shape[0]
    if caps is None:
        caps = (0, bs // 4, bs // 2, (3 * bs) // 4, bs)
    caps = [int(c) for c in caps] + [bs]
    for c in caps:
        if not 0 <= c <= bs:
            raise ValueError(f"capacity ladder entry {c} outside [0, batch="
                             f"{bs}]; caps={caps[:-1]}")
    ladder = sorted(set(caps))
    k = k.long()
    order = torch.argsort(-k, stable=True)  # expensive samples first
    sorted_inputs = _tree_map(lambda a: permute_rows(a, order), inputs)
    n_exp = int(k.sum())  # the one host read of the request
    n_cheap = bs - n_exp
    cap_e = next(c for c in ladder if n_exp <= c)
    cap_c = next(c for c in ladder if n_cheap <= c)
    parts = []
    if cap_e:
        out = expensive_fn(_tree_map(lambda a: a[:cap_e], sorted_inputs))
        parts.append(out[:n_exp])
    if cap_c:
        out = cheap_fn(_tree_map(lambda a: a[bs - cap_c:], sorted_inputs))
        parts.append(out[cap_c - n_cheap:])
    return scatter_rows(torch.cat(parts), order, bs)
