"""Resource (FLOP) losses and gate-decision statistics (port of
``dynmm_tpu/core/resource.py``).

* ``expected_cost_loss``: ``(weight.mean(0) * cost_table).mean()``, the mean
  over paths (not the sum) of the batch-mean gate weights times a per-path
  cost table (reference ``model_skip_mod_globalgate.py:314-322``).
* ``budget_hinge``: ``max(0, cost − budget)`` (reference ``train.py:316-319``).
* ``GateStats``: host-side accumulator of per-sample gate weights across an
  eval pass: branch ratios, hard-selection counts and the cost-table dot
  products (reference ``imdb_dyn.py:72-87``).
"""

from __future__ import annotations

import numpy as np
import torch


def expected_cost_loss(weights: torch.Tensor, cost_table) -> torch.Tensor:
    """``(weights.mean(0) * cost_table).mean()`` for (batch, n_paths)
    weights and an (n_paths,) table (a tensor or array)."""
    table = torch.as_tensor(cost_table, dtype=weights.dtype,
                            device=weights.device)
    return (weights.mean(dim=0) * table).mean()


def budget_hinge(cost: torch.Tensor, budget: float) -> torch.Tensor:
    """Hinge penalty ``max(0, cost − budget)``."""
    return torch.clamp(cost - budget, min=0.0)


class GateStats:
    """Collects per-sample gate weights (tensors or arrays) on the host."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def reset(self) -> None:
        self._chunks = []

    def append(self, weights) -> None:
        if isinstance(weights, torch.Tensor):
            if weights.dtype == torch.bfloat16:  # numpy has no bf16
                weights = weights.float()
            weights = weights.detach().cpu().numpy()
        self._chunks.append(np.asarray(weights))

    @property
    def weights(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0, 0))
        return np.concatenate(self._chunks, axis=0)

    def branch_ratios(self) -> np.ndarray:
        """Mean weight per branch over all collected samples."""
        w = self.weights
        if w.size == 0:
            return np.zeros(0)
        return w.mean(axis=0)

    def selection_counts(self) -> np.ndarray:
        """Count of hard (== 1) selections per branch."""
        w = self.weights
        if w.size == 0:
            return np.zeros(0)
        return (w == 1).sum(axis=0).astype(np.float64)

    def expected_flops(self, cost_table) -> float:
        """Σᵢ costᵢ · E[wᵢ] (the reference's ``cal_flop``)."""
        table = np.asarray(cost_table, dtype=np.float64)
        return float((table * self.branch_ratios()).sum())

    def selection_flops(self, cost_table) -> float:
        """Cost table weighted by hard-selection frequencies."""
        cnt = self.selection_counts()
        total = cnt.sum()
        if total == 0:
            return 0.0
        table = np.asarray(cost_table, dtype=np.float64)
        return float((table * (cnt / total)).sum())
