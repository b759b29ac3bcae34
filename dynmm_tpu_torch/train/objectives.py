"""Training objectives (port of ``dynmm_tpu/train/objectives.py``): the
torch criteria the reference uses, each a mean over every element
(``reduction='mean'``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, targets)


def l1_loss(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (pred - targets).abs().mean()


def mse_loss(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (pred - targets).square().mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Integer-label CE; a trailing singleton label dim is squeezed (the
    reference's ``deal_with_objective``)."""
    if labels.dim() == logits.dim():
        labels = labels.squeeze(-1)
    return F.cross_entropy(logits, labels.long())


OBJECTIVES = {
    "bce_with_logits": bce_with_logits,
    "l1": l1_loss,
    "mse": mse_loss,
    "cross_entropy": cross_entropy,
}


def get_objective(name: str):
    return OBJECTIVES[name]
