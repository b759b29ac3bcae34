"""Segmentation losses: class-weighted, void-ignoring multi-scale CE (port of
``dynmm_tpu/train/seg_losses.py``).

Labels carry void as class 0; the net predicts the non-void classes, so the
target is label − 1 and void pixels are left out. The training loss is the
class-weighted sum of the per-pixel NLL over the *weighted* non-void pixel
count ``Σ w[target]``; one loss per scale (full, 1/8, 1/16, 1/32), summed.
The validation loss accumulates sum-reduced CE and divides at the end.
Logits are NHWC (B, H, W, C), labels (B, H, W) integers with 0 = void.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``log_softmax`` over the last axis. bf16 logits take
    ``jax.nn.log_softmax``'s formula op by op, each step rounded to bf16
    as XLA computes it (``F.log_softmax`` rounds once); wider logits take
    ``F.log_softmax``."""
    if x.dtype != torch.bfloat16:
        return F.log_softmax(x, dim=-1)
    shifted = x - x.amax(dim=-1, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _nll_and_valid(logits: torch.Tensor, targets: torch.Tensor):
    """Per-pixel NLL of the clipped target (B, H, W) and the non-void mask;
    the NLL in the logits' dtype."""
    t = targets.long() - 1
    valid = t >= 0
    tc = t.clamp(0, logits.shape[-1] - 1)
    if logits.dtype == torch.bfloat16:
        nll = -log_softmax(logits).gather(-1, tc[..., None])[..., 0]
    else:
        nll = F.cross_entropy(logits.permute(0, 3, 1, 2), tc,
                              reduction="none")
    return nll, valid, tc


def weighted_ce_2d(logits: torch.Tensor, targets: torch.Tensor,
                   class_weights: torch.Tensor,
                   reduce: Optional[Callable] = None) -> torch.Tensor:
    """Class-weighted, void-ignoring CE over the weighted pixel count.
    ``reduce`` (mesh training: the sum over the 'data' axis) takes the
    numerator and the count over the global batch."""
    nll, valid, tc = _nll_and_valid(logits, targets)
    w = class_weights[tc] * valid.to(logits.dtype)
    num, den = (nll * w).sum(), w.sum()
    if reduce is not None:
        num, den = reduce(num), reduce(den)
    return num / den.clamp_min(1e-12)


def multiscale_ce(preds: Sequence[torch.Tensor],
                  targets: Sequence[torch.Tensor],
                  class_weights: torch.Tensor,
                  reduce: Optional[Callable] = None
                  ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Sum of per-scale weighted CE losses; returns (total, per-scale list).
    ``reduce``: as ``weighted_ce_2d``'s."""
    losses = [weighted_ce_2d(p, t, class_weights, reduce)
              for p, t in zip(preds, targets)]
    return sum(losses), losses


def ce_sum_and_weight(logits: torch.Tensor, targets: torch.Tensor,
                      class_weights: torch.Tensor | None = None):
    """Sum-reduced CE over non-void pixels (class-weighted when weights are
    given) and the batch's non-void pixel count."""
    nll, valid, tc = _nll_and_valid(logits, targets)
    mask = valid.to(logits.dtype)
    if class_weights is not None:
        mask = class_weights[tc] * mask
    return (nll * mask).sum(), valid.sum()


class StreamingValidLoss:
    """Accumulates sum-reduced CE across eval batches; ``compute`` divides by
    a fixed weighted pixel sum when one is given, else by the running
    non-void pixel count."""

    def __init__(self, class_weights=None,
                 weighted_pixel_sum: float | None = None):
        self.class_weights = class_weights
        self.weighted_pixel_sum = weighted_pixel_sum
        self.reset()

    def reset(self):
        self.total = 0.0
        self.pixels = 0

    def add_batch(self, logits, targets):
        cw = self.class_weights
        if cw is not None:
            cw = torch.as_tensor(cw, dtype=logits.dtype, device=logits.device)
        s, n = ce_sum_and_weight(logits, targets, cw)
        self.total += float(s)
        self.pixels += int(n)

    def compute(self) -> float:
        denom = (self.weighted_pixel_sum
                 if self.weighted_pixel_sum is not None else self.pixels)
        return self.total / max(denom, 1e-12)
