"""Confusion matrix and mIoU (``ConfusionMatrix`` is a copy of
``dynmm_tpu/train/metrics.py``'s; ``confusion_update_counts`` its device
increment, in PyTorch).

Same math as the reference's ignite-based matrix:
``iou = diag / (row + col − diag)``, mIoU over the classes present.
"""

from __future__ import annotations

import numpy as np
import torch


class ConfusionMatrix:
    """Streaming confusion matrix over integer labels in [0, n_classes).

    ``update`` accepts flat (already void-masked) label/prediction arrays and
    accumulates on host; the bincount itself runs as a vectorized numpy op
    (cheap next to the model forward). Matches the semantics of the
    reference's ignite-based ``ConfusionMatrixPytorch``
    (confusion_matrix.py:85-144).
    """

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.matrix = np.zeros((self.n_classes, self.n_classes), dtype=np.int64)

    def update(self, label: np.ndarray, prediction: np.ndarray):
        label = np.asarray(label).reshape(-1).astype(np.int64)
        prediction = np.asarray(prediction).reshape(-1).astype(np.int64)
        n = self.n_classes
        valid = (label >= 0) & (label < n)
        idx = label[valid] * n + prediction[valid]
        self.matrix += np.bincount(idx, minlength=n * n).reshape(n, n)

    def iou(self) -> np.ndarray:
        """Per-class IoU = diag / (row + col − diag); NaN-safe (0 where the
        class never appears)."""
        m = self.matrix.astype(np.float64)
        diag = np.diag(m)
        denom = m.sum(axis=0) + m.sum(axis=1) - diag
        return np.where(denom > 0, diag / np.maximum(denom, 1e-15), 0.0)

    def miou(self, ignore_absent: bool = True) -> float:
        """Mean IoU. ``ignore_absent`` averages only over classes present in
        labels or predictions (ignite semantics: absent classes produce NaN
        and are excluded)."""
        m = self.matrix.astype(np.float64)
        diag = np.diag(m)
        denom = m.sum(axis=0) + m.sum(axis=1) - diag
        if ignore_absent:
            present = denom > 0
            if not present.any():
                return 0.0
            return float((diag[present] / denom[present]).mean())
        return float(self.iou().mean())


def confusion_update_counts(label: torch.Tensor, prediction: torch.Tensor,
                            n_classes: int) -> torch.Tensor:
    """One batch's (n_classes, n_classes) int64 count matrix, computed on
    the tensors' device: rows are labels, columns predictions; labels
    outside [0, n_classes) (void as −1) are dropped."""
    label = label.reshape(-1).long()
    prediction = prediction.reshape(-1).long()
    valid = (label >= 0) & (label < n_classes)
    idx = label[valid] * n_classes + prediction[valid].clamp(0, n_classes - 1)
    return torch.bincount(idx, minlength=n_classes * n_classes).reshape(
        n_classes, n_classes)
