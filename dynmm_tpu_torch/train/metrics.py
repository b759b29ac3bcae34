"""Evaluation metrics (port of ``dynmm_tpu/train/metrics.py``).

The supervised metrics (multilabel f1 micro/macro, accuracy, Pearson
correlation, the posneg accuracy and correlation, AUPRC) and
``ConfusionMatrix`` are numpy copies of the JAX package's;
``confusion_update_counts`` is the matrix's device increment, in PyTorch.

Same math as the reference's ignite-based matrix:
``iou = diag / (row + col − diag)``, mIoU over the classes present.
"""

from __future__ import annotations

import numpy as np
import torch


# --------------------------------------------------------------- f1 / accuracy
def binary_f1_counts(true: np.ndarray, pred: np.ndarray):
    """Per-class tp/fp/fn for multi-hot arrays of shape (N, C)."""
    true = np.asarray(true).astype(bool)
    pred = np.asarray(pred).astype(bool)
    tp = (true & pred).sum(axis=0).astype(np.float64)
    fp = (~true & pred).sum(axis=0).astype(np.float64)
    fn = (true & ~pred).sum(axis=0).astype(np.float64)
    return tp, fp, fn


def f1_score(true: np.ndarray, pred: np.ndarray, average: str = "micro") -> float:
    """Multilabel F1 over (N, C) multi-hot arrays (sklearn-compatible).

    macro: per-class F1 averaged (classes with no support count as 0).
    micro: global counts.
    """
    tp, fp, fn = binary_f1_counts(true, pred)
    if average == "micro":
        denom = 2 * tp.sum() + fp.sum() + fn.sum()
        return float(2 * tp.sum() / denom) if denom > 0 else 0.0
    denom = 2 * tp + fp + fn
    per_class = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)
    return float(per_class.mean())


def accuracy(true: np.ndarray, pred: np.ndarray) -> float:
    true = np.asarray(true).reshape(-1)
    pred = np.asarray(pred).reshape(-1)
    return float((true == pred).mean())


def pearson_corr(x: np.ndarray, y: np.ndarray) -> float:
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    xc, yc = x - x.mean(), y - y.mean()
    denom = np.sqrt((xc**2).sum() * (yc**2).sum())
    return float((xc * yc).sum() / denom) if denom > 0 else 0.0


def posneg_accuracy_corr(true_values: np.ndarray, pred_values: np.ndarray):
    """The reference's posneg-classification eval
    (Supervised_Learning.py:298-306, 337-347): sign of the scalar output vs
    sign of the label → accuracy + Pearson corr of binarized labels against
    binarized predictions."""
    pred_bin = (np.asarray(pred_values).reshape(-1) >= 0).astype(np.int64)
    true_bin = (np.asarray(true_values).reshape(-1) >= 0).astype(np.int64)
    return accuracy(true_bin, pred_bin), pearson_corr(true_bin, pred_bin)


def auprc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the precision-recall curve for binary labels
    (average-precision formulation — the reference's MultiBench ``AUPRC``
    over (positive-class score, label) pairs)."""
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1).astype(np.int64)
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    tp = np.cumsum(labels)
    n_pos = labels.sum()
    if n_pos == 0:
        return 0.0
    precision = tp / np.arange(1, len(labels) + 1)
    # average precision: mean of precision at each positive hit
    return float((precision * labels).sum() / n_pos)


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
