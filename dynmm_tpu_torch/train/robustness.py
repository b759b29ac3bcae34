"""Noise-robustness evaluation for the modality-level models (a copy of
``dynmm_tpu/train/robustness.py``, numpy only, on the port's own
``ArrayLoader``: the same seed gives the same noisy inputs).

Equivalent of the MultiBench robustness sweep the reference reaches through
``test(no_robust=False)`` (``Supervised_Learning.py:388-408``): evaluate on a
series of increasingly-noisy test loaders per modality, collect the metric
curve, and summarize with relative/effective robustness. (The FusionDynMM
image-noise sweep lives in ``eval.py`` / ``SegTrainer.validate`` instead.)

Noise model: additive Gaussian scaled per level, applied to the chosen
modality's features (MultiBench's feature-noise protocol for IMDB/MOSEI).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from dynmm_tpu_torch.data.loader import ArrayLoader


def noisy_loader(
    loader: ArrayLoader, noise_level: float, modalities: Sequence[int], seed: int = 0
) -> ArrayLoader:
    """Copy of ``loader`` with Gaussian noise of std
    ``noise_level * mean(|x|)`` (the reference's amplitude convention,
    eval.py:94) added to the selected modality streams."""
    rng = np.random.default_rng(seed)
    inputs = []
    for i, x in enumerate(loader.inputs):
        if i in modalities and noise_level > 0:
            scale = noise_level * np.abs(x).mean()
            x = x + scale * rng.standard_normal(x.shape).astype(x.dtype)
        inputs.append(x)
    return ArrayLoader(
        inputs,
        loader.label,
        lengths=loader.lengths,
        batch_size=loader.batch_size,
        shuffle=False,
        pad_tail=loader.pad_tail,
    )


def robustness_sweep(
    evaluate_fn,
    base_loader: ArrayLoader,
    noisy_modalities: dict[str, Sequence[int]],
    noise_levels: Sequence[float] = (0.0, 0.1, 0.2, 0.3, 0.5, 1.0),
    seed: int = 0,
) -> dict[str, dict[str, list[float]]]:
    """For each named modality group, evaluate across noise levels.

    ``evaluate_fn(loader) -> {metric: value}``. Returns
    ``{group: {metric: [values per level]}}``.
    """
    curves: dict[str, dict[str, list[float]]] = {}
    for name, mods in noisy_modalities.items():
        curve: dict[str, list[float]] = {}
        for level in noise_levels:
            metrics = evaluate_fn(noisy_loader(base_loader, level, mods, seed))
            for k, v in metrics.items():
                if isinstance(v, (int, float, np.floating)):
                    curve.setdefault(k, []).append(float(v))
        curves[name] = curve
    return curves


def relative_robustness(curve: Sequence[float]) -> float:
    """Area under the noise-metric curve normalized by clean performance —
    1.0 means fully robust, → 0 means immediate collapse."""
    curve = np.asarray(curve, dtype=np.float64)
    if curve.size == 0 or curve[0] == 0:
        return 0.0
    return float(curve.mean() / curve[0])


def effective_robustness(
    curve: Sequence[float], baseline_curve: Sequence[float]
) -> float:
    """Mean advantage over a baseline method's curve at matched noise levels
    (positive = more robust than the baseline)."""
    c = np.asarray(curve, dtype=np.float64)
    b = np.asarray(baseline_curve, dtype=np.float64)
    n = min(len(c), len(b))
    if n == 0:
        return 0.0
    return float((c[:n] - b[:n]).mean())
