"""Synthetic RGB-D segmentation data and the NYUv2 constants (a copy of
the numpy parts of ``dynmm_tpu/data/nyuv2.py``, which the port does not
import), and ``make_recipe_eval_batch``, the port's twin of
``bench.py::make_recipe_eval_batch``.

NYUv2 constants as the reference has them: refined-depth train statistics
mean 2841.94941 / std 1417.25943 mm, one camera 'kv1', 40 classes plus void.
The on-disk ``NYUv2Dataset`` is not ported yet.
"""

from __future__ import annotations

import numpy as np

DEPTH_MEAN = 2841.94941272766
DEPTH_STD = 1417.2594281672277
N_CLASSES = 40  # without void
CAMERAS = ("kv1",)


class SyntheticSegDataset:
    """Shape-compatible synthetic RGB-D segmentation data for tests/benchmarks:
    piecewise-constant label regions with modality-correlated appearance.

    ``mixed_modality_frac`` > 0 makes routing *input-dependent* (the regime
    the reference's gate is trained for on real NYUv2): that fraction of
    samples (deterministic per index) are "depth-needed" — their RGB is
    rendered from a coarsened label map (class pairs share appearance) while
    depth stays fully class-informative — and the complementary samples are
    "rgb-sufficient", with informative RGB and near-flat depth. A resource-
    penalized gate then has a real signal to skip the depth encoder only on
    rgb-sufficient inputs. Default 0.0 keeps the original generation
    bit-for-bit (both modalities informative on every sample)."""

    def __init__(
        self,
        n: int = 16,
        height: int = 480,
        width: int = 640,
        n_classes: int = N_CLASSES,
        seed: int = 0,
        split: str = "train",
        mixed_modality_frac: float = 0.0,
    ):
        self.n = n
        self.h, self.w = height, width
        self.n_classes_without_void = n_classes
        self.cameras = CAMERAS
        self.split = split
        self.depth_mean = DEPTH_MEAN
        self.depth_std = DEPTH_STD
        self._seed = seed
        self._mixed_frac = float(mixed_modality_frac)

    def __len__(self) -> int:
        return self.n

    def depth_needed(self, idx: int) -> bool:
        """Whether sample ``idx`` is of the depth-needed kind (same draw
        __getitem__ makes) — lets callers compose batches with an exact
        easy/hard mix."""
        if self._mixed_frac <= 0.0:
            return False
        rng = np.random.default_rng(self._seed * 100003 + idx)
        rng.integers(1, self.n_classes_without_void + 1, size=(8, 8))
        return bool(rng.random() < self._mixed_frac)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self._seed * 100003 + idx)
        # blocky label map (plus some void at the border)
        gh, gw = 8, 8
        grid = rng.integers(1, self.n_classes_without_void + 1, size=(gh, gw))
        label = np.kron(
            grid, np.ones((self.h // gh, self.w // gw), dtype=np.int64)
        ).astype(np.uint8)
        label[:4] = 0  # void strip
        # only draw when enabled so the default stream is unchanged
        depth_needed = (
            self._mixed_frac > 0.0 and rng.random() < self._mixed_frac
        )
        if depth_needed:
            # class pairs (1,2), (3,4), ... share RGB appearance; only depth
            # separates them
            rgb_label = ((label.astype(np.int64) - 1) // 2 * 2 + 1).clip(0)
            rgb_label[label == 0] = 0
        else:
            rgb_label = label.astype(np.int64)
        image = (
            (rgb_label[..., None].astype(np.float32) * 5.3) % 255
            + rng.normal(0, 12, size=(self.h, self.w, 3))
        ).clip(0, 255).astype(np.uint8)
        if self._mixed_frac > 0.0 and not depth_needed:
            # rgb-sufficient sample: depth carries (almost) no class signal
            depth = (
                2800.0 + rng.normal(0, 30, size=(self.h, self.w))
            ).clip(100, 9000).astype(np.float32)
        else:
            depth = (
                label.astype(np.float32) * 80.0
                + 1500.0
                + rng.normal(0, 30, size=(self.h, self.w))
            ).clip(100, 9000).astype(np.float32)
        return {"image": image, "depth": depth, "label": label}


def make_recipe_eval_batch(bs: int, h: int, w: int, seed: int = 7,
                           mixed_frac: float = 0.5):
    """Preprocessed synthetic eval batch with an exact half depth-needed /
    half rgb-sufficient composition, the distribution the recipe gate was
    trained on. Returns (rgb (bs, h, w, 3), depth (bs, h, w, 1)) float32."""
    from dynmm_tpu_torch.data.seg_preprocessing import SegPreprocessor

    ds = SyntheticSegDataset(n=1 << 30, height=h, width=w, seed=seed,
                             split="test", mixed_modality_frac=mixed_frac)
    pre = SegPreprocessor(ds.depth_mean, ds.depth_std, h, w, phase="test")
    want_hard = bs // 2
    idxs, n_hard, i = [], 0, 0
    while len(idxs) < bs:
        hard = ds.depth_needed(i)
        if hard and n_hard < want_hard:
            idxs.append(i)
            n_hard += 1
        elif not hard and len(idxs) - n_hard < bs - want_hard:
            idxs.append(i)
        i += 1
    rng = np.random.default_rng(0)  # test phase: rng unused by transforms
    samples = [pre(ds[j], rng) for j in idxs]
    rgb = np.stack([s["image"] for s in samples]).astype(np.float32)
    depth = np.stack([s["depth"] for s in samples]).astype(np.float32)
    return rgb, depth
