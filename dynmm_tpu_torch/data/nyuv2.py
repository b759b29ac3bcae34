"""NYU Depth V2 RGB-D segmentation data (a copy of the numpy parts of
``dynmm_tpu/data/nyuv2.py``, which the port does not import), and
``make_recipe_eval_batch``, the port's twin of
``bench.py::make_recipe_eval_batch``.

``NYUv2Dataset`` reads the ESANet-prepared layout the reference consumes
(``FusionDynMM/src/datasets/nyuv2/pytorch_dataset.py``): per split
``{split}/rgb/*.png`` (H,W,3 uint8), ``{split}/depth/*.png`` (uint16 mm;
``depth_raw`` for raw mode) and ``{split}/labels_40/*.png`` (uint8,
0=void), with ``{split}.txt`` listing sample ids. PNGs are decoded by
``data/png.py`` (the JAX package uses cv2).

NYUv2 constants as the reference has them: refined-depth train statistics
mean 2841.94941 / std 1417.25943 mm, one camera 'kv1', 40 classes plus
void; the palettes of ``class_colors``.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from dynmm_tpu_torch.data import png

DEPTH_MEAN = 2841.94941272766
DEPTH_STD = 1417.2594281672277
N_CLASSES = 40  # without void
CAMERAS = ("kv1",)

CLASS_NAMES_40 = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower curtain", "box", "whiteboard", "person", "night stand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop",
]


# Fixed 13-class palette published with the dataset tooling the reference
# vendors (FusionDynMM/src/datasets/nyuv2/nyuv2.py:312-326).
CLASS_COLORS_13 = np.array(
    [
        [0, 0, 0], [0, 0, 255], [232, 88, 47], [0, 217, 0], [148, 0, 240],
        [222, 241, 23], [255, 205, 205], [0, 223, 228], [106, 135, 204],
        [116, 28, 41], [240, 35, 235], [0, 166, 156], [249, 139, 0],
        [225, 228, 194],
    ],
    dtype=np.uint8,
)


def voc_colormap(n: int) -> np.ndarray:
    """Standard PASCAL-VOC bit-interleaved colormap ((n,3) uint8).

    Color i spreads i's bits across the high bits of r/g/b (bit 3k of i →
    bit 7-k of r, 3k+1 → g, 3k+2 → b). This is the palette the reference's
    40/894-class colored label maps use
    (``nyuv2/nyuv2.py:8-24`` → ``CLASS_COLORS_40``, :327).
    """
    idx = np.arange(n, dtype=np.uint32)
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for j in range(8):
        for ch in range(3):
            bit = (idx >> (3 * j + ch)) & 1
            cmap[:, ch] |= (bit << (7 - j)).astype(np.uint8)
    return cmap


def class_colors(n: int = N_CLASSES + 1, seed: int = 1) -> np.ndarray:
    """Visualization palette ((n,3) uint8; index 0 = void/black): the fixed
    13-class list for n=14, the VOC colormap otherwise (reference
    CLASS_COLORS_40/894). ``seed`` is kept for the JAX package's signature
    and ignored (the palette is deterministic)."""
    del seed
    if n == len(CLASS_COLORS_13):
        return CLASS_COLORS_13.copy()
    return voc_colormap(n)


class NYUv2Dataset:
    """Map-style access to the prepared on-disk dataset.

    Multi-camera datasets (SUNRGBD) can ship an optional
    ``{split}_cameras.txt`` (one camera name per sample line); the
    ``filter_camera`` context manager then narrows the dataset to one
    camera's samples — the reference's per-camera validation protocol
    (``dataset_base.py:20-29``, ``train.py:402-409``). Without the file every
    sample belongs to the first camera.
    """

    def __init__(self, root: str, split: str = "train",
                 depth_mode: str = "refined"):
        assert split in ("train", "test")
        assert depth_mode in ("refined", "raw")
        self.root = root
        self.split = split
        self.depth_mode = depth_mode
        self.cameras = CAMERAS
        self.n_classes_without_void = N_CLASSES
        with open(os.path.join(root, f"{split}.txt")) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self._all_ids = list(self.ids)
        cam_file = os.path.join(root, f"{split}_cameras.txt")
        if os.path.exists(cam_file):
            with open(cam_file) as f:
                self.sample_cameras = [l.strip() for l in f if l.strip()]
            assert len(self.sample_cameras) == len(self.ids)
        else:
            self.sample_cameras = None

    @contextlib.contextmanager
    def filter_camera(self, camera: str):
        """Context manager narrowing the dataset to one camera's samples."""
        saved = self.ids
        if self.sample_cameras is not None:
            self.ids = [i for i, cam in zip(self._all_ids, self.sample_cameras)
                        if cam == camera]
        try:
            yield self
        finally:
            self.ids = saved

    def __len__(self) -> int:
        return len(self.ids)

    def _png(self, kind: str, idx: int) -> np.ndarray:
        return png.read(os.path.join(self.root, self.split, kind,
                                     f"{self.ids[idx]}.png"))

    def load_image(self, idx: int) -> np.ndarray:
        return self._png("rgb", idx)

    def load_depth(self, idx: int) -> np.ndarray:
        return self._png("depth" if self.depth_mode == "refined"
                         else "depth_raw", idx)

    def load_label(self, idx: int) -> np.ndarray:
        return self._png("labels_40", idx)

    def __getitem__(self, idx: int) -> dict:
        return {
            "image": self.load_image(idx),
            "depth": self.load_depth(idx).astype(np.float32),
            "label": self.load_label(idx),
        }

    @property
    def depth_mean(self) -> float:
        return DEPTH_MEAN

    @property
    def depth_std(self) -> float:
        return DEPTH_STD


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
