"""Secondary RGB-D segmentation datasets: SUNRGBD, Cityscapes, SceneNetRGBD
(a copy of ``dynmm_tpu/data/other_datasets.py``, which the port does not
import; PNGs through ``data/png.py`` in place of cv2).

The reference wires these alongside NYUv2 (``src/datasets/{sunrgbd,
cityscapes,scenenetrgbd}/``). Constants mirrored from the reference:

* SUNRGBD (``sunrgbd/pytorch_dataset.py``): 37 classes + void, cameras
  realsense/kv2/kv1/xtion, refined-depth mean 19025.149 / std 9880.916
  (raw: 18320.349 / 8898.659).
* Cityscapes (``cityscapes/pytorch_dataset.py``): 19 (reduced) or 33 (full)
  classes + void, one dummy camera, raw disparity mean 9069.706 / std
  7178.336 (disparity-meters mode 31.716 / 38.703).
* SceneNetRGBD (``scenenetrgbd/``): 13 classes + void, the synthetic
  pretraining corpus, read from the prepared-png layout like the others.

All three read the prepared png directory layout of ``NYUv2Dataset``
(``{split}/rgb|depth|labels_N/*.png`` + ``{split}.txt``).
"""

from __future__ import annotations

import os

import numpy as np

from dynmm_tpu_torch.data.nyuv2 import NYUv2Dataset


class _PreparedRGBDDataset(NYUv2Dataset):
    """Shared prepared-layout reader with per-dataset constants."""

    N_CLASSES: int = 0
    CAMERAS: tuple = ("camera1",)
    DEPTH_STATS: dict = {}
    LABEL_DIR: str = "labels"

    def __init__(self, root: str, split: str = "train",
                 depth_mode: str = "refined"):
        super().__init__(root, split=split, depth_mode=depth_mode)
        self.cameras = self.CAMERAS
        self.n_classes_without_void = self.N_CLASSES

    def load_label(self, idx: int) -> np.ndarray:
        return self._png(self.LABEL_DIR, idx)

    @property
    def depth_mean(self) -> float:
        return self.DEPTH_STATS[self.depth_mode][0]

    @property
    def depth_std(self) -> float:
        return self.DEPTH_STATS[self.depth_mode][1]


class SUNRGBDDataset(_PreparedRGBDDataset):
    N_CLASSES = 37
    CAMERAS = ("realsense", "kv2", "kv1", "xtion")
    DEPTH_STATS = {
        "refined": (19025.14930492213, 9880.916071806689),
        "raw": (18320.348967710495, 8898.658819551309),
    }
    LABEL_DIR = "labels_37"


class CityscapesDataset(_PreparedRGBDDataset):
    N_CLASSES = 19  # reduced label set; 33 = full
    CAMERAS = ("camera1",)
    DEPTH_STATS = {
        "refined": (31.715617493177906, 38.70280704877372),  # depth, meters
        "raw": (9069.706336834102, 7178.335960071306),       # raw disparity
    }
    LABEL_DIR = "labels_19"

    def __init__(self, root, split="train", depth_mode="raw", n_classes=19):
        assert n_classes in (19, 33)
        self.N_CLASSES = n_classes
        self.LABEL_DIR = f"labels_{n_classes}"
        super().__init__(root, split=split, depth_mode=depth_mode)

    def load_depth(self, idx: int) -> np.ndarray:
        """'raw' = 16-bit disparity png; 'refined' = metric float16 .npy
        derived by the reference's converter (disparity→depth with
        per-sample camera parameters)."""
        if self.depth_mode == "raw":
            return self._png("disparity_raw", idx)
        path = os.path.join(self.root, self.split, "depth_raw",
                            f"{self.ids[idx]}.npy")
        return np.load(path).astype(np.float32)


class SceneNetRGBDDataset(_PreparedRGBDDataset):
    N_CLASSES = 13
    CAMERAS = ("camera1",)
    DEPTH_STATS = {"refined": (4006.9281155769777, 2459.7763971709933),
                   "raw": (4006.9281155769777, 2459.7763971709933)}
    LABEL_DIR = "labels_13"


DATASETS = {
    "sunrgbd": SUNRGBDDataset,
    "cityscapes": CityscapesDataset,
    "cityscapes-with-depth": CityscapesDataset,
    "scenenetrgbd": SceneNetRGBDDataset,
}
