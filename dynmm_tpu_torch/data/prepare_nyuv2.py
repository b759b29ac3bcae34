#!/usr/bin/env python
"""Offline NYUv2 conversion: ``nyu_depth_v2_labeled.mat`` (+ ``splits.mat``,
``classMapping40.mat``) → the prepared png directory layout consumed by
``NYUv2Dataset``.

Mirrors the semantics of the reference converter
(``FusionDynMM/src/datasets/nyuv2/prepare_dataset.py:105-284``): transpose the
mat's (C, W, H) image layout to (H, W, C); depth meters → millimeters uint16;
894-class labels mapped to 40 via ``classMapping40.mat``'s ``mapClass`` (with
0 kept as void); train/test split indices from ``splits.mat`` (1-based).

Port of ``dynmm_tpu/data/prepare_nyuv2.py``: the MATLAB v7.3 file is read
by ``data/hdf5.py`` one sample at a time (the JAX converter loads it whole,
~2.8 GB) and the PNGs are written by ``data/png.py``, as the card's machine
has no h5py and the port imports no OpenCV; the written files hold the
same arrays.

Usage:
    python -m dynmm_tpu_torch.data.prepare_nyuv2 <output_dir> \
        --mat nyu_depth_v2_labeled.mat --splits splits.mat \
        --class-mapping classMapping40.mat
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dynmm_tpu_torch.data import hdf5, png

# 40 → 13 class mapping (index 0 = void), the contents of
# ``class13Mapping.mat``'s ``classMapping13`` used by the reference at
# ``nyuv2/prepare_dataset.py:160-161`` (upstream:
# github.com/VainF/nyuv2-python-toolkit class13Mapping.mat). Embedded so the
# converter needs no extra download; ``--class13-mapping`` overrides from the
# .mat when provided.
MAP_40_TO_13 = np.array(
    [0, 12, 5, 6, 1, 4, 9, 10, 12, 13, 6, 8, 6, 13, 10, 6, 13, 6, 7, 7, 5,
     7, 3, 2, 6, 11, 7, 7, 7, 7, 7, 7, 6, 7, 7, 7, 7, 7, 7, 6, 7],
    dtype=np.uint8,
)

CLASS_NAMES_13 = (
    "bed", "books", "ceiling", "chair", "floor", "furniture", "objects",
    "picture", "sofa", "table", "tv", "wall", "window",
)


def convert(output_dir: str, mat_path: str, splits_path: str,
            mapping_path: str, mapping13_path: str | None = None) -> None:
    from scipy.io import loadmat

    splits = loadmat(splits_path)
    train_ids = splits["trainNdxs"][:, 0] - 1
    test_ids = splits["testNdxs"][:, 0] - 1

    mapping = loadmat(mapping_path)
    map_894_to_40 = np.concatenate([[0], mapping["mapClass"][0]]).astype(np.uint8)
    map_40_to_13 = MAP_40_TO_13
    if mapping13_path:
        m13 = loadmat(mapping13_path)["classMapping13"][0][0]
        map_40_to_13 = np.concatenate([[0], m13[0][0]]).astype(np.uint8)

    with hdf5.File(mat_path) as f:
        images = f["images"]      # (N, 3, W, H)
        depths = f["depths"]      # (N, W, H) meters
        labels = f["labels"]      # (N, W, H) 0..894
        raw_depths = f["rawDepths"] if "rawDepths" in f else None
        for split, ids in (("train", train_ids), ("test", test_ids)):
            for sub in ("rgb", "depth", "depth_raw", "labels_40",
                        "labels_13"):
                os.makedirs(os.path.join(output_dir, split, sub),
                            exist_ok=True)
            names = []
            for i in ids:
                name = f"{i:04d}"
                names.append(name)
                out = lambda sub: os.path.join(output_dir, split, sub,
                                               f"{name}.png")
                rgb = np.transpose(images[i], (2, 1, 0))  # HWC
                png.write(out("rgb"), rgb)
                depth_mm = (np.transpose(depths[i], (1, 0))
                            * 1000.0).astype(np.uint16)
                png.write(out("depth"), depth_mm)
                if raw_depths is not None:
                    raw_mm = (np.transpose(raw_depths[i], (1, 0))
                              * 1000.0).astype(np.uint16)
                    png.write(out("depth_raw"), raw_mm)
                label_894 = np.transpose(labels[i], (1, 0)).astype(np.int32)
                label_40 = map_894_to_40[label_894]
                png.write(out("labels_40"), label_40)
                png.write(out("labels_13"), map_40_to_13[label_40])
            with open(os.path.join(output_dir, f"{split}.txt"), "w") as fh:
                fh.write("\n".join(names) + "\n")
            print(f"{split}: {len(names)} samples")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("output_dir")
    ap.add_argument("--mat", default="nyu_depth_v2_labeled.mat")
    ap.add_argument("--splits", default="splits.mat")
    ap.add_argument("--class-mapping", default="classMapping40.mat")
    ap.add_argument("--class13-mapping", default=None,
                    help="optional class13Mapping.mat (embedded table otherwise)")
    args = ap.parse_args()
    convert(args.output_dir, args.mat, args.splits, args.class_mapping,
            args.class13_mapping)


if __name__ == "__main__":
    main()
