#!/usr/bin/env python
"""Offline Cityscapes conversion → the prepared layout of
``CityscapesDataset`` (port of ``dynmm_tpu/data/prepare_cityscapes.py``:
PNGs read and written by ``data/png.py``, as the port imports no OpenCV;
the written files hold the same arrays).

Mirrors the semantics of the reference converter
(``FusionDynMM/src/datasets/cityscapes/prepare_dataset.py``): walk the raw
download (``leftImg8bit``, ``disparity``, ``camera``, ``gtFine``), copy rgb
and raw disparity, derive metric depth from disparity with each sample's
camera parameters (``depth = baseline·fx / ((disp−1)/256)``, zeros masked;
float16 .npy), and map the 1+33-class ``labelIds`` ground truth to the
1+19-class train set. 'val' is renamed 'valid' like the reference.

Emits ``{split}/{rgb,disparity_raw,labels_19,labels_33}/{id}.png`` +
``{split}/depth_raw/{id}.npy`` + ``{split}.txt``.

The 33→19 mapping embeds the standard cityscapesscripts trainId table
(reference: ``cityscapes.py:24-27`` derives it from
``cityscapesscripts.helpers.labels``; ignoreInEval classes → 0, others →
trainId+1).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from dynmm_tpu_torch.data import png

SPLITS = ("train", "valid", "test")

# label id (0..33) -> reduced class (0 void, 1..19); cityscapesscripts trainIds
CLASS_MAPPING_REDUCED = np.zeros(34, dtype=np.uint8)
for _lid, _tid in {
    7: 1, 8: 2, 11: 3, 12: 4, 13: 5, 17: 6, 19: 7, 20: 8, 21: 9, 22: 10,
    23: 11, 24: 12, 25: 13, 26: 14, 27: 15, 28: 16, 31: 17, 32: 18, 33: 19,
}.items():
    CLASS_MAPPING_REDUCED[_lid] = _tid


def _samples(root: str, subdir: str, ext: str):
    """{basename: path} over <root>/<subdir>/<split>/<city>/*, basename =
    first three '_'-joined tokens (city_seq_frame)."""
    out = {}
    for path in sorted(
        glob.glob(os.path.join(root, subdir, "*", "*", f"*{ext}"))
    ):
        base = "_".join(os.path.basename(path).split("_")[:3])
        split = os.path.basename(os.path.dirname(os.path.dirname(path)))
        out[(split, base)] = path
    return out


def disparity_to_depth(disp: np.ndarray, baseline: float, fx: float):
    """Raw 16-bit disparity png → metric depth (float32, 0 where invalid)."""
    depth = disp.astype(np.float32)
    mask = disp > 0
    depth[mask] = (depth[mask] - 1.0) / 256.0
    mask = depth > 0
    depth[mask] = (baseline * fx) / depth[mask]
    depth[~mask] = 0.0
    return depth


def convert(output_dir: str, cityscapes_dir: str) -> None:
    rgbs = _samples(cityscapes_dir, "leftImg8bit", ".png")
    disps = _samples(cityscapes_dir, "disparity", ".png")
    params = _samples(cityscapes_dir, "camera", ".json")
    labels = {
        k: p
        for k, p in _samples(cityscapes_dir, "gtFine", ".png").items()
        if "labelIds" in os.path.basename(p)
    }
    assert rgbs.keys() == disps.keys() == params.keys() == labels.keys(), (
        "inconsistent raw layout"
    )

    names: dict[str, list[str]] = {s: [] for s in SPLITS}
    for (split_raw, base), rgb_fp in rgbs.items():
        split = "valid" if split_raw == "val" else split_raw
        for sub in ("rgb", "disparity_raw", "depth_raw", "labels_19",
                    "labels_33"):
            os.makedirs(os.path.join(output_dir, split, sub), exist_ok=True)

        rgb = png.read(rgb_fp)
        png.write(os.path.join(output_dir, split, "rgb", f"{base}.png"), rgb)

        disp = png.read(disps[(split_raw, base)])
        png.write(
            os.path.join(output_dir, split, "disparity_raw", f"{base}.png"),
            disp.astype(np.uint16),
        )
        with open(params[(split_raw, base)]) as f:
            cam = json.load(f)
        depth = disparity_to_depth(
            disp, cam["extrinsic"]["baseline"], cam["intrinsic"]["fx"]
        )
        np.save(
            os.path.join(output_dir, split, "depth_raw", f"{base}.npy"),
            depth.astype(np.float16),
        )

        label_full = png.read(labels[(split_raw, base)])
        png.write(
            os.path.join(output_dir, split, "labels_33", f"{base}.png"),
            label_full.astype(np.uint8),
        )
        png.write(
            os.path.join(output_dir, split, "labels_19", f"{base}.png"),
            CLASS_MAPPING_REDUCED[label_full.astype(np.int32)],
        )
        names[split].append(base)

    for split in SPLITS:
        if names[split]:
            with open(os.path.join(output_dir, f"{split}.txt"), "w") as f:
                f.write("\n".join(sorted(names[split])) + "\n")
            print(f"{split}: {len(names[split])} samples")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("output_dir")
    ap.add_argument("cityscapes_dir",
                    help="raw download root (leftImg8bit/disparity/camera/gtFine)")
    args = ap.parse_args()
    convert(args.output_dir, args.cityscapes_dir)


if __name__ == "__main__":
    main()
