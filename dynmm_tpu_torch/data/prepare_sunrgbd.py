#!/usr/bin/env python
"""Offline SUNRGBD conversion → the prepared png layout of ``SUNRGBDDataset``
(port of ``dynmm_tpu/data/prepare_sunrgbd.py``: images decoded by
``data/jpeg.py``, PNGs read and written by ``data/png.py`` and the MATLAB
v7.3 segmentation read by ``data/hdf5.py``, as the port imports no
OpenCV and the card's machine has no h5py; the written files hold the same
arrays).

Mirrors the semantics of the reference converter
(``FusionDynMM/src/datasets/sunrgbd/prepare_dataset.py``): walk
``SUNRGBDMeta.mat`` (one struct per sample with rgbpath/rgbname/depthname),
pull each sample's segmentation from ``SUNRGBD2Dseg.mat`` (h5 references,
transposed, uint8 0..37), split train/test by whether the sample directory is
listed in ``allsplit.mat``'s ``alltrain``, and use ``depth_bfx`` as refined
depth / ``depth`` as raw depth.

Where the reference emits file-list txts pointing into the extracted SUNRGBD
tree, this emits the SAME normalized layout every dataset here uses
(``{split}/{rgb,depth,depth_raw,labels_37}/{id}.png`` + ``{split}.txt`` +
``{split}_cameras.txt``), so one reader serves all datasets; the camera of
each sample (kv1/kv2/realsense/xtion — the reference's per-camera eval
protocol) is the leading component of its directory path.

Downloads are NOT attempted (the reference pulls SUNRGBD.zip/
SUNRGBDtoolbox.zip from rgbd.cs.princeton.edu); point --toolbox-dir and
--data-dir at the extracted trees.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dynmm_tpu_torch.data import hdf5, jpeg, png

CAMERAS = ("realsense", "kv2", "kv1", "xtion")


def _camera_of(real_dir: str) -> str:
    head = real_dir.split("/")[0]
    return head if head in CAMERAS else "kv1"


def convert(output_dir: str, toolbox_dir: str, data_dir: str) -> None:
    from scipy.io import loadmat

    meta = loadmat(
        os.path.join(toolbox_dir, "Metadata", "SUNRGBDMeta.mat"),
        squeeze_me=True, struct_as_record=False,
    )["SUNRGBDMeta"]
    split = loadmat(
        os.path.join(toolbox_dir, "traintestSUNRGBD", "allsplit.mat"),
        squeeze_me=True, struct_as_record=False,
    )
    alltrain = set(np.atleast_1d(split["alltrain"]).tolist())

    with hdf5.File(
        os.path.join(toolbox_dir, "Metadata", "SUNRGBD2Dseg.mat")
    ) as seg:
        names, cams = _convert_samples(output_dir, data_dir, meta, alltrain,
                                       seg)

    for s in ("train", "test"):
        with open(os.path.join(output_dir, f"{s}.txt"), "w") as f:
            f.write("\n".join(names[s]) + "\n")
        with open(os.path.join(output_dir, f"{s}_cameras.txt"), "w") as f:
            f.write("\n".join(cams[s]) + "\n")
        print(f"{s}: {len(names[s])} samples")


def _read(path: str, jpg: bool):
    """The image at ``path`` as ``cv2.imread(path, IMREAD_UNCHANGED)``
    gives it (colour in RGB order), None for a missing file."""
    if not os.path.exists(path):
        return None
    return jpeg.read(path, color=False) if jpg else png.read(path)


def _convert_samples(output_dir, data_dir, meta, alltrain, seg):
    seglabel = seg["SUNRGBD2Dseg"]["seglabel"]
    for s in ("train", "test"):
        for sub in ("rgb", "depth", "depth_raw", "labels_37"):
            os.makedirs(os.path.join(output_dir, s, sub), exist_ok=True)
    names = {"train": [], "test": []}
    cams = {"train": [], "test": []}

    for i, m in enumerate(np.atleast_1d(meta)):
        meta_dir = "/".join(m.rgbpath.split("/")[:-2])
        real_dir = meta_dir.split("/n/fs/sun3d/data/SUNRGBD/")[-1]
        sample_dir = os.path.join(data_dir, real_dir)
        s = "train" if meta_dir in alltrain else "test"
        name = f"{i:05d}"

        rgb = _read(os.path.join(sample_dir, "image", m.rgbname), jpg=True)
        depth = _read(os.path.join(sample_dir, "depth_bfx", m.depthname),
                      jpg=False)
        if rgb is None or depth is None:
            raise FileNotFoundError(sample_dir)
        png.write(os.path.join(output_dir, s, "rgb", f"{name}.png"), rgb)
        png.write(
            os.path.join(output_dir, s, "depth", f"{name}.png"),
            depth.astype(np.uint16),
        )
        raw = _read(os.path.join(sample_dir, "depth", m.depthname), jpg=False)
        if raw is not None:
            png.write(
                os.path.join(output_dir, s, "depth_raw", f"{name}.png"),
                raw.astype(np.uint16),
            )
        label = np.asarray(seg[seglabel[i][0]][:]).transpose(1, 0)
        png.write(
            os.path.join(output_dir, s, "labels_37", f"{name}.png"),
            label.astype(np.uint8),
        )
        names[s].append(name)
        cams[s].append(_camera_of(real_dir))
    return names, cams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("output_dir")
    ap.add_argument("--toolbox-dir", required=True,
                    help="extracted SUNRGBDtoolbox directory")
    ap.add_argument("--data-dir", required=True,
                    help="extracted SUNRGBD data directory")
    args = ap.parse_args()
    convert(args.output_dir, args.toolbox_dir, args.data_dir)


if __name__ == "__main__":
    main()
