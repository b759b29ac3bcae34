"""Raw dataset trees built from ``tests/fixtures_torch_prepare/`` for the
converters of both packages (``data/prepare_*.py``), and the outputs
their JAX converters wrote there (``expected.npz`` in each dataset's
folder).

This module imports numpy, scipy and the standard library only: ``chip_smoke.py``
builds the same trees on a machine without h5py, OpenCV or JAX. The
fixtures themselves (HDF5 ``.mat`` files, JPEGs, PNGs, protobuf) are written
by ``tests/_make_torch_prepare_fixtures.py``; the version 5 ``.mat`` files,
which ``scipy.io.savemat`` writes anywhere, are written here.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parent / "fixtures_torch_prepare"

# NYUv2: two samples at NYUv2's 640x480, sample 1 in train, sample 2 in test
NYU_SPLITS = {"trainNdxs": np.array([[1]]), "testNdxs": np.array([[2]])}
NYU_MAP_CLASS = (np.arange(894) % 40 + 1).astype(np.uint16)[None, :]

# SUN RGB-D: one sample a camera, the first two in train
SUN_SAMPLES = (("kv1", "img.jpg"), ("kv2", "img.jpg"), ("xtion", "img.jpg"),
               ("realsense", "img.jpg"))


def nyuv2(root: Path) -> dict:
    """The NYUv2 converter's inputs under ``root``: keyword arguments of
    ``convert`` besides the output directory."""
    from scipy.io import savemat

    root.mkdir(parents=True, exist_ok=True)
    mat = root / "nyu_depth_v2_labeled.mat"
    shutil.copyfile(FIXTURES / "nyuv2" / "nyu_depth_v2_labeled.mat", mat)
    savemat(root / "splits.mat", NYU_SPLITS)
    savemat(root / "classMapping40.mat", {"mapClass": NYU_MAP_CLASS})
    return {"mat_path": str(mat), "splits_path": str(root / "splits.mat"),
            "mapping_path": str(root / "classMapping40.mat")}


def sun_meta() -> list[tuple[str, str, str]]:
    """(rgbpath, rgbname, depthname) of each SUN RGB-D sample."""
    return [(f"/n/fs/sun3d/data/SUNRGBD/{cam}/set/sample{i:02d}/image/{name}",
             name, "d.png") for i, (cam, name) in enumerate(SUN_SAMPLES)]


def sunrgbd(root: Path) -> dict:
    """The SUN RGB-D converter's inputs under ``root``: the data tree (the
    fixture's JPEGs and depth PNGs) and the toolbox (the fixture's v7.3
    ``SUNRGBD2Dseg.mat``, the v5 ``SUNRGBDMeta.mat`` and ``allsplit.mat``
    written here)."""
    from scipy.io import savemat

    toolbox, data = root / "SUNRGBDtoolbox", root / "SUNRGBD"
    shutil.copytree(FIXTURES / "sunrgbd" / "SUNRGBD", data)
    (toolbox / "Metadata").mkdir(parents=True)
    (toolbox / "traintestSUNRGBD").mkdir()
    shutil.copyfile(FIXTURES / "sunrgbd" / "SUNRGBD2Dseg.mat",
                    toolbox / "Metadata" / "SUNRGBD2Dseg.mat")
    metas = sun_meta()
    meta = np.zeros((len(metas),), dtype=[("rgbpath", "O"), ("rgbname", "O"),
                                          ("depthname", "O")])
    for i, m in enumerate(metas):
        meta[i] = m
    savemat(toolbox / "Metadata" / "SUNRGBDMeta.mat", {"SUNRGBDMeta": meta})
    alltrain = np.array(["/".join(m[0].split("/")[:-2]) for m in metas[:2]],
                        dtype=object)
    savemat(toolbox / "traintestSUNRGBD" / "allsplit.mat",
            {"alltrain": alltrain})
    return {"toolbox_dir": str(toolbox), "data_dir": str(data)}


def cityscapes(root: Path) -> dict:
    """The Cityscapes converter's input: the fixture's raw tree, copied."""
    shutil.copytree(FIXTURES / "cityscapes" / "raw", root / "raw")
    return {"cityscapes_dir": str(root / "raw")}


def scenenet(root: Path) -> dict:
    """The SceneNet converter's input: the fixture's raw tree, copied."""
    shutil.copytree(FIXTURES / "scenenet" / "raw", root / "raw")
    return {"scenenet_dir": str(root / "raw"), "n_views_train": 2,
            "n_views_test": 2}


BUILDERS = {"nyuv2": nyuv2, "sunrgbd": sunrgbd, "cityscapes": cityscapes,
            "scenenet": scenenet}


def expected(kind: str) -> dict:
    """{path relative to the output directory: array, or the text of a
    ``.txt`` file as a 0-d str array} that the JAX converter wrote."""
    with np.load(FIXTURES / kind / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def written(out: Path, read_png) -> dict:
    """The files a converter wrote under ``out``, as ``expected`` holds
    them; ``read_png(path)`` gives a PNG's array (colour in RGB order)."""
    got = {}
    for p in sorted(out.rglob("*")):
        if not p.is_file():
            continue
        key = p.relative_to(out).as_posix()
        if p.suffix == ".png":
            got[key] = read_png(str(p))
        elif p.suffix == ".npy":
            got[key] = np.load(p)
        else:
            got[key] = np.array(p.read_text())
    return got


def differences(got: dict, want: dict) -> list[str]:
    """What differs between two ``written`` maps: missing or extra files,
    dtypes, shapes and values (arrays must be equal)."""
    bad = [f"missing {k}" for k in sorted(set(want) - set(got))]
    bad += [f"extra {k}" for k in sorted(set(got) - set(want))]
    for k in sorted(set(got) & set(want)):
        a, b = got[k], want[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(f"{k}: {a.dtype}{a.shape} != {b.dtype}{b.shape}")
        elif not np.array_equal(a, b):
            bad.append(f"{k}: values differ")
    return bad
