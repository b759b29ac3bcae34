"""Write ``tests/fixtures_torch_prepare/``: the raw inputs of the four
dataset converters that a machine without h5py or OpenCV cannot write, and
what OpenCV and the JAX converters make of them.

* ``jpeg/``: baseline JPEGs (4:4:4, 4:2:2, 4:2:0, 4:4:0, grey; a restart
  interval; odd sizes; one with an EXIF orientation) and a progressive
  one, with ``expected.npz``: each file's ``cv2.imread`` pixels under
  IMREAD_COLOR (``<name>:color``) and IMREAD_UNCHANGED
  (``<name>:unchanged``), colour in RGB order.
* ``nyuv2/nyu_depth_v2_labeled.mat``: a MATLAB v7.3 file (a 512-byte user
  block, chunked and deflated datasets, a ``#refs#`` group) of two samples
  at NYUv2's 640x480.
* ``sunrgbd/``: the data tree (JPEGs, 16-bit depth PNGs) of four samples
  and the v7.3 ``SUNRGBD2Dseg.mat`` whose ``seglabel`` holds references.
* ``cityscapes/raw``, ``scenenet/raw``: the raw trees of the JAX package's
  converter tests.
* ``<dataset>/expected.npz``: every file the JAX converter writes from the
  raw tree ``tests/_torch_prepare_raw.py`` builds (the version 5 ``.mat``
  files are written there), as ``_torch_prepare_raw.written`` reads it.

Content is blocks and ramps, which deflate compresses: the folder stays
well under 1 MB. Run from the repository root, with h5py and OpenCV:

    JAX_PLATFORMS=cpu python tests/_make_torch_prepare_fixtures.py
"""

from __future__ import annotations

import json
import shutil
import struct
import sys
import tempfile
from pathlib import Path

import cv2
import h5py
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import _torch_prepare_raw as raw  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def pattern(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """Ramps, blocks and a little noise (BGR for cv2 when 3 channels)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    planes = [((x * (3 + c) + y * (5 + 2 * c)) % 256
               + ((x // 5 + y // 4) % 2) * 40 + rng.integers(0, 12, (h, w)))
              for c in range(channels)]
    img = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def with_orientation(buf: bytes, orientation: int) -> bytes:
    """``buf`` with an EXIF APP1 segment holding the orientation tag."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    seg = b"Exif\0\0" + tiff
    return buf[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg \
        + buf[2:]


def rgb_order(img: np.ndarray) -> np.ndarray:
    return img[..., ::-1].copy() if img.ndim == 3 else img


def write_jpegs(root: Path) -> None:
    d = root / "jpeg"
    d.mkdir()
    cases = [("c444_q90_37x53", (37, 53, 3), "444", 90, 0),
             ("c422_q75_21x34", (21, 34, 3), "422", 75, 0),
             ("c420_q100_rst_61x83", (61, 83, 3), "420", 100, 3),
             ("c440_q60_17x29", (17, 29, 3), "440", 60, 0),
             ("grey_q85_rst_23x45", (23, 45, 1), "444", 85, 2),
             ("c420_q95_orient6_31x42", (31, 42, 3), "420", 95, 0)]
    want = {}
    for i, (name, (h, w, c), samp, q, rst) in enumerate(cases):
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  SAMPLING[samp]]
        if rst:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        ok, enc = cv2.imencode(".jpg", pattern(h, w, i, c), params)
        assert ok
        buf = enc.tobytes()
        if "orient6" in name:
            buf = with_orientation(buf, 6)
        path = d / f"{name}.jpg"
        path.write_bytes(buf)
        want[f"{name}:color"] = rgb_order(cv2.imread(str(path),
                                                     cv2.IMREAD_COLOR))
        want[f"{name}:unchanged"] = rgb_order(
            cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    ok, enc = cv2.imencode(".jpg", pattern(16, 24, 9),
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    (d / "progressive.jpg").write_bytes(enc.tobytes())
    np.savez_compressed(d / "expected.npz", **want)


def write_nyuv2(root: Path) -> None:
    d = root / "nyuv2"
    d.mkdir()
    n, w, h = 2, 640, 480
    ni, ci, xi, yi = np.ogrid[:n, :3, :w, :h]
    images = ((xi // 40) * 37 + (yi // 30) * 53 + ci * 71 + ni * 13) % 256
    nd, xd, yd = np.ogrid[:n, :w, :h]
    levels = ((xd // 64) * 7 + (yd // 48) * 3 + nd) % 40
    depths = (0.25 + levels * 0.2371).astype(np.float32)
    raw_depths = np.where((xd // 32 + yd // 32) % 5 == 0, 0.0,
                          depths * np.float32(1.01)).astype(np.float32)
    labels = ((xd // 80) * 131 + (yd // 60) * 17 + nd * 7) % 895
    with h5py.File(d / "nyu_depth_v2_labeled.mat", "w",
                   userblock_size=512) as f:
        f.create_dataset("images", data=images.astype(np.uint8),
                         chunks=(1, 2, 256, 200), compression="gzip")
        f.create_dataset("depths", data=depths, chunks=(1, 256, 256),
                         compression="gzip")
        f.create_dataset("rawDepths", data=raw_depths, chunks=(1, 640, 120),
                         compression="gzip", shuffle=True)
        f.create_dataset("labels", data=labels.astype(np.uint16),
                         chunks=(1, 320, 480), compression="gzip")
        refs = f.create_group("#refs#")
        names = [refs.create_dataset(f"n{i}", data=np.frombuffer(
            s.encode("utf-16-le"), np.uint16)[:, None]).ref
            for i, s in enumerate(("bed", "wall"))]
        f.create_dataset("names", data=np.array(names, h5py.ref_dtype)[None])
    with open(d / "nyu_depth_v2_labeled.mat", "r+b") as fh:
        # MATLAB's user block: a text header
        fh.write(b"MATLAB 7.3 MAT-file, written for the dynmm_tpu_torch "
                 b"converter tests")


def write_sunrgbd(root: Path) -> None:
    d = root / "sunrgbd"
    sizes = ((13, 17), (24, 31), (9, 40), (33, 21))
    samplings = ("444", "422", "420", None)  # None: a grey JPEG
    labels = []
    for i, ((cam, name), (h, w), samp) in enumerate(
            zip(raw.SUN_SAMPLES, sizes, samplings)):
        s = d / "SUNRGBD" / cam / "set" / f"sample{i:02d}"
        for sub in ("image", "depth_bfx", "depth"):
            (s / sub).mkdir(parents=True)
        img = pattern(h, w, 20 + i, 1 if samp is None else 3)
        params = [cv2.IMWRITE_JPEG_QUALITY, 92]
        if samp:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[samp]]
        cv2.imwrite(str(s / "image" / name), img, params)
        rng = np.random.default_rng(30 + i)
        cv2.imwrite(str(s / "depth_bfx" / "d.png"),
                    rng.integers(0, 60000, (h, w), dtype=np.uint16))
        if i != 2:  # sample 2 has no raw depth
            cv2.imwrite(str(s / "depth" / "d.png"),
                        rng.integers(0, 60000, (h, w), dtype=np.uint16))
        labels.append(rng.integers(0, 38, (h, w)).astype(np.uint16))
    with h5py.File(d / "SUNRGBD2Dseg.mat", "w", userblock_size=512) as f:
        refs = f.create_group("#refs#")
        ds = []
        for i, lab in enumerate(labels):
            kw = {"chunks": (8, 8), "compression": "gzip"} if i % 2 else {}
            ds.append(refs.create_dataset(f"l{i}", data=lab.T, **kw).ref)
        g = f.create_group("SUNRGBD2Dseg")
        g.create_dataset("seglabel", data=np.array(ds, h5py.ref_dtype)[:, None])


def write_cityscapes(root: Path) -> None:
    base = root / "cityscapes" / "raw"
    rng = np.random.default_rng(1)
    for i, split in enumerate(("train", "val", "test")):
        name = f"city_{i:06d}_000019"
        for sub in ("leftImg8bit", "disparity", "camera", "gtFine"):
            (base / sub / split / "city").mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(base / "leftImg8bit" / split / "city"
                        / f"{name}_leftImg8bit.png"), pattern(10, 20, 40 + i))
        cv2.imwrite(str(base / "disparity" / split / "city"
                        / f"{name}_disparity.png"),
                    rng.integers(0, 30000, (10, 20), dtype=np.uint16))
        cv2.imwrite(str(base / "gtFine" / split / "city"
                        / f"{name}_gtFine_labelIds.png"),
                    rng.choice([0, 7, 9, 23, 26, 33], (10, 20)).astype(
                        np.uint8))
        cam = {"extrinsic": {"baseline": 0.22},
               "intrinsic": {"fx": 2262.52 + i}}
        (base / "camera" / split / "city" / f"{name}_camera.json").write_text(
            json.dumps(cam))


def write_scenenet(root: Path) -> None:
    """The raw tree of ``tests/test_prepare_converters.py``'s SceneNet
    test (its trajectory 0/999 indexes past its instance list)."""
    from test_prepare_converters import _make_scenenet_raw

    with tempfile.TemporaryDirectory() as tmp:
        src, _ = _make_scenenet_raw(Path(tmp))
        shutil.copytree(src, root / "scenenet" / "raw")


def write_expected(root: Path) -> None:
    from dynmm_tpu.data import (prepare_cityscapes, prepare_nyuv2,
                                prepare_scenenet, prepare_sunrgbd)

    def cv2_read(path):
        return rgb_order(cv2.imread(path, cv2.IMREAD_UNCHANGED))

    converters = {"nyuv2": prepare_nyuv2, "sunrgbd": prepare_sunrgbd,
                  "cityscapes": prepare_cityscapes,
                  "scenenet": prepare_scenenet}
    for kind, module in converters.items():
        with tempfile.TemporaryDirectory() as tmp:
            kw = raw.BUILDERS[kind](Path(tmp) / "in")
            out = Path(tmp) / "out"
            module.convert(str(out), **kw)
            got = raw.written(out, cv2_read)
        np.savez_compressed(root / kind / "expected.npz", **got)
        print(f"{kind}: {len(got)} files")


def main() -> None:
    root = raw.FIXTURES
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir()
    write_jpegs(root)
    write_nyuv2(root)
    write_sunrgbd(root)
    write_cityscapes(root)
    write_scenenet(root)
    write_expected(root)
    size = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
    print(f"{root}: {size / 1e3:.1f} kB")


if __name__ == "__main__":
    main()
