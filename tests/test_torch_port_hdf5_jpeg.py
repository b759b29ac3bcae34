"""The port's JPEG decoder (``data/jpeg.py``, ``native/jpeg.cpp``) against
OpenCV, and its HDF5 reader (``data/hdf5.py``) against h5py.

* ``jpeg.read`` equals ``cv2.imread`` pixel for pixel (error 0) under
  IMREAD_COLOR and IMREAD_UNCHANGED, colour in RGB order: on the committed
  fixtures (``tests/fixtures_torch_prepare/jpeg``) and on hypothesis-drawn
  small images at each chroma sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1)
  and grey, quality 50-100, with and without restart intervals and
  optimised Huffman tables; EXIF orientations 1-8 as cv2 turns them.
  Progressive files raise ``ValueError`` naming the file and the marker.
* ``hdf5.File`` reads what h5py writes: contiguous, compact and chunked
  datasets (deflate, shuffle, fletcher32, partial edge chunks, chunks never
  written), big-endian and float types, object references, nested groups,
  user blocks of 512 and 1024 bytes; ``ds[i]`` equals ``ds[...][i]`` and
  ``ds[a:b]`` equals ``ds[...][a:b]``. Superblock version 3, new-style and
  dense groups, layout version 4 and other datatypes raise
  ``NotImplementedError`` naming the structure and the file.
"""

import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

import _torch_prepare_raw as raw  # noqa: E402
from dynmm_tpu_torch.data import hdf5, jpeg  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def rgb(img: np.ndarray) -> np.ndarray:
    return img[..., ::-1] if img.ndim == 3 else img


def cv2_pair(path: str):
    return (rgb(cv2.imread(path, cv2.IMREAD_COLOR)),
            rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED)))


def assert_same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max(initial=0) == 0


# ----------------------------------------------------------------- JPEG
FIXTURE_JPEGS = sorted(p.stem for p in (raw.FIXTURES / "jpeg").glob("*.jpg")
                       if p.stem != "progressive")


@pytest.mark.parametrize("name", FIXTURE_JPEGS)
def test_fixture_jpeg_equals_stored_cv2(name):
    path = str(raw.FIXTURES / "jpeg" / f"{name}.jpg")
    with np.load(raw.FIXTURES / "jpeg" / "expected.npz") as want:
        assert_same(jpeg.read(path, color=True), want[f"{name}:color"])
        assert_same(jpeg.read(path, color=False), want[f"{name}:unchanged"])
    color, unchanged = cv2_pair(path)  # the stored pixels are cv2's here too
    assert_same(jpeg.read(path, color=True), color)
    assert_same(jpeg.read(path, color=False), unchanged)


@settings(max_examples=120, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48),
       sampling=st.sampled_from(sorted(SAMPLING) + ["grey"]),
       quality=st.integers(50, 100), restart=st.integers(0, 4),
       optimize=st.booleans(), smooth=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_jpeg_equals_cv2(tmp_path_factory, h, w, sampling, quality, restart,
                         optimize, smooth, seed):
    rng = np.random.default_rng(seed)
    c = 1 if sampling == "grey" else 3
    if smooth:
        y, x = np.mgrid[:h, :w]
        img = np.stack([(x * (4 + k) + y * (7 - k) + seed) % 256
                        for k in range(c)], -1).astype(np.uint8)
    else:
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    if c == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    path = str(tmp_path_factory.mktemp("jpeg") / "x.jpg")
    assert cv2.imwrite(path, img[..., 0] if c == 1 else img, params)
    color, unchanged = cv2_pair(path)
    assert_same(jpeg.read(path, color=True), color)
    assert_same(jpeg.read(path, color=False), unchanged)


def _with_orientation(buf: bytes, orientation: int, endian: str) -> bytes:
    mark = b"II" if endian == "<" else b"MM"
    tiff = (mark + struct.pack(endian + "HI", 42, 8)
            + struct.pack(endian + "H", 1)
            + struct.pack(endian + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(endian + "I", 0))
    seg = b"Exif\0\0" + tiff
    return buf[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg \
        + buf[2:]


@pytest.mark.parametrize("orientation", range(0, 10))
@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("channels", [1, 3])
def test_exif_orientation_as_cv2(tmp_path, orientation, endian, channels):
    img = np.random.default_rng(orientation).integers(
        0, 256, (11, 19, channels), dtype=np.uint8)
    ok, enc = cv2.imencode(".jpg", img[..., 0] if channels == 1 else img)
    path = tmp_path / "o.jpg"
    path.write_bytes(_with_orientation(enc.tobytes(), orientation, endian))
    color, unchanged = cv2_pair(str(path))
    assert_same(jpeg.read(str(path), color=True), color)
    assert_same(jpeg.read(str(path), color=False), unchanged)


def test_progressive_raises_naming_file_and_marker():
    path = raw.FIXTURES / "jpeg" / "progressive.jpg"
    with pytest.raises(ValueError, match=r"progressive\.jpg.*SOF2"):
        jpeg.read(str(path), color=True)


@pytest.mark.parametrize("patch,what", [
    ((0xC9, None), "arithmetic"),        # SOF9
    ((0xC0, 12), "12-bit"),              # 12-bit samples
])
def test_unsupported_jpeg_raises(tmp_path, patch, what):
    ok, enc = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    buf = bytearray(enc.tobytes())
    sof = buf.index(b"\xff\xc0")
    marker, precision = patch
    buf[sof + 1] = marker
    if precision is not None:
        buf[sof + 4] = precision
    path = tmp_path / "bad.jpg"
    path.write_bytes(bytes(buf))
    with pytest.raises(ValueError, match=rf"bad\.jpg.*{what}"):
        jpeg.read(str(path), color=False)


def test_adobe_rgb_jpeg_raises(tmp_path):
    ok, enc = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    buf = enc.tobytes()
    assert buf[2:4] == b"\xff\xe0"  # drop the JFIF segment, which wins
    buf = buf[:2] + buf[4 + struct.unpack(">H", buf[4:6])[0]:]
    app14 = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])  # transform 0: RGB
    seg = b"\xff\xee" + struct.pack(">H", len(app14) + 2) + app14
    path = tmp_path / "rgb.jpg"
    path.write_bytes(buf[:2] + seg + buf[2:])
    with pytest.raises(ValueError, match=r"rgb\.jpg.*APP14 transform 0"):
        jpeg.read(str(path), color=True)


# ----------------------------------------------------------------- HDF5
def _h5_file(path, userblock: int = 0):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w", userblock_size=userblock) as f:
        f["contiguous"] = rng.integers(0, 255, (5, 3, 7), dtype=np.uint8)
        f.create_dataset("deflate", data=rng.random((9, 6, 5)).astype(
            np.float32), chunks=(2, 4, 3), compression="gzip")
        f.create_dataset("shuffle", data=rng.integers(0, 60000, (7, 11))
                         .astype(np.uint16), chunks=(3, 4),
                         compression="gzip", shuffle=True, fletcher32=True)
        f.create_dataset("plain_chunks", data=rng.integers(
            -5, 5, (6, 4)).astype(np.int64), chunks=(4, 4))
        f.create_dataset("big_endian",
                         data=np.arange(12, dtype=">i4").reshape(3, 4))
        f.create_dataset("f64", data=rng.random((4, 3)))
        f.create_dataset("f16", data=rng.random((4, 3)).astype(np.float16))
        f.create_dataset("fill", shape=(10, 4), chunks=(2, 2), dtype=np.int16,
                         fillvalue=-7)
        f["fill"][2:4, 0:2] = 5
        f.create_dataset("unwritten", shape=(3, 2), dtype=np.float32)
        f["scalar"] = 3.5
        space = h5py.h5s.create_simple((4, 5))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32, space,
                             dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL,
                 np.arange(20, dtype=np.int32).reshape(4, 5))
        g = f.create_group("a/b")
        refs = [g.create_dataset(f"lab{i}", data=rng.integers(
            0, 38, (4, 3)).astype(np.uint8)).ref for i in range(40)]
        f.create_dataset("refs", data=np.array(refs, h5py.ref_dtype)[:, None])
    return ("contiguous", "deflate", "shuffle", "plain_chunks", "big_endian",
            "f64", "f16", "fill", "unwritten", "compact", "scalar")


@pytest.mark.parametrize("userblock", [0, 512, 1024])
def test_hdf5_datasets_equal_h5py(tmp_path, userblock):
    path = tmp_path / "t.h5"
    names = _h5_file(path, userblock)
    with h5py.File(path, "r") as H, hdf5.File(str(path)) as F:
        for name in names:
            want, ds = H[name][()], F[name]
            got = np.asarray(ds)
            assert got.dtype == want.dtype.newbyteorder("="), name
            assert got.shape == want.shape == ds.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            if want.ndim:
                for i in range(-1, want.shape[0]):
                    np.testing.assert_array_equal(ds[i], want[i],
                                                  err_msg=f"{name}[{i}]")
                np.testing.assert_array_equal(ds[1:-1], want[1:-1])
                np.testing.assert_array_equal(ds[:], want)
        assert sorted(F.keys()) == sorted(H.keys())
        assert "a/b" in F and "a/b/lab7" in F and "nope" not in F
        assert sorted(F["a"]["b"].keys()) == sorted(H["a/b"].keys())


def test_hdf5_references_equal_h5py(tmp_path):
    path = tmp_path / "t.h5"
    _h5_file(path, 512)
    with h5py.File(path, "r") as H, hdf5.File(str(path)) as F:
        whole = np.asarray(F["refs"])
        assert whole.shape == (40, 1) and whole.dtype == object
        for i in range(40):
            want = H[H["refs"][i][0]][()]
            np.testing.assert_array_equal(np.asarray(F[whole[i, 0]]), want)
            np.testing.assert_array_equal(F[F["refs"][i][0]][:], want)


def test_hdf5_reads_only_the_chunks_of_an_index(tmp_path, monkeypatch):
    path = tmp_path / "t.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(8 * 6).reshape(8, 6),
                         chunks=(2, 3), compression="gzip")
    F = hdf5.File(str(path))
    ds = F["x"]
    decoded = []
    orig = hdf5.Dataset._decode_chunk
    monkeypatch.setattr(hdf5.Dataset, "_decode_chunk",
                        lambda self, *a: decoded.append(a) or orig(self, *a))
    np.testing.assert_array_equal(ds[5], np.arange(30, 36))
    assert len(decoded) == 2  # the two chunks of rows 4-5
    np.testing.assert_array_equal(ds[4], np.arange(24, 30))
    assert len(decoded) == 2  # the same chunks, kept from the last read
    F.close()


def test_hdf5_unsupported_structures_raise(tmp_path):
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f["x"] = np.arange(3)
    with pytest.raises(NotImplementedError, match=r"latest\.h5.*superblock "
                       r"version 3"):
        hdf5.File(str(latest))

    groups = tmp_path / "groups.h5"
    with h5py.File(groups, "w") as f:
        f.create_group("compact", track_order=True)["d"] = np.arange(3)
        dense = f.create_group("dense", track_order=True)
        for i in range(20):
            dense[f"d{i}"] = np.arange(3)
        f["s"] = np.array([b"text"])
    with hdf5.File(str(groups)) as F:
        with pytest.raises(NotImplementedError,
                           match=r"groups\.h5.*new-style \(link message\)"):
            F["compact"]
        with pytest.raises(NotImplementedError,
                           match=r"groups\.h5.*fractal-heap \(dense\)"):
            F["dense"]
        with pytest.raises(NotImplementedError, match="string datatype"):
            F["s"]

    v4 = tmp_path / "v4.h5"
    with h5py.File(v4, "w") as f:
        f.create_dataset("c", data=np.arange(10), chunks=(5,))
    buf = bytearray(v4.read_bytes())
    # the chunked layout message: version 3, class 2, rank 1 + 1, the
    # B-tree's address, chunk (5,) of 8-byte items
    at = next(i for i in range(len(buf)) if buf[i:i + 3] == b"\x03\x02\x02"
              and buf[i + 11:i + 19] == struct.pack("<II", 5, 8))
    buf[at] = 4  # the message's version
    v4.write_bytes(bytes(buf))
    with hdf5.File(str(v4)) as F:
        with pytest.raises(NotImplementedError,
                           match=r"v4\.h5.*data layout version 4"):
            F["c"]


def test_hdf5_not_hdf5_raises(tmp_path):
    path = tmp_path / "x.mat"
    path.write_bytes(b"MATLAB 5.0 MAT-file" + bytes(2000))
    with pytest.raises(ValueError, match=r"x\.mat.*not an HDF5 file"):
        hdf5.File(str(path))
