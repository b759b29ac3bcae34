"""The port's PNG codec (``dynmm_tpu_torch/data/png.py``, rows unfiltered
by ``native/png.cpp``) against cv2, which the JAX package reads and writes
the prepared layouts with: decoded pixels equal ``cv2.imread(...,
IMREAD_UNCHANGED)`` (BGR→RGB for colour) on files cv2 writes, each of the
five row filters decodes, the native unfilter equals a numpy oracle, cv2
reads the port's files back exactly, and unsupported files raise."""

import ast
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from dynmm_tpu_torch import native
from dynmm_tpu_torch.data import png

REPO = Path(__file__).resolve().parents[1]


def _image(kind: str, h: int = 37, w: int = 53, seed: int = 0) -> np.ndarray:
    """Smooth gradients plus noise, which cv2 writes with row filters
    other than None."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "rgb":
        base = np.stack([x * 4 + y, y * 5, (x * y) % 200], -1)
        return ((base + rng.integers(0, 9, (h, w, 3))) % 256).astype(np.uint8)
    if kind == "grey":
        return ((x * 3 + y * 2 + rng.integers(0, 5, (h, w))) % 256
                ).astype(np.uint8)
    return (x * 700 + y * 311 + rng.integers(0, 40, (h, w))).astype(np.uint16)


def _cv2_write(path: Path, img: np.ndarray) -> None:
    cv2.imwrite(str(path), img[:, :, ::-1] if img.ndim == 3 else img)


def _cv2_read(path: Path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    return img[:, :, ::-1] if img.ndim == 3 else img


def _filter_types(path: Path) -> set[int]:
    """The filter bytes of a PNG's rows (one channel count from IHDR)."""
    buf = path.read_bytes()
    pos, idat, header = 8, b"", None
    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    w, h, depth, color = header[:4]
    row = w * {0: 1, 2: 3}[color] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (row + 1)] for y in range(h)}


@pytest.mark.parametrize("kind", ["rgb", "grey", "grey16"])
def test_decoder_equals_cv2(tmp_path, kind):
    img = _image(kind, h=120, w=160)
    path = tmp_path / f"{kind}.png"
    _cv2_write(path, img)
    got = png.read(str(path))
    want = _cv2_read(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    # cv2 filtered the rows (each filter type apart: below)
    assert _filter_types(path) - {0}


def _predictor(ft: int, left: np.ndarray, up: np.ndarray,
               upleft: np.ndarray) -> np.ndarray:
    a, b, c = (v.astype(np.int32) for v in (left, up, upleft))
    if ft == 0:
        return np.zeros_like(a)
    if ft == 1:
        return a
    if ft == 2:
        return b
    if ft == 3:
        return (a + b) // 2
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_filtered(img: np.ndarray, filters: list[int], bpp: int
                     ) -> bytes:
    """Filter the rows of ``img``'s bytes by hand (the predictors read the
    raw bytes, known here, so every row filters at once)."""
    h = img.shape[0]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    zero = np.zeros_like(rows[0])
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else zero
        left = np.concatenate([np.zeros(bpp, np.uint8), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.uint8), up[:-bpp]])
        pred = _predictor(filters[y], left, up, upleft)
        out.append(bytes([filters[y]])
                   + ((cur.astype(np.int32) - pred) % 256).astype(
                       np.uint8).tobytes())
    return b"".join(out)


def _write_png(path: Path, raw: bytes, w: int, h: int, depth: int, color: int,
               interlace: int = 0, extra: bytes = b"") -> None:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    path.write_bytes(
        png.SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                     interlace))
        + extra + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4, None],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("kind", ["rgb", "grey", "grey16"])
def test_each_filter_decodes(tmp_path, kind, ft):
    """One filter on every row, or (``None``) row y filtered with y mod 5."""
    img = _image(kind, seed=5 if ft is None else ft)
    h, w = img.shape[:2]
    bpp = {"rgb": 3, "grey": 1, "grey16": 2}[kind]
    stored = img.astype(">u2") if kind == "grey16" else img
    filters = [y % 5 for y in range(h)] if ft is None else [ft] * h
    raw = _encode_filtered(stored, filters, bpp)
    path = tmp_path / "f.png"
    _write_png(path, raw, w, h, 16 if kind == "grey16" else 8,
               2 if kind == "rgb" else 0)
    got = png.read(str(path))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _cv2_read(path))


def _unfilter_oracle(data: bytes, h: int, rowbytes: int, bpp: int
                     ) -> np.ndarray:
    """Byte-by-byte numpy unfilter (the test oracle; the library's is
    native)."""
    src = np.frombuffer(data, np.uint8).reshape(h, rowbytes + 1)
    out = np.zeros((h, rowbytes), np.uint8)
    for y in range(h):
        ft, line = int(src[y, 0]), src[y, 1:]
        up = out[y - 1] if y else np.zeros(rowbytes, np.uint8)
        for i in range(rowbytes):
            a = int(out[y, i - bpp]) if i >= bpp else 0
            c = int(up[i - bpp]) if i >= bpp else 0
            pred = int(_predictor(ft, np.array(a), np.array(up[i]),
                                  np.array(c)))
            out[y, i] = (int(line[i]) + pred) % 256
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3])
def test_native_unfilter_equals_numpy_oracle(bpp):
    rng = np.random.default_rng(bpp)
    h, rowbytes = 23, 17 * bpp
    rows = rng.integers(0, 256, (h, rowbytes + 1), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h)
    data = rows.tobytes()
    np.testing.assert_array_equal(native.png_unfilter(data, h, rowbytes, bpp),
                                  _unfilter_oracle(data, h, rowbytes, bpp))
    rows[5, 0] = 7
    with pytest.raises(ValueError, match="row 5 has filter type 7"):
        native.png_unfilter(rows.tobytes(), h, rowbytes, bpp)


@pytest.mark.parametrize("kind", ["rgb", "grey", "grey16"])
def test_cv2_reads_the_ports_files(tmp_path, kind):
    img = _image(kind, h=48, w=64)
    path = tmp_path / "out.png"
    png.write(str(path), img)
    back = _cv2_read(path)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    assert _filter_types(path) == {0}
    np.testing.assert_array_equal(png.read(str(path)), img)


def test_unsupported_files_raise_naming_the_file(tmp_path):
    img = _image("grey")
    h, w = img.shape
    interlaced = tmp_path / "interlaced.png"
    _write_png(interlaced, _encode_filtered(img, [0] * h, 1), w, h, 8, 0,
               interlace=1)
    with pytest.raises(ValueError, match="interlaced.png: interlaced"):
        png.read(str(interlaced))
    palette = tmp_path / "palette.png"
    plte = bytes(range(48))
    chunk = (struct.pack(">I", len(plte)) + b"PLTE" + plte
             + struct.pack(">I", zlib.crc32(b"PLTE" + plte) & 0xFFFFFFFF))
    _write_png(palette, _encode_filtered(img % 16, [0] * h, 1), w, h, 8, 3,
               extra=chunk)
    with pytest.raises(ValueError, match="palette.png: 8-bit palette"):
        png.read(str(palette))
    rgba = tmp_path / "rgba.png"
    cv2.imwrite(str(rgba), np.zeros((4, 5, 4), np.uint8))
    with pytest.raises(ValueError, match="rgba.png: 8-bit RGBA"):
        png.read(str(rgba))
    with pytest.raises(ValueError, match="cannot write"):
        png.write(str(tmp_path / "x.png"), np.zeros((4, 5), np.float32))


def test_port_imports_neither_cv2_nor_pil():
    files = sorted((REPO / "dynmm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(f.name, n) for n in names
                    if n.split(".")[0] in ("cv2", "PIL")]
    assert bad == []
