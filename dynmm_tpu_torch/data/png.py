"""PNG reading and writing for the prepared RGB-D layouts, in place of the
JAX package's ``cv2.imread`` / ``cv2.imwrite`` (the card's machine has
neither cv2 nor PIL).

``read`` decodes what the prepared layouts hold: 8-bit RGB, 8-bit grey and
16-bit grey (depth in mm; PNG stores 16-bit samples big-endian), with any of
the five row filters. It returns the pixels ``cv2.imread(path,
cv2.IMREAD_UNCHANGED)`` gives, with colour in RGB order (cv2's BGR order is
only in memory): (H, W, 3) uint8, (H, W) uint8 or (H, W) uint16. Interlaced
files, palette files and other formats raise ``ValueError`` naming the file.
The rows are unfiltered by the native library (``native/png.cpp``).

``write`` encodes (H, W, 3) uint8 RGB, (H, W) uint8 and (H, W) uint16 grey
with filter 0 (None) on every row; ``cv2.imread`` reads such files back
exactly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from dynmm_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → (channels, name)
_COLOR_TYPES = {0: (1, "grey"), 2: (3, "RGB"), 3: (1, "palette"),
                4: (2, "grey+alpha"), 6: (4, "RGBA")}


def _chunks(buf: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        if len(data) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, data
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def read(path: str) -> np.ndarray:
    """Decode the PNG at ``path`` (see the module docstring)."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    channels, color_name = _COLOR_TYPES.get(color, (0, f"type {color}"))
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    if (color, depth) not in ((0, 8), (0, 16), (2, 8)):
        raise ValueError(f"{path}: {depth}-bit {color_name} PNGs are not "
                         "supported (8-bit RGB, 8- or 16-bit grey are)")
    bpp = channels * depth // 8
    rows = native.png_unfilter(zlib.decompress(b"".join(idat)), height,
                               width * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    return img.reshape(height, width, channels) if channels > 1 else \
        img.reshape(height, width)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write(path: str, img: np.ndarray, level: int = 6) -> None:
    """Encode (H, W, 3) uint8 RGB, (H, W) uint8 or (H, W) uint16 grey to
    ``path``, filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth = 2, 8
    elif img.dtype == np.uint8 and img.ndim == 2:
        color, depth = 0, 8
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth = 0, 16
        img = img.astype(">u2")
    else:
        raise ValueError(f"cannot write {img.dtype} {img.shape} as PNG "
                         "(8-bit RGB, 8- or 16-bit grey)")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))
