"""JPEG reading for the dataset converters, in place of the JAX package's
``cv2.imread`` (the port imports neither cv2 nor PIL).

``read(path, color)`` returns the pixels ``cv2.imread`` gives, with colour
in RGB order (cv2's BGR order is only in memory, as in ``data/png.py``):

* ``color=True`` is ``cv2.IMREAD_COLOR``: (H, W, 3) uint8, a grey file's
  three channels equal, turned as the file's EXIF orientation (APP1 tag
  0x0112) says, as cv2 turns it;
* ``color=False`` is ``cv2.IMREAD_UNCHANGED``: (H, W, 3) for a colour file,
  (H, W) for a grey one, EXIF orientation ignored.

The native decoder (``native/jpeg.cpp``) decodes baseline and
extended-sequential Huffman JPEGs with libjpeg-turbo's arithmetic, so the
pixels equal cv2's; the kinds it does not decode (progressive, arithmetic,
12-bit, CMYK, RGB-coded) raise ``ValueError`` naming the file and the
marker.
"""

from __future__ import annotations

import struct

import numpy as np

from dynmm_tpu_torch import native

ORIENTATION_TAG = 0x0112


def exif_orientation(buf: bytes) -> int:
    """The EXIF orientation (1..8) of the JPEG in ``buf``; 1 where it has
    none or an invalid one."""
    pos = 2
    while pos + 4 <= len(buf) and buf[pos] == 0xFF:
        marker = buf[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0xD9, 0xDA):  # EOI, SOS: no more headers
            break
        length, = struct.unpack_from(">H", buf, pos + 2)
        seg = buf[pos + 4:pos + 2 + length]
        if marker == 0xE1 and seg[:6] == b"Exif\0\0":
            return _tiff_orientation(seg[6:])
        pos += 2 + length
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd, = struct.unpack_from(e + "I", tiff, 4)
    if ifd + 2 > len(tiff):
        return 1
    n, = struct.unpack_from(e + "H", tiff, ifd)
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, kind, count = struct.unpack_from(e + "HHI", tiff, at)
        if tag == ORIENTATION_TAG and kind == 3 and count >= 1:
            value, = struct.unpack_from(e + "H", tiff, at + 8)
            return value if 1 <= value <= 8 else 1
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` turned upright as cv2's ``ApplyExifOrientation`` turns it."""
    if orientation >= 5:  # 5..8 swap the axes first
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def read(path: str, color: bool) -> np.ndarray:
    """Decode the JPEG at ``path`` (see the module docstring)."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        img = native.jpeg_decode(buf)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if not color:
        return img
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return orient(img, exif_orientation(buf))
