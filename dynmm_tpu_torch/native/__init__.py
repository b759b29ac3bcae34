"""ctypes bindings of the native preprocessing library (a copy of
``dynmm_tpu/native``: ``augment.cpp`` is the same source), plus the PNG row
unfiltering of ``png.cpp``.

``augment.cpp`` and ``png.cpp`` build with ``g++ -O3 -fopenmp`` into one
library at first use, into ``build/dynmm_tpu_torch/native-<source hash>/``
at the root of the checkout (written to a temporary name and renamed, so
concurrent first uses do not clash). The port has no cv2 fallback: the
card's machine has no cv2, so a failed build raises. Bound here: ``resize``
(cv2 semantics, which the mIoU numbers depend on) for
``data/seg_preprocessing.py``, ``space_to_depth`` (the packed stem's host
feed) and ``png_unfilter`` for ``data/png.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRCS = tuple(Path(__file__).resolve().parent / name
              for name in ("augment.cpp", "png.cpp"))
_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dynmm_tpu_torch"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return _BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libdynmm_augment.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, *map(str, _SRCS), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("the native preprocessing library needs g++, "
                           "which was not found") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {[s.name for s in _SRCS]} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not so.exists():
            _build(so)
        lb = ctypes.CDLL(str(so))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        for name, p in (("resize_bilinear_f32", f32p),
                        ("resize_nearest_f32", f32p),
                        ("resize_nearest_i32", i32p)):
            fn = getattr(lb, name)
            fn.argtypes = [p] + [ctypes.c_int] * 3 + [p] + [ctypes.c_int] * 2
            fn.restype = None
        lb.space_to_depth_f32.argtypes = [f32p] + [ctypes.c_int] * 4 + [f32p]
        lb.space_to_depth_f32.restype = None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lb.png_unfilter.argtypes = [u8p] + [ctypes.c_int] * 3 + [u8p]
        lb.png_unfilter.restype = ctypes.c_int
        _lib = lb
        return _lib


def resize(img: np.ndarray, height: int, width: int, nearest: bool
           ) -> np.ndarray:
    """cv2-semantics resize of (H, W[, C]) float32, or int32 with
    ``nearest``, to (height, width[, C])."""
    lb = lib()
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    if img.dtype == np.float32:
        out = np.empty((height, width, c), np.float32)
        fn = lb.resize_nearest_f32 if nearest else lb.resize_bilinear_f32
        ptr = ctypes.POINTER(ctypes.c_float)
    elif img.dtype == np.int32 and nearest:
        out = np.empty((height, width, c), np.int32)
        fn = lb.resize_nearest_i32
        ptr = ctypes.POINTER(ctypes.c_int32)
    else:
        raise TypeError(f"unsupported dtype {img.dtype} nearest={nearest}")
    fn(img.ctypes.data_as(ptr), h, w, c, out.ctypes.data_as(ptr), height,
       width)
    return out[:, :, 0] if squeeze else out


def space_to_depth(x: np.ndarray) -> np.ndarray:
    """2×2 space-to-depth (N, H, W, C) float32 → (N, H/2, W/2, 4C), channel
    order (row parity, col parity, c): ``models/resnet.py::
    space_to_depth_host``'s layout (the binding of
    ``dynmm_tpu/native/__init__.py::space_to_depth``)."""
    f32p = ctypes.POINTER(ctypes.c_float)
    x = np.ascontiguousarray(x, np.float32)
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs an even height and width, "
                         f"got {h}x{w}")
    out = np.empty((n, h // 2, w // 2, 4 * c), np.float32)
    lib().space_to_depth_f32(x.ctypes.data_as(f32p), n, h, w, c,
                             out.ctypes.data_as(f32p))
    return out


def png_unfilter(data: bytes, height: int, rowbytes: int, bpp: int
                 ) -> np.ndarray:
    """Undo PNG's per-row filters: ``data`` is the inflated image data,
    ``height`` rows of one filter byte and ``rowbytes`` bytes; returns the
    (height, rowbytes) uint8 samples. Raises ``ValueError`` on a filter byte
    outside 0..4."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if len(data) < height * (rowbytes + 1):
        raise ValueError(f"image data holds {len(data)} bytes, "
                         f"{height} rows need {height * (rowbytes + 1)}")
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    bad = lib().png_unfilter(src.ctypes.data_as(u8p), height, rowbytes, bpp,
                             out.ctypes.data_as(u8p))
    if bad:
        raise ValueError(f"row {bad - 1} has filter type "
                         f"{src[(bad - 1) * (rowbytes + 1)]}, not 0..4")
    return out
