"""ctypes bindings of the native preprocessing library (a copy of
``dynmm_tpu/native``: ``augment.cpp`` is the same source).

``augment.cpp`` builds with ``g++ -O3 -fopenmp`` at first use into
``build/dynmm_tpu_torch/native-<source hash>/`` at the root of the checkout
(written to a temporary name and renamed, so concurrent first uses do not
clash). The port has no cv2 fallback: the card's machine has no cv2, so a
failed build raises. Only ``resize`` (cv2 semantics, which the mIoU numbers
depend on) is used, by ``data/seg_preprocessing.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "augment.cpp"
_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dynmm_tpu_torch"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libdynmm_augment.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("the native preprocessing library needs g++, "
                           "which was not found") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC.name} "
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
