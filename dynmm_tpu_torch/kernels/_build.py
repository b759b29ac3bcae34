"""Build the port's CUDA sources and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into a shared library with a plain C interface (seconds per file, where a
source that includes PyTorch's headers takes minutes). All sources build in
parallel, at first use, into ``build/dynmm_tpu_torch/<hash>/`` at the root
of the checkout; the hash covers every source and the flags, so a changed
source rebuilds and an unchanged one is reused.

Every C entry takes its pointers and the stream as ``void*`` and returns
``cudaGetLastError()``; ``check`` raises when that is not 0. Nothing here
runs at import: the tests import every module on machines without ``nvcc``.

``LAUNCHES`` counts kernel launches by wrapper name. A wrapper's launch
function (``launch_<name>``: the checks and the launch, which the eager
wrapper calls for CUDA tensors and which is also the CUDA implementation of
its ``torch.library`` op, ``ops.py``) adds one where it launches its kernel
and nowhere else (the CPU path does not count), so an exported program's
replay counts as the eager forward does.

Maps are fp32 or, for the kernels that have a bf16 form, bf16 (``MAPS``);
parameters stay fp32 unless a kernel says otherwise. Each form has its own
C entry (``symbol``: ``<entry>_bf16``) and its own count (``count``: the
fp32 form under the wrapper's name, the bf16 form under ``<name>.bf16``),
so that launch counts stay exact per form.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("se", "stem_fuse", "upsample", "nbt1d", "nbt1d_block")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dynmm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: collections.Counter = collections.Counter()

FP32 = (torch.float32,)
MAPS = (torch.float32, torch.bfloat16)  # the map dtypes of the bf16 forms
_SUFFIX = {torch.float32: "", torch.bfloat16: "bf16"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(verbose: bool = False) -> float:
    """Compile every source not yet built (one ``nvcc`` per source, all
    started together) and load the libraries. Returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            so = out / f"lib{name}.so"
            if name in _libs or so.exists():
                continue
            tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {name}]\n{log}", file=sys.stderr, flush=True)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in SOURCES:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return time.perf_counter() - t0


def function(lib: str, name: str, n_ptr: int, n_int: int):
    """``lib``'s C entry ``name``: ``n_ptr`` pointers, ``n_int`` ints, then
    the stream; returns an int error code."""
    key = f"{lib}.{name}"
    fn = _fns.get(key)
    if fn is None:
        if lib not in _libs:
            build_all()
        fn = getattr(_libs[lib], name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def on_card(*tensors: torch.Tensor | None) -> bool:
    """True when every given tensor is a CUDA tensor (launch the kernel),
    False when every one lies on the CPU (take the plain version); raises on
    a mix. ``None`` entries are skipped."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError("expected every tensor on the CPU or every one on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
    return True


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of the card that holds ``t``: grids are
    sized from it."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def symbol(entry: str, t: torch.Tensor) -> str:
    """The C entry of ``entry``'s form for maps of ``t``'s dtype."""
    return f"{entry}_{_SUFFIX[t.dtype]}" if _SUFFIX[t.dtype] else entry


def count(name: str, t: torch.Tensor) -> None:
    """One launch of wrapper ``name``'s form for maps of ``t``'s dtype."""
    LAUNCHES[f"{name}.{_SUFFIX[t.dtype]}" if _SUFFIX[t.dtype] else name] += 1


def require(t: torch.Tensor, name: str, shape: tuple | None = None,
            dtypes: tuple = FP32) -> None:
    """Of one of ``dtypes`` (fp32 alone by default), contiguous and (when
    given) of ``shape``; raises otherwise."""
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: expected {names}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
