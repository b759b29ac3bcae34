"""Run the port's CUDA sources on the CPU, for tests on machines without a
card or ``nvcc``.

Each ``csrc/<name>.cu`` is rewritten into host C++ (launches ``k<<<g, b, s,
st>>>(args)`` become calls of an emulated launcher, dynamic shared memory a
per-block buffer) and compiled with the host's ``g++`` against a small
header that provides the CUDA names the sources use. Blocks run one after
another. A kernel that calls ``__syncthreads`` runs each block's threads as
contexts (``ucontext``) on the calling thread, switched only where a thread
waits at a barrier: one core per block, so the tests keep their pace when
other processes load the machine (OS threads meeting at futex barriers ran
several times slower there). Barriers that never complete make the launch
report an error, as a failed launch does on the card. Any other kernel runs
its threads in a loop. The header defines ``DYNMM_EMULATED``: a source
keeps its inline PTX under ``#ifndef DYNMM_EMULATED`` and emulates it
otherwise, warp collectives (``mma.sync``) through a per-warp barrier of 32
and a per-warp exchange buffer (``emu_warp_sync``, ``emu_warp_mem``), and
``cp.async`` as a synchronous copy; ``__threadfence`` is a no-op and
``atomicAdd`` a plain read-modify-write, since blocks run in turn on one OS
thread; ``__stcs`` and ``__ldcg`` are plain stores and loads. A block that
waits for blocks which started before it (the SE cell's MLP queue) finds
them done, so ``__nanosleep`` is a no-op; ``__trap`` aborts the process. ``__nv_bfloat16``
is a 16-bit struct with ``cuda_bf16.h``'s round-to-nearest-even
``__float2bfloat16_rn`` and ``__bfloat162float``, so the bf16 forms run here
too. Wrappers
size their grids for ``SMS`` streaming multiprocessors, few, so that a
test's small shapes still get several blocks. Headers under ``csrc/``
(``*.cuh``) are included as they are, through ``-I``: they hold no launch
and no ``extern __shared__``, the two things this rewrite changes.
Indexing, masking, tiling and the arithmetic are the sources' own; what only
the card shows (timing, races between warps, limits on registers and shared
memory, the tensor cores' truncating sums) is not emulated. One launch runs
at a time.

    with emulated(build(tmp_dir)):
        nbt1d_pair(x_cpu, ...)   # launches the emulated kernel on CPU memory

Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from dynmm_tpu_torch.kernels import _build

SMS = 2  # the SM count grids are sized for under emulation

SHIM = r"""
#pragma once
#define DYNMM_EMULATED 1
#include <math.h>
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <utility>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::vector<char> emu_smem;
// A block's threads run as contexts on the calling thread, switched only at
// barriers: a thread that arrives early returns to the scheduler until the
// barrier's last thread has arrived.
struct EmuBarrier {
  unsigned n = 0, count = 0, gen = 0;
};
// A warp's lanes meet at its barrier and exchange words through one of its
// two buffers, in turn: a lane writes a buffer again only two exchanges
// later, after every lane has passed the barrier between, so one barrier
// per exchange suffices.
constexpr int EMU_WARP_WORDS = 64;  // per lane
struct EmuWarp {
  EmuBarrier bar;
  unsigned mem[2][32 * EMU_WARP_WORDS];
};
struct EmuThread {
  ucontext_t ctx;
  EmuBarrier* waits_on = nullptr;
  unsigned wait_gen = 0, turn = 0;
  bool done = false;
  EmuWarp* warp = nullptr;
};
inline ucontext_t emu_sched;
inline EmuThread* emu_cur = nullptr;
inline EmuBarrier emu_block_bar;
inline void (*emu_invoke)(void*) = nullptr;
inline void* emu_body = nullptr;
inline void emu_arrive(EmuBarrier& b) {
  if (++b.count == b.n) {
    b.count = 0;
    ++b.gen;
    return;
  }
  emu_cur->waits_on = &b;
  emu_cur->wait_gen = b.gen;
  swapcontext(&emu_cur->ctx, &emu_sched);
}
inline void __syncthreads() { emu_arrive(emu_block_bar); }
// Blocks run one after another and a block's threads on one OS thread, so
// memory is coherent: fences are no-ops, an atomic a plain read-modify-write.
inline void __threadfence() {}
template <class T>
inline T atomicAdd(T* p, T v) { return std::exchange(*p, *p + v); }
template <class T>
inline T __ldcg(const T* p) { return *p; }
// A wait on another block's flag is met at once (the blocks it waits for
// ran before it); __trap ends the process, as it ends the kernel.
inline void __nanosleep(unsigned) {}
[[noreturn]] inline void __trap() { std::abort(); }
template <class T>
inline void __stcs(T* p, T v) { *p = v; }
inline void emu_warp_sync() { emu_arrive(emu_cur->warp->bar); }
// the buffer of this lane's next exchange; every lane calls it once each
inline unsigned* emu_warp_mem() {
  return emu_cur->warp->mem[emu_cur->turn ^= 1];
}
inline void emu_entry() {
  emu_invoke(emu_body);
  emu_cur->done = true;  // returns to the scheduler through uc_link
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchFailure = 719 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t emu_error = 0;  // read and cleared as on the card
inline cudaError_t cudaGetLastError() { return std::exchange(emu_error, 0); }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct alignas(8) float2 { float x, y; };
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
// bf16: the upper 16 bits of a float; narrowing rounds to nearest even
// (NaN stays a quiet NaN), as cuda_bf16.h's intrinsics
struct __nv_bfloat16 { unsigned short x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return {(unsigned short)((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  return __uint_as_float((unsigned)b.x << 16);
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
#define CUDART_INF_F INFINITY
template <class F>
void emu_launch(bool barrier, dim3 g, dim3 b, size_t smem, F&& f) {
  gridDim = g;
  blockDim = b;
  const unsigned nt = b.x * b.y * b.z;
  auto at = [&](unsigned t) {
    threadIdx = {t % b.x, (t / b.x) % b.y, t / (b.x * b.y)};
  };
  constexpr size_t STACK = 256 * 1024;
  std::vector<EmuThread> ts(barrier ? nt : 0);
  std::vector<EmuWarp> warps(barrier ? (nt + 31) / 32 : 0);
  std::unique_ptr<char[]> stacks(barrier ? new char[nt * STACK] : nullptr);
  emu_invoke = [](void* p) { (*static_cast<std::remove_reference_t<F>*>(p))(); };
  emu_body = &f;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        emu_smem.assign(smem + 64, (char)0x7f);  // stale-looking contents
        blockIdx = {x, y, z};
        if (!barrier) {
          for (unsigned t = 0; t < nt; ++t) { at(t); f(); }
          continue;
        }
        emu_block_bar = {nt, 0, 0};
        for (unsigned w = 0; w < warps.size(); ++w)
          warps[w].bar = {std::min(32u, nt - 32 * w), 0, 0};
        for (unsigned t = 0; t < nt; ++t) {
          EmuThread& th = ts[t];
          th = EmuThread{};
          th.warp = &warps[t / 32];
          getcontext(&th.ctx);
          th.ctx.uc_stack.ss_sp = stacks.get() + t * STACK;
          th.ctx.uc_stack.ss_size = STACK;
          th.ctx.uc_link = &emu_sched;
          makecontext(&th.ctx, emu_entry, 0);
        }
        for (unsigned live = nt; live > 0;) {
          bool moved = false;
          for (unsigned t = 0; t < nt; ++t) {
            EmuThread& th = ts[t];
            if (th.done || (th.waits_on && th.waits_on->gen == th.wait_gen))
              continue;
            th.waits_on = nullptr;
            emu_cur = &th;
            at(t);
            swapcontext(&emu_sched, &th.ctx);
            moved = true;
            live -= th.done;
          }
          if (!moved) {  // every thread waits: barriers that do not match
            emu_error = cudaErrorLaunchFailure;
            return;
          }
        }
      }
}
"""


def _split_top(s: str) -> list[str]:
    parts, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "([{"
        depth -= ch in ")]}"
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def _kernel_bodies(src: str) -> dict[str, str]:
    """name → text of each ``__global__`` function (up to the next one)."""
    heads = list(re.finditer(
        r"__global__\s+void\s+(?:__launch_bounds__\([^()]*\)\s*)?(\w+)\s*\(",
        src))
    return {m.group(1): src[m.start():(heads[i + 1].start()
                                        if i + 1 < len(heads) else len(src))]
            for i, m in enumerate(heads)}


def to_host_cpp(src: str) -> str:
    """Rewrite one CUDA source for the emulation header."""
    bodies = _kernel_bodies(src)
    src = re.sub(r"#include <(cuda_runtime|math_constants)\.h>\n", "", src)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_smem.data());", src)
    out = ""
    while (i := src.find("<<<")) >= 0:
        m = re.search(r"([\w:]+(?:<[^<>]*>)?)\s*$", src[:i])
        name = m.group(1)
        j = src.find(">>>", i)
        cfg = _split_top(src[i + 3:j])
        k = src.index("(", j)
        depth, p = 0, k
        while True:
            depth += src[p] == "("
            depth -= src[p] == ")"
            if depth == 0:
                break
            p += 1
        base = re.sub(r"<[^<>]*>$", "", name)
        barrier = "true" if "__syncthreads" in bodies.get(base, "") else "false"
        smem = cfg[2] if len(cfg) > 2 else "0"
        out += (src[:m.start(1)] + f"emu_launch({barrier}, {cfg[0]}, {cfg[1]}, "
                f"{smem}, [&] {{ {name}({src[k + 1:p]}); }})")
        src = src[p + 1:]
    return out + src


def build(out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Compile every source for the CPU into ``out_dir`` (in parallel)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shim = out_dir / "cuda_host_shim.h"
    shim.write_text(SHIM)

    def one(name: str) -> ctypes.CDLL:
        cpp = out_dir / f"{name}.cpp"
        cpp.write_text(to_host_cpp((_build.CSRC / f"{name}.cu").read_text()))
        so = out_dir / f"lib{name}.so"
        subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", "-include", str(shim), "-I",
                        str(_build.CSRC), "-o", str(so), str(cpp)],
                       check=True, capture_output=True, text=True)
        return ctypes.CDLL(str(so))

    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        return dict(zip(_build.SOURCES, pool.map(one, _build.SOURCES)))


@contextlib.contextmanager
def emulated(libs: dict[str, ctypes.CDLL]):
    """Within the block, wrappers given CPU tensors launch the emulated
    kernels (and count their launches) instead of the plain versions."""
    saved = _build.function, _build.on_card, _build.stream, _build.sm_count

    def function(lib, name, n_ptr, n_int):
        fn = getattr(libs[lib], name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn

    def on_card(*tensors):
        if any(t is not None and t.device.type != "cpu" for t in tensors):
            raise ValueError("emulated kernels take CPU tensors")
        return True

    _build.function, _build.on_card, _build.stream, _build.sm_count = (
        function, on_card, lambda: None, lambda t: SMS)
    try:
        yield
    finally:
        (_build.function, _build.on_card, _build.stream,
         _build.sm_count) = saved
