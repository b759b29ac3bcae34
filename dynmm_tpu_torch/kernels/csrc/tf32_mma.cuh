// fp32-accurate tensor-core products (3xTF32 mma.sync) and asynchronous
// copies for Hopper (sm_90a), shared by csrc/nbt1d.cu and csrc/nbt1d_block.cu.
//
// 3xTF32. Each fp32 operand v splits into hi = tf32(v) and lo = tf32(v - hi)
// (cvt.rna: nearest, ties away from zero, 10 mantissa bits), and each
// fragment product is three mma.sync.m16n8k8 TF32 products, lo*hi + hi*lo +
// hi*hi. hi + lo carries 22 of fp32's 24 significand bits and the dropped
// lo*lo term is below 2^-22 of the product. The tensor cores' accumulation
// truncates, so a caller starts each K-chunk's sum from 0 and adds the chunk
// sums in fp32 (see csrc/nbt1d.cu).
//
// Every primitive has a host version under DYNMM_EMULATED (the CPU
// emulation of kernels/emulate.py, which includes this header unchanged
// through -I csrc/): cvt.rna.tf32 as an integer round, mma.sync as fp32
// sums over the lanes' fragments exchanged in the warp's buffer, cp.async
// as a synchronous copy with the same zero fill. So this header holds no
// kernel launch and no dynamic shared memory declaration, which the
// emulation rewrites only in the .cu sources.

#pragma once

#include <cstdint>
#ifndef DYNMM_EMULATED
#include <cuda_runtime.h>
#else
#include <cstring>
#endif

namespace {

#ifdef DYNMM_EMULATED
inline unsigned f2u(float v) { unsigned u; std::memcpy(&u, &v, 4); return u; }
inline float u2f(unsigned u) { float v; std::memcpy(&v, &u, 4); return v; }
#else
__device__ __forceinline__ float u2f(unsigned u) { return __uint_as_float(u); }
#endif

// fp32 -> tf32 (cvt.rna.tf32.f32): nearest, ties away from zero.
__device__ __forceinline__ unsigned to_tf32(float v) {
#ifndef DYNMM_EMULATED
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
#else
  const unsigned u = f2u(v);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;  // inf and nan as they are
  return (u + 0x1000u) & 0xffffe000u;  // magnitude rounds, sign stays
#endif
}

__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - u2f(hi));
}

#ifndef DYNMM_EMULATED
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#else
// One m16n8k8 TF32 product on the lanes' fragments in the warp's exchange
// buffer. The card reads the upper 19 bits of each operand: the products of
// two such values are exact in fp32. The sum is taken in fp32, rounded to
// nearest here where the card truncates (see the note at the top).
inline void emu_mma_tf32(float (&d)[4], const unsigned* lanes, int stride,
                         int a_at, int b_at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto A = [&](int r, int k) {  // a0 A[g][t], a1 A[g+8][t], a2 A[g][t+4], ...
    return u2f(lanes[((r & 7) * 4 + (k & 3)) * stride + a_at +
                     (r >> 3) + 2 * (k >> 2)] & 0xffffe000u);
  };
  auto B = [&](int k, int n) {  // b0 B[t][g], b1 B[t+4][g]
    return u2f(lanes[(n * 4 + (k & 3)) * stride + b_at + (k >> 2)] &
               0xffffe000u);
  };
  for (int i = 0; i < 4; ++i) {  // c0 C[g][2t], c1 C[g][2t+1], c2 C[g+8][2t]..
    const int r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    float acc = d[i];
    for (int k = 0; k < 8; ++k) acc += A(r, k) * B(k, n);
    d[i] = acc;
  }
}
#endif

// acc[mt][nt] += A_mt * B_nt in 3xTF32 for one k-step of 8: lo*hi, hi*lo,
// hi*hi, small terms first. The emulation exchanges the warp's fragments
// once per call, not once per mma.
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[MT][NT][4],
                                           const unsigned (&ah)[MT][4],
                                           const unsigned (&al)[MT][4],
                                           const unsigned (&bh)[NT][2],
                                           const unsigned (&bl)[NT][2]) {
#ifndef DYNMM_EMULATED
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_tf32(acc[mt][nt], al[mt], bh[nt]);
      mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
      mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
    }
#else
  constexpr int STRIDE = 8 * MT + 4 * NT;  // words a lane publishes
  static_assert(STRIDE <= EMU_WARP_WORDS, "exchange buffer too small");
  unsigned* lanes = emu_warp_mem();
  unsigned* mine = lanes + (threadIdx.x & 31) * STRIDE;
  for (int mt = 0; mt < MT; ++mt)
    for (int j = 0; j < 4; ++j) {
      mine[mt * 4 + j] = ah[mt][j];
      mine[4 * MT + mt * 4 + j] = al[mt][j];
    }
  for (int nt = 0; nt < NT; ++nt)
    for (int j = 0; j < 2; ++j) {
      mine[8 * MT + nt * 2 + j] = bh[nt][j];
      mine[8 * MT + 2 * NT + nt * 2 + j] = bl[nt][j];
    }
  emu_warp_sync();
  for (int mt = 0; mt < MT; ++mt)
    for (int nt = 0; nt < NT; ++nt) {
      const int a_hi = mt * 4, a_lo = 4 * MT + mt * 4;
      const int b_hi = 8 * MT + nt * 2, b_lo = 8 * MT + 2 * NT + nt * 2;
      emu_mma_tf32(acc[mt][nt], lanes, STRIDE, a_lo, b_hi);
      emu_mma_tf32(acc[mt][nt], lanes, STRIDE, a_hi, b_lo);
      emu_mma_tf32(acc[mt][nt], lanes, STRIDE, a_hi, b_hi);
    }
#endif
}

// Up to 4 floats from p (n of them valid); 0 where invalid.
__device__ __forceinline__ float4 load4(const float* p, bool ok, int n,
                                        bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok || n <= 0) return v;
  if (vec && n >= 4) return *reinterpret_cast<const float4*>(p);
  v.x = p[0];
  if (n > 1) v.y = p[1];
  if (n > 2) v.z = p[2];
  if (n > 3) v.w = p[3];
  return v;
}

// cp.async of BYTES (4 or 16) from device memory to shared memory; the
// first `valid` bytes come from src, the rest are zero (valid = 0: all
// zero, src not read but a mapped address all the same). 16-byte copies
// bypass L1 (.cg), 4-byte copies may use it (.ca: .cg takes 16 only).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  static_assert(BYTES == 4 || BYTES == 16, "cp.async copies 4 or 16 bytes");
#ifndef DYNMM_EMULATED
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid)
                 : "memory");
#else
  std::memset(dst, 0, BYTES);
  if (valid > 0) std::memcpy(dst, src, valid);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifndef DYNMM_EMULATED
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most N of this thread's committed groups are in flight;
// the thread may then read what its own copies wrote (the "memory" clobbers
// keep the compiler from moving shared-memory accesses across).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifndef DYNMM_EMULATED
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

}  // namespace
