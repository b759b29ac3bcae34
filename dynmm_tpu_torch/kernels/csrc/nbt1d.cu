// NonBottleneck1D conv pair for Hopper (sm_90a) on tensor cores, fp32-accurate.
//
// Replaces dynmm_tpu/kernels/nbt1d.py::_run_pair (_pair_kernel), the unit of
// fused_nbt1d_twopass. One call computes one conv pair of a stride-1
// NonBottleneck1D block:
//   h   = relu(3x1 conv(x) + br)
//   out = relu((1x3 conv(h) + bc) * s + t [+ identity])
// with BN folded into (s, t) (eps 1e-3) and taps packed as (3, C_in, C_out).
// A block is two calls: pair 1 without identity, pair 2 with +x.
//
// Implicit GEMM. A 3-tap conv along one axis of an NHWC map is one GEMM,
//   out[p, co] = sum_{d<3} sum_ci src[p + shift_d, ci] * w[d, ci, co],
// M = N*H*W pixels by C output channels over K = 3*C, where shift_d is d-1
// rows (3x1) or d-1 columns (1x3) and a source pixel outside the image reads
// as 0. One kernel serves both convs, so a call is two launches: launch 1
// (rows) writes h = relu(acc + br) into a scratch map the wrapper allocates,
// launch 2 (columns) reads h and writes the output. The zero padding gives
// the masks the TPU kernel applies by hand (nbt1d.py:74-98): x rows outside
// the image are 0 in launch 1, and h at a column outside the image is 0 (not
// relu(br)) in launch 2.
//
// Bound: operations. A pair does 12*C^2 FLOP per pixel, 7.55 GFLOP at every
// flagship level at B=8 (C^2*H*W = 78,643,200) against 20-30 MB of x, out
// and identity (9 us at 3.35 TB/s): 113 us on fp32 CUDA cores at 67 TFLOP/s,
// 46 us as three TF32 products per fp32 product at the tensor cores' 495
// TFLOP/s. Why two launches and not the TPU's one pass (h kept in VMEM): the
// h round trip adds 2*B*H*W*C*4 bytes (19.7 MB at 256@30x40, B=8: 6 us, and
// most of it stays in the 50 MB L2), while one pass needs every output
// channel of h in one block, which is what starved the grid at B=1. Here the
// grid is M x C tiles.
//
// 3xTF32. Each fp32 operand v splits into hi = tf32(v) and lo = tf32(v - hi)
// (cvt.rna: nearest, ties away from zero, 10 mantissa bits), and each
// fragment product is three mma.sync.m16n8k8 TF32 products, lo*hi + hi*lo +
// hi*hi. hi + lo carries 22 of fp32's 24 significand bits and the dropped
// lo*lo term is below 2^-22 of the product. The tensor cores' accumulation
// truncates, though, and its error grows with the number of mma that add
// into one register: summed over all of K in one accumulator, the pair
// missed the plain fp32 version by 3.4e-6 (C = 64) to 2.7e-5 (C = 512) of
// max |plain| on an H100. So each K-chunk's 12 mma start from 0 and the
// chunk sums add in fp32 (round to nearest): 0.7-1.2e-6 at every C, at the
// same speed. Plain TF32 (about 3 decimal digits) would miss the 1e-4 check.
// The split, the mma.sync wrapper and their CPU emulation live in
// csrc/tf32_mma.cuh, shared with csrc/nbt1d_block.cu.
//
// Tiles. A block of 4 warps (2 x 2) computes BM x BN outputs, each warp
// BM/2 x BN/2 (BM/32 x BN/16 mma tiles), walking K in chunks of 32 input
// channels of one tap, double-buffered in shared memory through registers
// (16-byte loads where C % 4 == 0 and the pointers allow) with rows padded
// by 4 (A) and 8 (B) floats so that fragment reads hit 32 distinct banks.
// Ragged pixel rows and channels past C load as 0 and are not stored. Tile
// rule: 64 x 64 unless that gives fewer than two blocks per SM (264 on 132
// SMs), then 32 x 32. At B=1: 128@60x80 150 -> 600 blocks, 256@30x40
// 76 -> 304, 512@15x20 40 -> 160; at B=8 every level keeps 64 x 64 (1,200,
// 600 and 304 blocks). On an H100 the small tile was 14-16 % faster than
// 32 x 64 at B=1 on the two deep levels, and 32-row tiles at B=8 slower.

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BK = 32;      // input channels per K-chunk (of one tap)
constexpr int AS = BK + 4;  // row stride of the A tile in shared memory
constexpr int SMS = 132;

template <int BM, int BN>
constexpr size_t smem_bytes() {
  return (size_t)2 * (BM * AS + BK * (BN + 8)) * sizeof(float);
}

// One 3-tap conv along `axis` (0: rows, 1: columns) as an implicit GEMM:
// out = relu(acc + bias) when s is null (launch 1), else
// relu((acc + bias) * s + t [+ idn]) (launch 2).
template <int BM, int BN>
__global__ void __launch_bounds__(128)
    nbt1d_conv_kernel(const float* __restrict__ src,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ s,
                      const float* __restrict__ t,
                      const float* __restrict__ idn, float* __restrict__ out,
                      int M, int H, int W, int C, int axis) {
  constexpr int MT = BM / 32;  // 16-row mma tiles per warp
  constexpr int NT = BN / 16;  // 8-column mma tiles per warp
  constexpr int BS = BN + 8;   // row stride of the B tile in shared memory
  constexpr int A_LD = BM * BK / 4 / THREADS;  // float4 loads of A a thread
  constexpr int B_LD = BK * BN / 4 / THREADS;
  constexpr int B_TPR = BN / 4;                // threads per B row
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [2][BM][AS]
  float* Bs = As + 2 * BM * AS;                  // [2][BK][BS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = (warp >> 1) * (BM / 2), wn = (warp & 1) * (BN / 2);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool vec = (C & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  const int len = axis == 0 ? H : W;   // extent along the conv axis
  const int step = axis == 0 ? W : 1;  // pixels per step along the axis

  // This thread stages A rows m0 + tid/8 + 16i (channels 4*(tid%8) ..+3 of
  // the chunk) and B rows bk + (THREADS/B_TPR)i (output channels n0 + bn
  // ..+3).
  const int ak = (tid & 7) * 4, bk = tid / B_TPR, bn = tid % B_TPR * 4;
  int a_pix[A_LD], a_pos[A_LD];  // pixel (-1 past M), its coordinate on axis
#pragma unroll
  for (int i = 0; i < A_LD; ++i) {
    const int p = m0 + (tid >> 3) + 16 * i;
    a_pix[i] = p < M ? p : -1;
    a_pos[i] = axis == 0 ? (p / W) % H : p % W;
  }
  const int kchunks = (C + BK - 1) / BK;
  const int nk = 3 * kchunks;
  float4 ra[A_LD], rb[B_LD];

  auto load = [&](int kc) {
    const int d = kc / kchunks, ci0 = (kc - d * kchunks) * BK;
#pragma unroll
    for (int i = 0; i < A_LD; ++i) {
      const int pos = a_pos[i] + d - 1;
      const bool ok = a_pix[i] >= 0 && pos >= 0 && pos < len;
      const size_t q = (size_t)(a_pix[i] + (d - 1) * step);
      ra[i] = load4(src + q * C + ci0 + ak, ok, C - ci0 - ak, vec);
    }
#pragma unroll
    for (int i = 0; i < B_LD; ++i) {
      const int k = ci0 + bk + THREADS / B_TPR * i;
      rb[i] = load4(w + ((size_t)d * C + k) * C + n0 + bn, k < C,
                    C - n0 - bn, vec);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LD; ++i)
      *reinterpret_cast<float4*>(
          As + (buf * BM + (tid >> 3) + 16 * i) * AS + ak) = ra[i];
#pragma unroll
    for (int i = 0; i < B_LD; ++i)
      *reinterpret_cast<float4*>(
          Bs + (buf * BK + bk + THREADS / B_TPR * i) * BS + bn) = rb[i];
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  float part[MT][NT][4];  // this chunk's sum, started from 0
  load(0);
  store(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
    if (kc + 1 < nk) load(kc + 1);  // in flight while this chunk computes
    const float* a_s = As + buf * BM * AS;
    const float* b_s = Bs + buf * BK * BS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* r = a_s + (wm + mt * 16 + g) * AS + kk + tg;
        split(r[0], ah[mt][0], al[mt][0]);
        split(r[8 * AS], ah[mt][1], al[mt][1]);
        split(r[4], ah[mt][2], al[mt][2]);
        split(r[8 * AS + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* c = b_s + (kk + tg) * BS + wn + nt * 8 + g;
        split(c[0], bh[nt][0], bl[nt][0]);
        split(c[4 * BS], bh[nt][1], bl[nt][1]);
      }
      mma_3xtf32<MT, NT>(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    if (kc + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = m0 + wm + mt * 16 + g + 8 * (i >> 1);
        const int co = n0 + wn + nt * 8 + 2 * tg + (i & 1);
        if (p >= M || co >= C) continue;
        const size_t off = (size_t)p * C + co;
        float v = acc[mt][nt][i] + bias[co];
        if (s != nullptr) {
          v = v * s[co] + t[co];
          if (idn != nullptr) v += idn[off];
        }
        out[off] = fmaxf(v, 0.f);
      }
}

template <int BM, int BN>
int launch(const float* src, const float* w, const float* bias,
           const float* s, const float* t, const float* idn, float* out,
           int M, int H, int W, int C, int axis, cudaStream_t st) {
  const dim3 grid((M + BM - 1) / BM, (C + BN - 1) / BN);
  const size_t smem = smem_bytes<BM, BN>();
  nbt1d_conv_kernel<BM, BN><<<grid, THREADS, smem, st>>>(
      src, w, bias, s, t, idn, out, M, H, W, C, axis);
  return (int)cudaGetLastError();
}

int conv(int bm, const float* src, const float* w, const float* bias,
         const float* s, const float* t, const float* idn, float* out, int M,
         int H, int W, int C, int axis, cudaStream_t st) {
  return bm == 64 ? launch<64, 64>(src, w, bias, s, t, idn, out, M, H, W, C,
                                   axis, st)
                  : launch<32, 32>(src, w, bias, s, t, idn, out, M, H, W, C,
                                   axis, st);
}

}  // namespace

// One pair: launch 1 (3x1, rows) x -> h, launch 2 (1x3, columns) h -> out.
// idn == nullptr: pair 1; else pair 2 (+identity before the relu). h is an
// (N, H, W, C) scratch map the caller allocates.
extern "C" int dynmm_nbt1d_pair(const float* x, const float* idn,
                                const float* wr, const float* br,
                                const float* wc, const float* bc,
                                const float* s, const float* t, float* h,
                                float* out, int N, int H, int W, int C,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = N * H * W;
  if (M == 0 || C == 0) return 0;
  const long blocks64 = (long)((M + 63) / 64) * ((C + 63) / 64);
  const int bm = blocks64 < 2 * SMS ? 32 : 64;
  const int err = conv(bm, x, wr, br, nullptr, nullptr, nullptr, h, M, H, W, C,
                       0, st);
  if (err != 0) return err;
  return conv(bm, h, wc, bc, s, t, idn, out, M, H, W, C, 1, st);
}

#ifdef DYNMM_EMULATED
// The emulation's TF32 split, for the tests: hi[i], lo[i] of v[i].
extern "C" void dynmm_emu_tf32_split(const float* v, unsigned* hi,
                                     unsigned* lo, int n) {
  for (int i = 0; i < n; ++i) split(v[i], hi[i], lo[i]);
}
#endif
