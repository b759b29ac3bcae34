// Learned x2 upsample kernel for Hopper (sm_90a), fp32 and bf16.
//
// Replaces dynmm_tpu/kernels/upsample.py::fused_learned_upsample (_kernel):
// nearest x2 followed by a zero-padded depthwise 3x3 conv plus bias
// ('learned-3x3-zeropad'), without writing the 4x nearest intermediate.
//
// Output pixel (2a+rp, 2b+cp) is a 2x2 stencil over the source:
//   out = bias + sum_{e,f in {0,1}} T[rp][cp][e][f] * x[a+rp+e-1][b+cp+f-1]
// with taps pre-summed from the 3x3 kernel by the groups of the TPU kernel
// (_GROUPS): parity 0 takes {k0} at offset 0 and {k1+k2} at offset 1,
// parity 1 takes {k0+k1} at offset 0 and {k2} at offset 1 (offsets in the
// source padded by one). Zero padding of the upsampled map is zero padding of
// the source, so out-of-range source cells read as 0.
//
// Bound on this card: bytes (one read of x, one write of the 4x output; the
// write is 80 % of them).
//
// Design: a thread owns V consecutive channels (V = 4: one float4) of one
// output column ox = 2b+cp and walks down a strip of S source rows, D rows a
// step. Its window, the two source columns b+cp-1 and b+cp that its column
// reads, slides down in registers: a step loads only the next D rows' cells
// (their loads in flight together), and the thread forms its 8 taps (the
// column phase cp's half of the 16) and the bias once, not once per pixel.
// Each source row gives the thread two output pixels, rows 2a and 2a+1, as
// V-wide streaming stores (st.global.cs: the output is not read again by
// this kernel, so it need not displace the source from L2). Consecutive
// threads take consecutive (output column, channel group) pairs, so every
// store of a warp covers 512 contiguous bytes of an output row whatever C
// is (C = 40: ten float4s a pixel); the four threads that read a source
// cell in a step meet in L1. Index math is 32-bit
// within a sample (the wrapper checks that an output sample has fewer than
// 2^31 floats), one division per thread. V = 1 takes C % 4 != 0 or pointers
// that are not 16-byte aligned. The strip is the longest (up to UP_STRIP_MAX
// rows) that still gives two blocks per SM.
//
// Measured against it per dense B=8 forward on an H100 (bench_cells.py):
// 0.29 ms. A thread per source pixel writing its 2x2 quad (a 3x3 window and
// all 16 taps, 154 registers at D = 2) took 0.34; the same with one row a
// step (D = 1), 0.57: one row's loads are too few to cover the latency.
// This design with plain stores: 0.31 at D = 4 or 8; streaming stores at
// D = 2: 0.30.
//
// bf16 form (the element type E, elem.cuh): bf16 map, taps and bias (the
// bf16-cast parameters that the JAX model and the Pallas function see);
// the tap sums and the stencil run in fp32 and each output rounds once, at
// the store. V = 4 moves four channels as 8 bytes; the vector path needs
// 8-byte aligned pointers.

#include <cuda_runtime.h>
#include <cstdint>

#include "elem.cuh"

constexpr int UP_THREADS = 256;
constexpr int UP_STRIP_MAX = 16;
constexpr int UP_ROWS = 4;  // source rows a step loads together (D)

template <int V, class E>
__device__ __forceinline__ void load_vec(float (&d)[V], const E* p) {
  if constexpr (V == 4) {
    const float4 t = load4(p);
    d[0] = t.x;
    d[1] = t.y;
    d[2] = t.z;
    d[3] = t.w;
  } else {
    d[0] = to_f(*p);
  }
}

template <int V, class E>
__device__ __forceinline__ void store_vec(E* p, const float (&s)[V]) {
  if constexpr (V == 4) {
    store4(p, make_float4(s[0], s[1], s[2], s[3]), true);
  } else {
    *p = from_f<E>(s[0]);
  }
}

// v[f] = x[row][col0+f] (channels c..c+V-1), zero outside the map
template <int V, class E>
__device__ __forceinline__ void load_cells(float (&v)[2][V],
                                           const E* __restrict__ xs,
                                           int row, int col0, int c, int H,
                                           int W, int C) {
  const bool in = row >= 0 && row < H;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int col = col0 + f;
    if (in && col >= 0 && col < W) {
      load_vec<V, E>(v[f], xs + (row * W + col) * C + c);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[f][i] = 0.f;
    }
  }
}

// grid (ceil(2W*C/V / UP_THREADS), ceil(H/S), N)
template <int V, int D, class E>
__global__ void __launch_bounds__(UP_THREADS)
    learned_upsample_kernel(const E* __restrict__ x, const E* __restrict__ k,
                            const E* __restrict__ bias, E* __restrict__ out,
                            int H, int W, int C, int S) {
  const int CG = C / V;
  const int t = blockIdx.x * UP_THREADS + threadIdx.x;
  if (t >= 2 * W * CG) return;
  const int ox = t / CG;
  const int c = (t - ox * CG) * V;
  const int cp = ox & 1, col0 = (ox >> 1) + cp - 1;
  const int n = blockIdx.z;
  const int a0 = blockIdx.y * S;
  const int a1 = a0 + S < H ? a0 + S : H;

  // T[rp][e][f][i]: the stencil of output phase (rp, cp), channel c+i
  float T[2][2][2][V], bc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float kk[3][3];  // kk[du][dv], the 3x3 taps of channel c+i
#pragma unroll
    for (int du = 0; du < 3; ++du)
#pragma unroll
      for (int dv = 0; dv < 3; ++dv)
        kk[du][dv] = to_f(k[(du * 3 + dv) * C + c + i]);
#pragma unroll
    for (int rp = 0; rp < 2; ++rp)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float R[3];  // kernel rows grouped by output row parity
#pragma unroll
        for (int dv = 0; dv < 3; ++dv)
          R[dv] = rp == 0 ? (e == 0 ? kk[0][dv] : kk[1][dv] + kk[2][dv])
                          : (e == 0 ? kk[0][dv] + kk[1][dv] : kk[2][dv]);
        // the same grouping over columns
        T[rp][e][0][i] = cp == 0 ? R[0] : R[0] + R[1];
        T[rp][e][1][i] = cp == 0 ? R[1] + R[2] : R[2];
      }
    bc[i] = to_f(bias[c + i]);
  }

  const E* xs = x + (size_t)n * H * W * C;
  E* os = out + (size_t)n * 4 * H * W * C + ox * C + c;
  const int OWC = 2 * W * C;  // floats in an output row
  float v[D + 2][2][V];       // v[i][f] = x[a-1+i][col0+f]
  load_cells<V, E>(v[0], xs, a0 - 1, col0, c, H, W, C);
  load_cells<V, E>(v[1], xs, a0, col0, c, H, W, C);
  for (int a = a0; a < a1; a += D) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      load_cells<V, E>(v[2 + d], xs, a + 1 + d, col0, c, H, W, C);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d > 0 && a + d >= a1) break;
#pragma unroll
      for (int rp = 0; rp < 2; ++rp) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float acc = bc[i];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc += T[rp][e][0][i] * v[d + rp + e][0][i] +
                   T[rp][e][1][i] * v[d + rp + e][1][i];
          o[i] = acc;
        }
        store_vec<V, E>(os + (2 * (a + d) + rp) * OWC, o);
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v[0][f][i] = v[D][f][i];
        v[1][f][i] = v[D + 1][f][i];
      }
  }
}

template <class E>
static int learned_upsample(const E* x, const E* k, const E* bias, E* out,
                            int N, int H, int W, int C, int sms,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t align = 4 * sizeof(E) - 1;  // a V = 4 access
  const bool vec = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                   reinterpret_cast<uintptr_t>(out)) &
                                  align) == 0;
  const int cols = 2 * W * (vec ? C / 4 : C);
  const int bx = (cols + UP_THREADS - 1) / UP_THREADS;
  // the longest strip up to UP_STRIP_MAX rows that leaves two blocks per SM
  const long fill = (long)N * H * bx / (2L * (sms > 0 ? sms : 1));
  const int S = fill < 1 ? 1 : fill > UP_STRIP_MAX ? UP_STRIP_MAX : (int)fill;
  dim3 grid(bx, (H + S - 1) / S, N);
  if (vec)
    learned_upsample_kernel<4, UP_ROWS, E>
        <<<grid, UP_THREADS, 0, st>>>(x, k, bias, out, H, W, C, S);
  else
    learned_upsample_kernel<1, UP_ROWS, E>
        <<<grid, UP_THREADS, 0, st>>>(x, k, bias, out, H, W, C, S);
  return (int)cudaGetLastError();
}

// sms: the card's SM count, which sets the strip.
extern "C" int dynmm_learned_upsample(const float* x, const float* k,
                                      const float* bias, float* out, int N,
                                      int H, int W, int C, int sms,
                                      void* stream) {
  return learned_upsample(x, k, bias, out, N, H, W, C, sms, stream);
}

// The bf16 form: map, taps, bias and output bf16.
extern "C" int dynmm_learned_upsample_bf16(const bf16* x, const bf16* k,
                                           const bf16* bias, bf16* out, int N,
                                           int H, int W, int C, int sms,
                                           void* stream) {
  return learned_upsample(x, k, bias, out, N, H, W, C, sms, stream);
}
