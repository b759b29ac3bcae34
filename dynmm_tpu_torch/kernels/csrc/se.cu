// Squeeze-and-excite kernels for Hopper (sm_90a), fp32.
//
// Replaces two TPU kernels of the JAX package:
//   * dynmm_tpu/kernels/stem_fuse.py::channel_sums (_sums_kernel): per-sample
//     per-channel sums of one or two (B, HW, C) maps in one read;
//   * dynmm_tpu/kernels/se.py::fused_se (_se_kernel): mean -> @w1+b1 -> relu
//     -> @w2+b2 -> sigmoid -> x*s, here in the two-map mixed form that the
//     main path's fusion cells use,
//       out = rgb*(w + (1-w)*s_r) + depth*((1-w)*s_d).
//
// Bound on this card: bytes. The sums read each map once; the mix reads both
// maps again and writes one (the reduction forces two passes). The SE MLP is
// C*C/16*2 multiply-adds per sample and map, nothing next to the maps.
//
// Design: the TPU kernel carried its sum across a sequential grid; Hopper
// blocks run in no order, so pass 1 writes per-block partial sums and a
// second small kernel adds them in a fixed order (deterministic, no atomics).
// The mix kernel recomputes the two tiny MLPs in every block from the sums
// (a few thousand multiply-adds) instead of launching a third kernel.

#include <cuda_runtime.h>

// grid (S, B, maps); blockDim = P*C. Thread (p, c) sums channel c over the
// pixels p, p+P, ... of split s; the P lanes of a channel then reduce in
// shared memory. Neighbouring threads read neighbouring channels.
__global__ void sums_partial_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    float* __restrict__ partial,
                                    int HW, int C, int S, int P) {
  extern __shared__ float red[];
  const float* x = blockIdx.z == 0 ? a : b;
  const int s = blockIdx.x, n = blockIdx.y;
  const int p = threadIdx.x / C, c = threadIdx.x % C;
  const long chunk = ((long)HW + S - 1) / S;
  const long q0 = (long)s * chunk;
  const long q1 = q0 + chunk < HW ? q0 + chunk : (long)HW;
  const float* xs = x + (size_t)n * HW * C;
  float acc = 0.f;
#pragma unroll 4
  for (long q = q0 + p; q < q1; q += P) acc += xs[(size_t)q * C + c];
  red[threadIdx.x] = acc;
  __syncthreads();
  if (p == 0) {
    float tot = 0.f;
    for (int k = 0; k < P; ++k) tot += red[k * C + c];
    partial[(((size_t)blockIdx.z * gridDim.y + n) * S + s) * C + c] = tot;
  }
}

// grid (B, maps): adds the S partials of each (sample, channel) in order.
__global__ void sums_finalize_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out_a,
                                     float* __restrict__ out_b, int S, int C) {
  const int n = blockIdx.x, m = blockIdx.y, B = gridDim.x;
  float* out = m == 0 ? out_a : out_b;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* p = partial + ((size_t)m * B + n) * S * C + c;
    float tot = 0.f;
    for (int s = 0; s < S; ++s) tot += p[(size_t)s * C];
    out[(size_t)n * C + c] = tot;
  }
}

// b == nullptr sums one map. partial holds maps*B*S*C floats.
extern "C" int dynmm_channel_sums(const float* a, const float* b,
                                  float* partial, float* out_a, float* out_b,
                                  int B, int HW, int C, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int maps = b == nullptr ? 1 : 2;
  int P = 256 / C;
  if (P < 1) P = 1;
  dim3 grid(S, B, maps);
  sums_partial_kernel<<<grid, P * C, P * C * sizeof(float), st>>>(
      a, b, partial, HW, C, S, P);
  dim3 grid2(B, maps);
  int threads = C < 1024 ? C : 1024;
  sums_finalize_kernel<<<grid2, threads, 0, st>>>(partial, out_a, out_b, S, C);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

// grid (chunks, B); each block first rebuilds sample n's scale vectors from
// the channel sums, then mixes its chunk of float4s.
//   hidden_m = relu(mean_m @ w1_m + b1_m); s_m = sigmoid(hidden_m @ w2_m + b2_m)
//   out = x_r * (w + (1-w)*s_r) + x_d * ((1-w)*s_d)
// x_d == nullptr: single-map SE (out = x_r * s_r, with w = 0).
// w_rgb == nullptr means w = 0. Weights: w1 (C, Cr), w2 (Cr, C) as in JAX.
__global__ void se_mix_kernel(const float4* __restrict__ x_r,
                              const float4* __restrict__ x_d,
                              const float* __restrict__ sum_r,
                              const float* __restrict__ sum_d,
                              const float* __restrict__ w1r,
                              const float* __restrict__ b1r,
                              const float* __restrict__ w2r,
                              const float* __restrict__ b2r,
                              const float* __restrict__ w1d,
                              const float* __restrict__ b1d,
                              const float* __restrict__ w2d,
                              const float* __restrict__ b2d,
                              const float* __restrict__ w_rgb,
                              float4* __restrict__ out, int HW, int C, int Cr,
                              long chunk4) {
  extern __shared__ float sm[];
  float* sr = sm;           // C
  float* sd = sr + C;       // C
  float* hr = sd + C;       // Cr
  float* hd = hr + Cr;      // Cr
  const int n = blockIdx.y;
  const bool two = x_d != nullptr;
  const float hw = (float)HW;

  for (int j = threadIdx.x; j < 2 * Cr; j += blockDim.x) {
    const bool dep = j >= Cr;
    if (dep && !two) continue;
    const int jj = dep ? j - Cr : j;
    const float* sums = (dep ? sum_d : sum_r) + (size_t)n * C;
    const float* w1 = dep ? w1d : w1r;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += (sums[c] / hw) * w1[(size_t)c * Cr + jj];
    acc += (dep ? b1d : b1r)[jj];
    (dep ? hd : hr)[jj] = fmaxf(acc, 0.f);
  }
  __syncthreads();
  const float w = w_rgb != nullptr ? w_rgb[n] : 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < Cr; ++j) a += hr[j] * w2r[(size_t)j * C + c];
    sr[c] = w + (1.f - w) * sigmoidf_(a + b2r[c]);
    if (two) {
      float d = 0.f;
      for (int j = 0; j < Cr; ++j) d += hd[j] * w2d[(size_t)j * C + c];
      sd[c] = (1.f - w) * sigmoidf_(d + b2d[c]);
    }
  }
  __syncthreads();

  const int C4 = C / 4;
  const long total4 = (long)HW * C4;
  const long e0 = (long)blockIdx.x * chunk4;
  const long e1 = e0 + chunk4 < total4 ? e0 + chunk4 : total4;
  const size_t base = (size_t)n * total4;
  for (long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const int c = (int)(e % C4) * 4;
    float4 r = x_r[base + e];
    float4 v = make_float4(r.x * sr[c], r.y * sr[c + 1], r.z * sr[c + 2],
                           r.w * sr[c + 3]);
    if (two) {
      float4 d = x_d[base + e];
      v.x += d.x * sd[c];
      v.y += d.y * sd[c + 1];
      v.z += d.z * sd[c + 2];
      v.w += d.w * sd[c + 3];
    }
    out[base + e] = v;
  }
}

// C % 4 == 0 (the wrapper checks). chunks blocks per sample.
extern "C" int dynmm_se_mix(const float* x_r, const float* x_d,
                            const float* sum_r, const float* sum_d,
                            const float* w1r, const float* b1r,
                            const float* w2r, const float* b2r,
                            const float* w1d, const float* b1d,
                            const float* w2d, const float* b2d,
                            const float* w_rgb, float* out, int B, int HW,
                            int C, int Cr, int chunks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long total4 = (long)HW * (C / 4);
  const long chunk4 = (total4 + chunks - 1) / chunks;
  dim3 grid(chunks, B);
  size_t smem = (size_t)(2 * C + 2 * Cr) * sizeof(float);
  se_mix_kernel<<<grid, 256, smem, st>>>(
      (const float4*)x_r, (const float4*)x_d, sum_r, sum_d, w1r, b1r, w2r,
      b2r, w1d, b1d, w2d, b2d, w_rgb, (float4*)out, HW, C, Cr, chunk4);
  return (int)cudaGetLastError();
}
