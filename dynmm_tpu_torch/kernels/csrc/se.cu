// Squeeze-and-excite kernels for Hopper (sm_90a), fp32 and bf16.
//
// Replaces two TPU kernels of the JAX package:
//   * dynmm_tpu/kernels/stem_fuse.py::channel_sums (_sums_kernel): per-sample
//     per-channel sums of two (B, HW, C) maps in one read (the stem
//     cell's pass 1);
//   * dynmm_tpu/kernels/se.py::fused_se (_se_kernel): mean -> @w1+b1 -> relu
//     -> @w2+b2 -> sigmoid -> x*s, here in the two-map mixed form that the
//     main path's fusion cells use,
//       out = rgb*(w + (1-w)*s_r) + depth*((1-w)*s_d).
//
// Bound on this card: bytes. The sums read each map once; the mix reads both
// maps again and writes one (the reduction forces two passes). The SE MLP is
// C*C/16*2 multiply-adds per sample and map, nothing next to the maps.
//
// channel_sums: the TPU kernel carried its sum across a sequential grid;
// Hopper blocks run in no order, so pass 1 writes per-block partial sums and
// a second small kernel adds them in a fixed order (deterministic).
//
// The SE cell (dynmm_se_fuse) takes two launches. The TPU kernel held a
// sample's map in VMEM and did mean -> MLP -> x*s in one pass; Hopper blocks
// cannot share a sample's map, so:
//   1. se_squeeze_kernel, grid (S, B): each block sums its chunk of pixels of
//      both maps (float4 loads) and writes its per-channel partial sums. The
//      last block of each sample to finish (an atomicAdd ticket on a
//      per-sample counter, after __threadfence) adds the S partials in block
//      order (deterministic: the order depends on B, HW, C and the grid, never
//      on the data), runs both SE MLPs once, folds in w and writes
//      s_r' = w + (1-w)*s_r and s_d' = (1-w)*s_d, then resets its counter to
//      0 for the next launch.
//   2. se_mix_kernel, the same grid: out = x_r*s_r' + x_d*s_d', float4, each
//      thread's scales loaded once, its channel groups fixed by the layout.
//      Blocks run in the reverse of the squeeze's order, so the first to run
//      read the pixels the squeeze read last, still in L2.
// S comes from the card's SM count (the wrapper's rule), the same S for both.
// Both kernels take G, the float4 channel groups a thread owns, as a template
// parameter that the host picks from C: up to C = 1024, G = 1, one group a
// thread beside other pixel lanes; above, up to C = 2048 (ResNet50's
// stage-4 cell), G = 2, two groups at one pixel lane. At C = 2048 the finalize's serial tail reads
// both MLPs' weights, 4 MiB a sample, in the sample's last block.
//
// bf16 forms (the map type T, elem.cuh; four channels load as 8 bytes, the
// indexing is the fp32 form's): channel_sums reads bf16 maps and writes
// fp32 sums. The SE cell rounds where the Pallas fused_se does at bf16:
// the per-channel means (fp32 sums / HW) to bf16, the MLP in fp32 with the
// fp32 weights, the scale to bf16; the gate mix w + (1-w)*s and (1-w)*s
// op by op in bf16 (w rounded first), as the JAX model's fuse_mixed; in
// the mix each product and the sum are rounded. Partial sums and scales
// stay fp32 buffers (the scales hold bf16 values).

#include <cuda_runtime.h>
#include <cstdint>

#include "elem.cuh"

// grid (S, B, 2); blockDim = P*C. Thread (p, c) sums channel c over the
// pixels p, p+P, ... of split s; the P lanes of a channel then reduce in
// shared memory. Neighbouring threads read neighbouring channels.
template <class T>
__global__ void sums_partial_kernel(const T* __restrict__ a,
                                    const T* __restrict__ b,
                                    float* __restrict__ partial,
                                    int HW, int C, int S, int P) {
  extern __shared__ float red[];
  const T* x = blockIdx.z == 0 ? a : b;
  const int s = blockIdx.x, n = blockIdx.y;
  const int p = threadIdx.x / C, c = threadIdx.x % C;
  const long chunk = ((long)HW + S - 1) / S;
  const long q0 = (long)s * chunk;
  const long q1 = q0 + chunk < HW ? q0 + chunk : (long)HW;
  const T* xs = x + (size_t)n * HW * C;
  float acc = 0.f;
#pragma unroll 4
  for (long q = q0 + p; q < q1; q += P) acc += to_f(xs[(size_t)q * C + c]);
  red[threadIdx.x] = acc;
  __syncthreads();
  if (p == 0) {
    float tot = 0.f;
    for (int k = 0; k < P; ++k) tot += red[k * C + c];
    partial[(((size_t)blockIdx.z * gridDim.y + n) * S + s) * C + c] = tot;
  }
}

// grid (B, 2): adds the S partials of each (sample, channel) in order.
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

template <class T>
static int channel_sums(const T* a, const T* b, float* partial, float* out_a,
                        float* out_b, int B, int HW, int C, int S,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int P = 256 / C;
  if (P < 1) P = 1;
  dim3 grid(S, B, 2);
  sums_partial_kernel<T><<<grid, P * C, P * C * sizeof(float), st>>>(
      a, b, partial, HW, C, S, P);
  dim3 grid2(B, 2);
  int threads = C < 1024 ? C : 1024;
  sums_finalize_kernel<<<grid2, threads, 0, st>>>(partial, out_a, out_b, S, C);
  return (int)cudaGetLastError();
}

// partial holds 2*B*S*C floats; the sums are fp32 in both forms.
extern "C" int dynmm_channel_sums(const float* a, const float* b,
                                  float* partial, float* out_a, float* out_b,
                                  int B, int HW, int C, int S, void* stream) {
  return channel_sums(a, b, partial, out_a, out_b, B, HW, C, S, stream);
}

extern "C" int dynmm_channel_sums_bf16(const bf16* a, const bf16* b,
                                       float* partial, float* out_a,
                                       float* out_b, int B, int HW, int C,
                                       int S, void* stream) {
  return channel_sums(a, b, partial, out_a, out_b, B, HW, C, S, stream);
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

constexpr int SE_THREADS = 256;
// float4 channel groups a thread owns at most: C <= 4*SE_THREADS*SE_MAX_G
constexpr int SE_MAX_G = 2;

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Pixels [q0, q1) of split s of S over HW.
__device__ __forceinline__ void split_range(int HW, int S, int s, int& q0,
                                            int& q1) {
  const int chunk = (HW + S - 1) / S;
  q0 = s * chunk < HW ? s * chunk : HW;
  q1 = q0 + chunk < HW ? q0 + chunk : HW;
}

// The squeeze's and the mix's thread mapping over C4 = C/4 float4 channel
// groups, for G groups a thread (the host picks G from C): thread t =
// p*CT + gc owns the groups gc, gc+CT, ... below C4 at pixel lane p of
// P = SE_THREADS/CT, CT = ceil(C4/G). G = 1 (C <= 4*SE_THREADS): CT = C4,
// one group a thread beside other pixel lanes. G = 2 (C <= 8*SE_THREADS):
// two groups at one pixel lane.
template <int G>
__device__ __forceinline__ int se_ct(int C4) {
  return G == 1 ? C4 : (C4 + G - 1) / G;
}

// Thread's group k is a channel group: always for G = 1, where CT = C4.
template <int G>
__device__ __forceinline__ bool se_own(int g, int C4) {
  return G == 1 || g < C4;
}

// SE MLP weights of one map, in the JAX layout: w1 (C, Cr), w2 (Cr, C).
struct SeWeights {
  const float *w1, *b1, *w2, *b2;
};

// Floats of one map's lane sums: lane p's sum of channel c sits at p*C + c,
// and P*C <= max(4*SE_THREADS, C).
constexpr int se_red_floats(int C) {
  return C > 4 * SE_THREADS ? C : 4 * SE_THREADS;
}

// Shared memory (floats): the pixel lanes' sums [2][se_red_floats(C)], the
// ticket, then the finalize's means [2][C], layer-1 sums [2][SE_THREADS] and
// hidden units [2][Cr]. At C = 2048, Cr = 128: 35,856 bytes.
constexpr int se_smem_floats(int C, int Cr) {
  return 2 * se_red_floats(C) + 4 + 2 * C + 2 * SE_THREADS + 2 * Cr;
}

// grid (S, B), SE_THREADS threads, the se_ct<G> mapping: each thread sums
// its float4 groups over the pixels p, p+P, ... of its block's chunk. x_d ==
// nullptr: one map (fused_se). partial holds B*S*2*C floats, scales B*2*C,
// counter B zeros (left at zero). T: the maps' element type.
template <int G, class T>
__global__ void __launch_bounds__(SE_THREADS)
    se_squeeze_kernel(const T* __restrict__ x_r,
                      const T* __restrict__ x_d,
                      float* __restrict__ partial, float* __restrict__ scales,
                      unsigned* __restrict__ counter, SeWeights wr,
                      SeWeights wd, const float* __restrict__ w_rgb, int HW,
                      int C, int Cr) {
  extern __shared__ float sm[];
  const int S = gridDim.x, s = blockIdx.x, n = blockIdx.y;
  const int t = threadIdx.x, C4 = C / 4;
  const int CT = se_ct<G>(C4);
  const int P = SE_THREADS / CT;  // pixel lanes
  const int p = t / CT, gc = t - p * CT;
  const bool two = x_d != nullptr;
  const int RS = C > 4 * SE_THREADS ? C : 4 * SE_THREADS;  // se_red_floats

  float4 ar[G], ad[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    ar[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    ad[k] = ar[k];
  }
  if (p < P) {
    int q0, q1;
    split_range(HW, S, s, q0, q1);
    const size_t base = (size_t)n * HW * C;
    const T* xr = x_r + base;
    const T* xd = two ? x_d + base : nullptr;
#pragma unroll 4
    for (int q = q0 + p; q < q1; q += P) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int g = gc + k * CT;
        if (se_own<G>(g, C4)) {
          const int e = 4 * (q * C4 + g);
          add4(ar[k], load4(xr + e));
          if (two) add4(ad[k], load4(xd + e));
        }
      }
    }
  }
  // lane p's sum of channel c sits at sm[m*RS + p*C + c]
  float4* red4 = reinterpret_cast<float4*>(sm);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = gc + k * CT;
    if (p < P && se_own<G>(g, C4)) {
      red4[p * C4 + g] = ar[k];
      red4[RS / 4 + p * C4 + g] = ad[k];
    }
  }
  __syncthreads();
  float* part = partial + ((size_t)n * S + s) * 2 * C;
  for (int c = t; c < C; c += SE_THREADS) {
    float r = 0.f, d = 0.f;
    for (int k = 0; k < P; ++k) {
      r += sm[k * C + c];
      d += sm[RS + k * C + c];
    }
    part[c] = r;
    part[C + c] = d;
  }

  // the last block of sample n to get here runs the finalize
  unsigned* ticket = reinterpret_cast<unsigned*>(sm + 2 * RS);
  __threadfence();
  __syncthreads();
  if (t == 0) *ticket = atomicAdd(counter + n, 1u);
  __syncthreads();
  if (*ticket != (unsigned)S - 1) return;
  __threadfence();
  if (t == 0) counter[n] = 0;

  float* mean = sm + 2 * RS + 4;    // [2][C]
  float* l1 = mean + 2 * C;         // [2][SE_THREADS]
  float* hid = l1 + 2 * SE_THREADS; // [2][Cr]
  const int maps = two ? 2 : 1;
  const float* pn = partial + (size_t)n * S * 2 * C;
  for (int c = t; c < maps * C; c += SE_THREADS) {
    float tot = 0.f;
    for (int k = 0; k < S; ++k) tot += __ldcg(pn + (size_t)k * 2 * C + c);
    mean[c] = rnd<T>(tot / (float)HW);
  }
  __syncthreads();
  // layer 1, spread over the block: thread (slice, j) sums mean[c]*w1[c][j]
  // over c = slice, slice+NS, ...; consecutive threads read consecutive
  // weights. The NS slices of each hidden unit then add in slice order.
  const int NS = SE_THREADS / Cr;
  const int sl = t / Cr, j = t - sl * Cr;
  float hr = 0.f, hd = 0.f;
  if (sl < NS) {
    for (int c = sl; c < C; c += NS) {
      hr += mean[c] * wr.w1[c * Cr + j];
      if (two) hd += mean[C + c] * wd.w1[c * Cr + j];
    }
  }
  l1[t] = hr;
  l1[SE_THREADS + t] = hd;
  __syncthreads();
  for (int i = t; i < maps * Cr; i += SE_THREADS) {
    const int m = i >= Cr, jj = i - m * Cr;
    float acc = 0.f;
    for (int k = 0; k < NS; ++k) acc += l1[m * SE_THREADS + k * Cr + jj];
    acc += (m ? wd.b1 : wr.b1)[jj];
    hid[i] = fmaxf(acc, 0.f);
  }
  __syncthreads();
  // layer 2, one thread per channel, and the mix weight folded in
  const float w = rnd<T>(w_rgb != nullptr ? w_rgb[n] : 0.f);
  const float w1m = rnd<T>(1.f - w);
  float* sc = scales + (size_t)n * 2 * C;
  for (int c = t; c < C; c += SE_THREADS) {
    float a = 0.f, d = 0.f;
    for (int jj = 0; jj < Cr; ++jj) {
      a += hid[jj] * wr.w2[jj * C + c];
      if (two) d += hid[Cr + jj] * wd.w2[jj * C + c];
    }
    sc[c] = rnd<T>(w + rnd<T>(w1m * rnd<T>(sigmoidf_(a + wr.b2[c]))));
    sc[C + c] = two ? rnd<T>(w1m * rnd<T>(sigmoidf_(d + wd.b2[c]))) : 0.f;
  }
}

// grid (S, B), SE_THREADS threads, block (x, y) mixes chunk S-1-x of sample
// B-1-y: the reverse of the squeeze's order. The squeeze's thread mapping;
// each thread loads the scales of its groups once.
template <int G, class T>
__global__ void __launch_bounds__(SE_THREADS)
    se_mix_kernel(const T* __restrict__ x_r, const T* __restrict__ x_d,
                  const float4* __restrict__ scales, T* __restrict__ out,
                  int HW, int C) {
  const int S = gridDim.x;
  const int s = S - 1 - (int)blockIdx.x;
  const int n = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int t = threadIdx.x, C4 = C / 4;
  const int CT = se_ct<G>(C4);
  const int P = SE_THREADS / CT;
  const int p = t / CT, gc = t - p * CT;
  if (p >= P) return;
  const bool two = x_d != nullptr;
  float4 sr[G], sd[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = gc + k * CT;
    const bool own = se_own<G>(g, C4);
    sr[k] = own ? scales[(size_t)n * 2 * C4 + g]
                : make_float4(0.f, 0.f, 0.f, 0.f);
    sd[k] = own && two ? scales[(size_t)n * 2 * C4 + C4 + g]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int q0, q1;
  split_range(HW, S, s, q0, q1);
  const size_t base = (size_t)n * HW * C;
  const T* xr = x_r + base;
  const T* xd = two ? x_d + base : nullptr;
  T* o = out + base;
#pragma unroll 4
  for (int q = q0 + p; q < q1; q += P) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int g = gc + k * CT;
      if (se_own<G>(g, C4)) {
        const int e = 4 * (q * C4 + g);
        const float4 r = load4(xr + e);
        const float4 a = sr[k];
        float4 v = make_float4(rnd<T>(r.x * a.x), rnd<T>(r.y * a.y),
                               rnd<T>(r.z * a.z), rnd<T>(r.w * a.w));
        if (two) {
          const float4 d = load4(xd + e);
          const float4 b = sd[k];
          v.x = rnd<T>(v.x + rnd<T>(d.x * b.x));
          v.y = rnd<T>(v.y + rnd<T>(d.y * b.y));
          v.z = rnd<T>(v.z + rnd<T>(d.z * b.z));
          v.w = rnd<T>(v.w + rnd<T>(d.w * b.w));
        }
        store4(o + e, v);
      }
    }
  }
}

template <int G, class T>
static int se_launch(const T* x_r, const T* x_d, float* partial,
                     float* scales, unsigned* counter, SeWeights wr,
                     SeWeights wd, const float* w_rgb, T* out, int B,
                     int HW, int C, int Cr, int S, cudaStream_t st) {
  dim3 grid(S, B);
  const size_t smem = (size_t)se_smem_floats(C, Cr) * sizeof(float);
  se_squeeze_kernel<G, T><<<grid, SE_THREADS, smem, st>>>(
      x_r, x_d, partial, scales, counter, wr, wd, w_rgb, HW, C, Cr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  se_mix_kernel<G, T><<<grid, SE_THREADS, 0, st>>>(
      x_r, x_d, (const float4*)scales, out, HW, C);
  return (int)cudaGetLastError();
}

template <class T>
static int se_fuse(const T* x_r, const T* x_d, const float* w1r,
                   const float* b1r, const float* w2r, const float* b2r,
                   const float* w1d, const float* b1d, const float* w2d,
                   const float* b2d, const float* w_rgb, float* partial,
                   float* scales, unsigned* counter, T* out, int B, int HW,
                   int C, int Cr, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const SeWeights wr{w1r, b1r, w2r, b2r}, wd{w1d, b1d, w2d, b2d};
  if (C <= 4 * SE_THREADS)
    return se_launch<1, T>(x_r, x_d, partial, scales, counter, wr, wd, w_rgb,
                           out, B, HW, C, Cr, S, st);
  return se_launch<SE_MAX_G, T>(x_r, x_d, partial, scales, counter, wr, wd,
                                w_rgb, out, B, HW, C, Cr, S, st);
}

// The SE cell in two launches. C % 4 == 0, C <= 4*SE_THREADS*SE_MAX_G, Cr <=
// SE_THREADS and 16-byte aligned maps (8-byte for bf16; the wrapper
// checks); S splits per
// sample. x_d == nullptr: single-map SE (w = 0, the w*d weights unused).
// w_rgb == nullptr means w = 0. partial: B*S*2*C floats; scales: B*2*C;
// counter: B unsigned zeros, left at zero. The MLP weights and w_rgb are
// fp32 in both forms.
extern "C" int dynmm_se_fuse(const float* x_r, const float* x_d,
                             const float* w1r, const float* b1r,
                             const float* w2r, const float* b2r,
                             const float* w1d, const float* b1d,
                             const float* w2d, const float* b2d,
                             const float* w_rgb, float* partial,
                             float* scales, unsigned* counter, float* out,
                             int B, int HW, int C, int Cr, int S,
                             void* stream) {
  return se_fuse(x_r, x_d, w1r, b1r, w2r, b2r, w1d, b1d, w2d, b2d, w_rgb,
                 partial, scales, counter, out, B, HW, C, Cr, S, stream);
}

// The bf16 form: bf16 maps in and out (8-byte aligned).
extern "C" int dynmm_se_fuse_bf16(const bf16* x_r, const bf16* x_d,
                                  const float* w1r, const float* b1r,
                                  const float* w2r, const float* b2r,
                                  const float* w1d, const float* b1d,
                                  const float* w2d, const float* b2d,
                                  const float* w_rgb, float* partial,
                                  float* scales, unsigned* counter, bf16* out,
                                  int B, int HW, int C, int Cr, int S,
                                  void* stream) {
  return se_fuse(x_r, x_d, w1r, b1r, w2r, b2r, w1d, b1d, w2d, b2d, w_rgb,
                 partial, scales, counter, out, B, HW, C, Cr, S, stream);
}
