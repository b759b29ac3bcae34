// Stem SE-fusion + dual max-pool kernel for Hopper (sm_90a), fp32 and bf16.
//
// Replaces dynmm_tpu/kernels/stem_fuse.py::fused_stem_fusion
// (_fuse_pool_kernel), the second pass of the stem cell:
//   fused = rgb*s_r + depth*s_d
//   out_f = maxpool3x3/s2/pad1(fused), out_d = maxpool3x3/s2/pad1(depth)
// writing only the two pooled maps; the full-resolution fused map never
// reaches device memory. Pass 1 (the channel sums) is se.cu's
// dynmm_channel_sums; the SE MLP on (B, C) stays in PyTorch ops, as the JAX
// cell leaves it to XLA.
//
// Bound on this card: bytes (two (B,H,W,C) reads, two (B,H/2,W/2,C) writes).
//
// Design: one thread per output float4 (4 channels of one pooled pixel).
// It walks its 3x3 window directly; the rows a window shares with its
// neighbours come from L1/L2, so device memory sees each input about once.
// Padding cells are skipped, which is max-pool's -inf padding: a padded cell
// never wins (the TPU kernel replicated an edge row for the same effect).
//
// bf16 form (the element type T, elem.cuh): bf16 maps and scales (the
// caller rounds the scales to bf16, as the JAX cell does); rgb*s_r,
// depth*s_d and their sum are each rounded to bf16, as the Pallas function
// computes in bf16 op by op, so the max-pools see the same values: its
// plain version is bit-identical. Four channels load as 8 bytes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "elem.cuh"

// rgb*s_r + depth*s_d, rounded op by op for bf16
template <class T>
__device__ __forceinline__ float fuse(float a, float sr, float d, float sd) {
  return rnd<T>(rnd<T>(a * sr) + rnd<T>(d * sd));
}

template <class T>
__global__ void stem_fuse_pool_kernel(const T* __restrict__ rgb,
                                      const T* __restrict__ depth,
                                      const T* __restrict__ s_r,
                                      const T* __restrict__ s_d,
                                      T* __restrict__ out_f,
                                      T* __restrict__ out_d, int B, int H,
                                      int W, int C4, int OH, int OW) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)B * OH * OW * C4;
  if (idx >= total) return;
  const int c4 = (int)(idx % C4);
  long r = idx / C4;
  const int ox = (int)(r % OW);
  r /= OW;
  const int oy = (int)(r % OH);
  const int n = (int)(r / OH);
  const float4 sr = load4(s_r + ((size_t)n * C4 + c4) * 4);
  const float4 sd = load4(s_d + ((size_t)n * C4 + c4) * 4);
  const float ninf = -CUDART_INF_F;
  float4 mf = make_float4(ninf, ninf, ninf, ninf);
  float4 md = mf;
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - 1 + dy;
    if (iy < 0 || iy >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - 1 + dx;
      if (ix < 0 || ix >= W) continue;
      const size_t off = (((size_t)n * H + iy) * W + ix) * C4 + c4;
      const float4 a = load4(rgb + off * 4);
      const float4 d = load4(depth + off * 4);
      mf.x = fmaxf(mf.x, fuse<T>(a.x, sr.x, d.x, sd.x));
      mf.y = fmaxf(mf.y, fuse<T>(a.y, sr.y, d.y, sd.y));
      mf.z = fmaxf(mf.z, fuse<T>(a.z, sr.z, d.z, sd.z));
      mf.w = fmaxf(mf.w, fuse<T>(a.w, sr.w, d.w, sd.w));
      md.x = fmaxf(md.x, d.x);
      md.y = fmaxf(md.y, d.y);
      md.z = fmaxf(md.z, d.z);
      md.w = fmaxf(md.w, d.w);
    }
  }
  // maxima of values of T: the stores round nothing
  store4(out_f + idx * 4, mf);
  store4(out_d + idx * 4, md);
}

template <class T>
static int stem_fuse_pool(const T* rgb, const T* depth, const T* s_r,
                          const T* s_d, T* out_f, T* out_d, int B, int H,
                          int W, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int OH = (H - 1) / 2 + 1, OW = (W - 1) / 2 + 1, C4 = C / 4;
  const long total = (long)B * OH * OW * C4;
  const int threads = 256;
  const long blocks = (total + threads - 1) / threads;
  stem_fuse_pool_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      rgb, depth, s_r, s_d, out_f, out_d, B, H, W, C4, OH, OW);
  return (int)cudaGetLastError();
}

// C % 4 == 0 (the wrapper checks). OH = (H-1)/2 + 1, OW = (W-1)/2 + 1.
extern "C" int dynmm_stem_fuse_pool(const float* rgb, const float* depth,
                                    const float* s_r, const float* s_d,
                                    float* out_f, float* out_d, int B, int H,
                                    int W, int C, void* stream) {
  return stem_fuse_pool(rgb, depth, s_r, s_d, out_f, out_d, B, H, W, C,
                        stream);
}

// The bf16 form: maps, scales and outputs bf16.
extern "C" int dynmm_stem_fuse_pool_bf16(const bf16* rgb, const bf16* depth,
                                         const bf16* s_r, const bf16* s_d,
                                         bf16* out_f, bf16* out_d, int B,
                                         int H, int W, int C, void* stream) {
  return stem_fuse_pool(rgb, depth, s_r, s_d, out_f, out_d, B, H, W, C,
                        stream);
}
