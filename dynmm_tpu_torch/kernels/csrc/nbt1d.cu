// NonBottleneck1D conv-pair kernel for Hopper (sm_90a), fp32.
//
// Replaces dynmm_tpu/kernels/nbt1d.py::_run_pair (_pair_kernel), the unit of
// fused_nbt1d_twopass. One launch computes one conv pair of a stride-1
// NonBottleneck1D block:
//   h   = relu(3x1 conv(x) + br), zero outside the image columns
//   out = relu((1x3 conv(h) + bc) * s + t [+ identity])
// with BN folded into (s, t) (eps 1e-3) and taps packed as (3, C_in, C_out).
// A block is two launches: pair 1 without identity, pair 2 with +x.
//
// Bound on this card: operations. Each pair does 2 * 3 * C * C multiply-adds
// per pixel (7.5 GFLOP for one pair at B=8, 120x160, C=64) against one read
// of x (and the identity) and one write; in fp32 on CUDA cores the card's
// 67 TFLOP/s bound it, not its 3.35 TB/s.
//
// Design (simple, right first): one block per (image row, column tile of TW)
// of one sample, one thread per output channel (blockDim = C up to 512,
// looping above). The 3x1 conv output for the tile plus its 1-column halo
// goes to shared memory (C x (TW+2) floats, 48 KB at C = 512, TW = 20); the
// 1x3 conv then reads it from there. The 3x1 conv stages x in chunks of 32
// input channels. Weights are read straight from global memory: neighbouring
// threads read neighbouring output channels, and L2 holds the (3, C, C) taps.
// The masks the TPU kernel needs (nbt1d.py:74-77, :82-91, :96-98) reduce to
// two rules here: x rows and columns outside the image read as 0, and h at a
// column outside the image is 0 (not relu(br)), because torch zero-pads the
// activation between the two convs.

#include <cuda_runtime.h>

namespace {

constexpr int KC = 32;  // input channels staged per step of the 3x1 conv

template <int TW>
struct Tile {
  static constexpr int TH = TW + 2;              // h columns incl. halo
  static constexpr int TP = (TH + 3) / 4 * 4;    // padded to float4
  static size_t smem_bytes(int C) {
    return (size_t)(C * TP + 3 * KC * TP) * sizeof(float);
  }
};

template <int TW>
__global__ void __launch_bounds__(512)
    nbt1d_pair_kernel(const float* __restrict__ x,
                      const float* __restrict__ idn,
                      const float* __restrict__ wr,
                      const float* __restrict__ br,
                      const float* __restrict__ wc,
                      const float* __restrict__ bc,
                      const float* __restrict__ s,
                      const float* __restrict__ t, float* __restrict__ out,
                      int H, int W, int C) {
  constexpr int TH = Tile<TW>::TH;
  constexpr int TP = Tile<TW>::TP;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [C][TP]
  float* xs = hs + (size_t)C * TP;               // [3][KC][TP]

  const int c0 = blockIdx.x * TW;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  const float* xn = x + (size_t)n * H * W * C;

  // ---- 3x1 conv + bias + relu over columns c0-1 .. c0+TW -> hs
  for (int co0 = 0; co0 < C; co0 += blockDim.x) {
    const int co = co0 + threadIdx.x;
    float acc[TP];
#pragma unroll
    for (int j = 0; j < TP; ++j) acc[j] = 0.f;
    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      const int kc = C - ci0 < KC ? C - ci0 : KC;
      __syncthreads();  // every thread is done with the previous chunk
      for (int e = threadIdx.x; e < 3 * TP * KC; e += blockDim.x) {
        const int k = e % KC;
        const int j = (e / KC) % TP;
        const int d = e / (KC * TP);
        const int yy = y + d - 1, xx = c0 - 1 + j;
        float v = 0.f;
        if (k < kc && j < TH && yy >= 0 && yy < H && xx >= 0 && xx < W)
          v = xn[((size_t)yy * W + xx) * C + ci0 + k];
        xs[(d * KC + k) * TP + j] = v;
      }
      __syncthreads();
      if (co < C) {
        for (int d = 0; d < 3; ++d) {
          const float* wd = wr + ((size_t)d * C + ci0) * C + co;
#pragma unroll 4
          for (int k = 0; k < kc; ++k) {
            const float w = wd[(size_t)k * C];
            const float4* row =
                reinterpret_cast<const float4*>(xs + (d * KC + k) * TP);
#pragma unroll
            for (int q = 0; q < TP / 4; ++q) {
              const float4 v = row[q];
              acc[4 * q + 0] += v.x * w;
              acc[4 * q + 1] += v.y * w;
              acc[4 * q + 2] += v.z * w;
              acc[4 * q + 3] += v.w * w;
            }
          }
        }
      }
    }
    if (co < C) {
      const float b = br[co];
#pragma unroll
      for (int j = 0; j < TP; ++j) {
        const int col = c0 - 1 + j;
        const bool inside = j < TH && col >= 0 && col < W;
        hs[(size_t)co * TP + j] = inside ? fmaxf(acc[j] + b, 0.f) : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- 1x3 conv + bias -> folded BN -> [+identity] -> relu
  for (int co0 = 0; co0 < C; co0 += blockDim.x) {
    const int co = co0 + threadIdx.x;
    if (co >= C) continue;
    float acc[TW];
#pragma unroll
    for (int j = 0; j < TW; ++j) acc[j] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const float w0 = wc[((size_t)0 * C + ci) * C + co];
      const float w1 = wc[((size_t)1 * C + ci) * C + co];
      const float w2 = wc[((size_t)2 * C + ci) * C + co];
      float hv[TP];
      const float4* row = reinterpret_cast<const float4*>(hs + (size_t)ci * TP);
#pragma unroll
      for (int q = 0; q < TP / 4; ++q) {
        const float4 v = row[q];
        hv[4 * q + 0] = v.x;
        hv[4 * q + 1] = v.y;
        hv[4 * q + 2] = v.z;
        hv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TW; ++j)
        acc[j] += hv[j] * w0 + hv[j + 1] * w1 + hv[j + 2] * w2;
    }
    const float b = bc[co], sc = s[co], sh = t[co];
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const int col = c0 + j;
      if (col >= W) continue;
      const size_t off = (((size_t)n * H + y) * W + col) * C + co;
      float v = (acc[j] + b) * sc + sh;
      if (idn != nullptr) v += idn[off];
      out[off] = fmaxf(v, 0.f);
    }
  }
}

template <int TW>
int launch(const float* x, const float* idn, const float* wr, const float* br,
           const float* wc, const float* bc, const float* s, const float* t,
           float* out, int N, int H, int W, int C, cudaStream_t st) {
  const size_t smem = Tile<TW>::smem_bytes(C);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nbt1d_pair_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = (C + 31) / 32 * 32;
  if (threads > 512) threads = 512;
  dim3 grid((W + TW - 1) / TW, H, N);
  nbt1d_pair_kernel<TW><<<grid, threads, smem, st>>>(x, idn, wr, br, wc, bc, s,
                                                     t, out, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// idn == nullptr: pair 1 (relu after the affine); else pair 2 (+identity,
// then relu). Tile width: 16 or 20 where it divides W (no idle columns at the
// flagship's 160/80/40/20), else 8, else 16 with the ragged edge masked.
extern "C" int dynmm_nbt1d_pair(const float* x, const float* idn,
                                const float* wr, const float* br,
                                const float* wc, const float* bc,
                                const float* s, const float* t, float* out,
                                int N, int H, int W, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (W % 16 == 0)
    return launch<16>(x, idn, wr, br, wc, bc, s, t, out, N, H, W, C, st);
  if (W % 20 == 0)
    return launch<20>(x, idn, wr, br, wc, bc, s, t, out, N, H, W, C, st);
  if (W % 8 == 0)
    return launch<8>(x, idn, wr, br, wc, bc, s, t, out, N, H, W, C, st);
  return launch<16>(x, idn, wr, br, wc, bc, s, t, out, N, H, W, C, st);
}
