// Learned x2 upsample kernel for Hopper (sm_90a), fp32.
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
// Bound on this card: bytes (one read of x, one write of the 4x output).
//
// Design: one thread per source pixel and channel. It loads the 3x3 source
// neighbourhood and the channel's 9 taps once and writes its 2x2 output quad
// (all four phases), so neighbouring threads (neighbouring channels) read and
// write neighbouring addresses. Any C works, the C = 40 logits maps included.

#include <cuda_runtime.h>

__global__ void learned_upsample_kernel(const float* __restrict__ x,
                                        const float* __restrict__ k,
                                        const float* __restrict__ bias,
                                        float* __restrict__ out, int N, int H,
                                        int W, int C) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)N * H * W * C;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long r = idx / C;
  const int b = (int)(r % W);
  r /= W;
  const int a = (int)(r % H);
  const int n = (int)(r / H);

  float v[3][3];  // v[i][j] = x[a-1+i][b-1+j], zero outside the map
  for (int i = 0; i < 3; ++i) {
    const int ya = a - 1 + i;
    for (int j = 0; j < 3; ++j) {
      const int xb = b - 1 + j;
      v[i][j] = (ya >= 0 && ya < H && xb >= 0 && xb < W)
                    ? x[(((size_t)n * H + ya) * W + xb) * C + c]
                    : 0.f;
    }
  }
  // rows grouped by output row parity: R[rp][e][dv]
  float R[2][2][3];
  for (int dv = 0; dv < 3; ++dv) {
    const float k0 = k[(0 * 3 + dv) * C + c];
    const float k1 = k[(1 * 3 + dv) * C + c];
    const float k2 = k[(2 * 3 + dv) * C + c];
    R[0][0][dv] = k0;
    R[0][1][dv] = k1 + k2;
    R[1][0][dv] = k0 + k1;
    R[1][1][dv] = k2;
  }
  const float bc = bias[c];
  const int OH = 2 * H, OW = 2 * W;
  for (int rp = 0; rp < 2; ++rp) {
    for (int cp = 0; cp < 2; ++cp) {
      float acc = bc;
      for (int e = 0; e < 2; ++e) {
        const float* row = R[rp][e];
        // the same grouping over columns
        const float t0 = cp == 0 ? row[0] : row[0] + row[1];
        const float t1 = cp == 0 ? row[1] + row[2] : row[2];
        acc += t0 * v[rp + e][cp] + t1 * v[rp + e][cp + 1];
      }
      out[(((size_t)n * OH + 2 * a + rp) * OW + 2 * b + cp) * C + c] = acc;
    }
  }
}

extern "C" int dynmm_learned_upsample(const float* x, const float* k,
                                      const float* bias, float* out, int N,
                                      int H, int W, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long total = (long)N * H * W * C;
  const int threads = 256;
  const long blocks = (total + threads - 1) / threads;
  learned_upsample_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      x, k, bias, out, N, H, W, C);
  return (int)cudaGetLastError();
}
