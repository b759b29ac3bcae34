// Whole stride-1 NonBottleneck1D block in one launch, for Hopper (sm_90a),
// fp32.
//
// Replaces dynmm_tpu/kernels/nbt1d.py::fused_nbt1d (_kernel). In eval, with
// BN folded into (s, t) (eps 1e-3) and taps packed as (3, C_in, C_out):
//   a   = relu(3x1 conv(x) + b1)                 zero outside the image columns
//   h   = relu((1x3 conv(a) + b2) * s1 + t1)     zero outside the image
//   g   = relu(3x1 conv(h) + b3)                 zero outside the image columns
//   out = relu((1x3 conv(g) + b4) * s2 + t2 + x)
// x is read and out written once; a, h and g never leave shared memory
// (the two-launch form, csrc/nbt1d.cu, writes and reads h in device memory).
//
// Bound on this card: operations. The block does 4 * 2 * 3 * C * C FLOP per
// pixel (15.1 GFLOP at B=8 at every flagship level, since C*C*H*W is the
// same at all four) against one read of x and one write of out (79 MB at
// C = 64): 0.225 ms at the 67 TFLOP/s fp32 peak of the CUDA cores against
// 0.024 ms at 3.35 TB/s.
//
// Design (simple, right first; same inner loops as csrc/nbt1d.cu): one
// block per (sample, band of T rows, column tile of TW), one thread per
// output channel. The block walks down its band. Step j computes h at image
// row y0-1+j: the 3x1 conv stages three x rows in chunks of KC input
// channels and writes a (TW+4 columns) to a row buffer; the 1x3 conv reads
// it and writes h (TW+2 columns) into a ring of three h rows. From step 2
// on, the step then computes output row y0+j-2: the 3x1 conv of pair 2
// reads the three ring rows and writes g (TW+2 columns) into the row
// buffer; its 1x3 conv reads g, adds x from device memory and writes out.
//
// Extra arithmetic: pair 1 runs on T+2 rows for T and on TW+4 / TW+2
// columns for TW, pair 2's 3x1 on TW+2 columns (padded to 4 in the 3x1
// convs). At TW = 16 the block does (10 * (20 + 18) + 8 * (20 + 16)) /
// (8 * 4 * 16) = 1.30x the useful work at T = 8, 1.45x at T = 4 and 1.74x
// at T = 2; two nbt1d_pair launches do 1.125x. Tall bands cost less
// arithmetic but give fewer blocks: T comes from the caller, or, given as
// 0, is the tallest of 16, 8, 4 whose grid still has 4 blocks per SM
// (528), else 2.
//
// Shared memory: 3 * C * HP (h ring) + C * AP (row buffer) + 3 * KC * AP
// (x chunk) floats, HP = TW+2 and AP = TW+4 rounded up to 4, whatever T:
// 28,160 bytes at C = 64, TW = 16; 107,520 at C = 256, TW = 20; 205,824 at
// C = 512, TW = 20, under the 232,448 a block can opt into but one block
// per SM. A launch that does not fit returns cudaErrorInvalidValue.
//
// Where it is served: kernels/nbt1d.py::NBT1D_FUSED_MAX_C. On the H100 it
// took 1.3-1.5x the time of two nbt1d_pair launches at every flagship level,
// least at C = 64, so only that level runs it. The grid is not split further
// at small batch: at B=1 it has 600 blocks at C = 64 (120x160, T = 2), but
// 30 at C = 256 (30x40), one reason the wider levels stay on the pairs.
//
// Masks (the TPU kernel's three, nbt1d.py:74-77, :82-91, :96-98): x rows
// and columns outside the image read as 0; a and g are 0 at columns outside
// the image (the 1x3 convs zero-pad their input, so not relu(bias)); h is 0
// at rows and columns outside the image (the second 3x1 conv zero-pads its
// input). Rows of the band past the image's last row (ragged last band) are
// h = 0 and produce no output; columns past the last (ragged last column
// tile) are masked the same way and never written.

#include <cuda_runtime.h>

namespace {

constexpr int KC = 32;                 // input channels staged per step
constexpr size_t MAX_SMEM = 232448;    // dynamic shared memory a block may use

template <int TW>
struct Tile {
  static constexpr int AW = TW + 4;              // a columns c0-2 .. c0+TW+1
  static constexpr int AP = (AW + 3) / 4 * 4;    // padded to float4
  static constexpr int HW = TW + 2;              // h, g columns c0-1 .. c0+TW
  static constexpr int HP = (HW + 3) / 4 * 4;
  static size_t smem_bytes(int C) {
    return ((size_t)3 * C * HP + (size_t)C * AP + 3 * KC * AP) *
           sizeof(float);
  }
};

template <int TW>
__global__ void __launch_bounds__(256)
    nbt1d_block_kernel(const float* __restrict__ x,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ s1,
                       const float* __restrict__ t1,
                       const float* __restrict__ w3,
                       const float* __restrict__ b3,
                       const float* __restrict__ w4,
                       const float* __restrict__ b4,
                       const float* __restrict__ s2,
                       const float* __restrict__ t2, float* __restrict__ out,
                       int H, int W, int C, int T) {
  constexpr int AW = Tile<TW>::AW;
  constexpr int AP = Tile<TW>::AP;
  constexpr int HW = Tile<TW>::HW;
  constexpr int HP = Tile<TW>::HP;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [3][C][HP]: ring of h rows
  float* rs = hs + (size_t)3 * C * HP;           // [C][AP]: a, then g
  float* xs = rs + (size_t)C * AP;               // [3][KC][AP]

  const int c0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * T;
  const int n = blockIdx.z;
  const float* xn = x + (size_t)n * H * W * C;

  // Step j computes h at image row y0-1+j into ring slot j % 3; from j = 2
  // on, it then computes output row y0+j-2 from the slots of rows
  // y0+j-3 .. y0+j-1.
  for (int j = 0; j < T + 2; ++j) {
    // ---------------- pair 1 -> h row yy
    const int yy = y0 - 1 + j;
    float* hj = hs + (size_t)(j % 3) * C * HP;
    if (yy < 0 || yy >= H) {  // the same for every thread of the block
      for (int e = threadIdx.x; e < C * HP; e += blockDim.x) hj[e] = 0.f;
    } else {
      // 3x1 conv + b1 + relu over columns c0-2 .. c0+TW+1 -> rs
      for (int co0 = 0; co0 < C; co0 += blockDim.x) {
        const int co = co0 + threadIdx.x;
        float acc[AP];
#pragma unroll
        for (int p = 0; p < AP; ++p) acc[p] = 0.f;
        for (int ci0 = 0; ci0 < C; ci0 += KC) {
          const int kc = C - ci0 < KC ? C - ci0 : KC;
          __syncthreads();  // every thread is done with rs and the last chunk
          for (int e = threadIdx.x; e < 3 * AP * KC; e += blockDim.x) {
            const int k = e % KC;
            const int p = (e / KC) % AP;
            const int d = e / (KC * AP);
            const int ry = yy + d - 1, cx = c0 - 2 + p;
            float v = 0.f;
            if (k < kc && p < AW && ry >= 0 && ry < H && cx >= 0 && cx < W)
              v = xn[((size_t)ry * W + cx) * C + ci0 + k];
            xs[(d * KC + k) * AP + p] = v;
          }
          __syncthreads();
          if (co < C) {
            for (int d = 0; d < 3; ++d) {
              const float* wd = w1 + ((size_t)d * C + ci0) * C + co;
#pragma unroll 4
              for (int k = 0; k < kc; ++k) {
                const float w = wd[(size_t)k * C];
                const float4* row =
                    reinterpret_cast<const float4*>(xs + (d * KC + k) * AP);
#pragma unroll
                for (int q = 0; q < AP / 4; ++q) {
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
          const float b = b1[co];
#pragma unroll
          for (int p = 0; p < AP; ++p) {
            const int col = c0 - 2 + p;
            const bool inside = p < AW && col >= 0 && col < W;
            rs[(size_t)co * AP + p] = inside ? fmaxf(acc[p] + b, 0.f) : 0.f;
          }
        }
      }
      __syncthreads();
      // 1x3 conv + b2 -> folded BN -> relu over columns c0-1 .. c0+TW -> hj
      for (int co0 = 0; co0 < C; co0 += blockDim.x) {
        const int co = co0 + threadIdx.x;
        if (co >= C) continue;
        float acc[HW];
#pragma unroll
        for (int q = 0; q < HW; ++q) acc[q] = 0.f;
        for (int ci = 0; ci < C; ++ci) {
          const float k0 = w2[((size_t)0 * C + ci) * C + co];
          const float k1 = w2[((size_t)1 * C + ci) * C + co];
          const float k2 = w2[((size_t)2 * C + ci) * C + co];
          float av[AP];
          const float4* row =
              reinterpret_cast<const float4*>(rs + (size_t)ci * AP);
#pragma unroll
          for (int q = 0; q < AP / 4; ++q) {
            const float4 v = row[q];
            av[4 * q + 0] = v.x;
            av[4 * q + 1] = v.y;
            av[4 * q + 2] = v.z;
            av[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < HW; ++q)
            acc[q] += av[q] * k0 + av[q + 1] * k1 + av[q + 2] * k2;
        }
        const float b = b2[co], sc = s1[co], sh = t1[co];
#pragma unroll
        for (int q = 0; q < HP; ++q) {
          const int col = c0 - 1 + q;
          const bool inside = q < HW && col >= 0 && col < W;
          hj[(size_t)co * HP + q] =
              inside ? fmaxf((acc[q] + b) * sc + sh, 0.f) : 0.f;
        }
      }
    }
    const int r = j - 2, yo = y0 + r;  // output row of this step, if any
    if (r < 0) continue;
    if (yo >= H) break;  // ragged last band; the same for every thread
    __syncthreads();     // h row yy is whole; every thread is done with rs

    // ---------------- pair 2 -> out row yo
    // 3x1 conv over h rows yo-1 .. yo+1 (slots r, r+1, r+2 mod 3) + b3 +
    // relu -> rs
    for (int co0 = 0; co0 < C; co0 += blockDim.x) {
      const int co = co0 + threadIdx.x;
      if (co >= C) continue;
      float acc[HP];
#pragma unroll
      for (int q = 0; q < HP; ++q) acc[q] = 0.f;
      for (int d = 0; d < 3; ++d) {
        const float* hd = hs + (size_t)((r + d) % 3) * C * HP;
        const float* wd = w3 + (size_t)d * C * C + co;
#pragma unroll 4
        for (int ci = 0; ci < C; ++ci) {
          const float w = wd[(size_t)ci * C];
          const float4* row =
              reinterpret_cast<const float4*>(hd + (size_t)ci * HP);
#pragma unroll
          for (int q = 0; q < HP / 4; ++q) {
            const float4 v = row[q];
            acc[4 * q + 0] += v.x * w;
            acc[4 * q + 1] += v.y * w;
            acc[4 * q + 2] += v.z * w;
            acc[4 * q + 3] += v.w * w;
          }
        }
      }
      const float b = b3[co];
#pragma unroll
      for (int q = 0; q < HP; ++q) {
        const int col = c0 - 1 + q;
        const bool inside = q < HW && col >= 0 && col < W;
        rs[(size_t)co * AP + q] = inside ? fmaxf(acc[q] + b, 0.f) : 0.f;
      }
    }
    __syncthreads();
    // 1x3 conv + b4 -> folded BN -> +x -> relu -> out
    for (int co0 = 0; co0 < C; co0 += blockDim.x) {
      const int co = co0 + threadIdx.x;
      if (co >= C) continue;
      float acc[TW];
#pragma unroll
      for (int q = 0; q < TW; ++q) acc[q] = 0.f;
      for (int ci = 0; ci < C; ++ci) {
        const float k0 = w4[((size_t)0 * C + ci) * C + co];
        const float k1 = w4[((size_t)1 * C + ci) * C + co];
        const float k2 = w4[((size_t)2 * C + ci) * C + co];
        float gv[HP];
        const float4* row =
            reinterpret_cast<const float4*>(rs + (size_t)ci * AP);
#pragma unroll
        for (int q = 0; q < HP / 4; ++q) {
          const float4 v = row[q];
          gv[4 * q + 0] = v.x;
          gv[4 * q + 1] = v.y;
          gv[4 * q + 2] = v.z;
          gv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < TW; ++q)
          acc[q] += gv[q] * k0 + gv[q + 1] * k1 + gv[q + 2] * k2;
      }
      const float b = b4[co], sc = s2[co], sh = t2[co];
#pragma unroll
      for (int q = 0; q < TW; ++q) {
        const int col = c0 + q;
        if (col >= W) continue;
        const size_t off = (((size_t)n * H + yo) * W + col) * C + co;
        out[off] = fmaxf((acc[q] + b) * sc + sh + x[off], 0.f);
      }
    }
    __syncthreads();  // every thread is done with rs and with h slot r % 3
  }
}

constexpr int TARGET_BLOCKS = 4 * 132;  // four blocks per SM of an H100

template <int TW>
int launch(const float* const* p, float* out, int N, int H, int W, int C,
           int T, cudaStream_t st) {
  const int tiles = (W + TW - 1) / TW;
  if (T <= 0) {
    T = 2;
    for (int t = 16; t > 2; t /= 2) {
      if ((long)N * tiles * ((H + t - 1) / t) >= TARGET_BLOCKS) {
        T = t;
        break;
      }
    }
  }
  const size_t smem = Tile<TW>::smem_bytes(C);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nbt1d_block_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = (C + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  dim3 grid(tiles, (H + T - 1) / T, N);
  nbt1d_block_kernel<TW><<<grid, threads, smem, st>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
      p[11], p[12], out, H, W, C, T);
  return (int)cudaGetLastError();
}

}  // namespace

// Bands of T rows (0: chosen here). Tile width as in csrc/nbt1d.cu: 16 or
// 20 where it divides W (no idle columns at the flagship's 160/80/40), else
// 8, else 16 with the ragged edge masked.
extern "C" int dynmm_nbt1d_block(const float* x, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* b2, const float* s1,
                                 const float* t1, const float* w3,
                                 const float* b3, const float* w4,
                                 const float* b4, const float* s2,
                                 const float* t2, float* out, int N, int H,
                                 int W, int C, int T, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* p[13] = {x, w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2};
  if (W % 16 == 0) return launch<16>(p, out, N, H, W, C, T, st);
  if (W % 20 == 0) return launch<20>(p, out, N, H, W, C, T, st);
  if (W % 8 == 0) return launch<8>(p, out, N, H, W, C, T, st);
  return launch<16>(p, out, N, H, W, C, T, st);
}
