// Whole stride-1 NonBottleneck1D block in one launch, for Hopper (sm_90a),
// fp32-accurate on the tensor cores (3xTF32 mma.sync).
//
// Replaces dynmm_tpu/kernels/nbt1d.py::fused_nbt1d (_kernel). In eval, with
// BN folded into (s, t) (eps 1e-3) and taps packed as (3, C_in, C_out):
//   a   = relu(3x1 conv(x) + b1)                 zero outside the image columns
//   h   = relu((1x3 conv(a) + b2) * s1 + t1)     zero outside the image
//   g   = relu(3x1 conv(h) + b3)                 zero outside the image columns
//   out = relu((1x3 conv(g) + b4) * s2 + t2 + x)
// x is read and out written once; a, h and g never leave shared memory, as
// the TPU kernel kept them in VMEM (the two-launch form, csrc/nbt1d.cu,
// writes and reads h in device memory).
//
// Bound on this card: operations. The block does 4 * 2 * 3 * C * C FLOP per
// pixel (15.1 GFLOP at B=8 at every flagship level, since C*C*H*W is the
// same at all four) against one read of x and one write of out (79 MB at
// C = 64): 0.092 ms as three TF32 products per fp32 product at the tensor
// cores' 495 TFLOP/s, 0.225 ms on fp32 CUDA cores, 0.024 ms at 3.35 TB/s.
//
// Design. One block of 16 warps computes a tile of TR x TC output pixels
// of one sample and all C output channels (every conv needs every input
// channel). It runs four implicit GEMMs in turn, each N = C by K = 3*C,
// over shrinking pixel sets, with both ends in shared memory:
//   step 0  3x1  x tile (TR+4) x (TC+4) -> a  (TR+2) x (TC+4)   buffer P -> Q
//   step 1  1x3  a                      -> h  (TR+2) x (TC+2)          Q -> P
//   step 2  3x1  h                      -> g   TR    x (TC+2)          P -> Q
//   step 3  1x3  g                      -> out TR    x  TC       Q -> device
// A dest pixel (i, j) of a step reads src pixel (i + d, j) (3x1) or
// (i, j + d) (1x3) for tap d, so each step is out[p, co] = sum_d sum_ci
// src[p + d * tap, ci] * w[d, ci, co], as in csrc/nbt1d.cu. The output
// step adds x from device memory (L2: the block has just read it), since P
// holds h by then. Pixels are rows of KP + 4 floats (KP = C rounded up to
// 8, channels C..KP-1 zero) so that the lanes' A-fragment reads hit 32
// distinct banks.
//
// Tensor cores: mma.sync.m16n8k8 TF32 in 3xTF32 with each K-chunk's sum
// started from 0 and the chunk sums added in fp32 (csrc/tf32_mma.cuh; the
// error note in csrc/nbt1d.cu). A warp holds an item of 32 pixels x 32
// output channels (2 x 4 mma tiles); a step's items are dealt to the 16
// warps, in passes of 16 where a step has more.
//
// Asynchronous copies: the x tile comes in with 16-byte cp.async (src-size
// 0 zero-fills pixels outside the image), and every step streams its
// (3, C, C) weights through a double buffer of chunks of KC input channels
// of one tap (KC = 64 up to C = 64, 32 up to 192, else 8) x all output
// channels, one chunk in flight while the block computes the one before.
// The chunk sequence runs on across passes and steps, so a step's first
// chunk loads while the last of the step before computes. One barrier per
// chunk.
//
// Shared memory: ((TR+4)(TC+4) + (TR+2)(TC+4)) * (KP+4) + 2 * KC *
// (32 * ceil(C/32) + 8) floats: 180,480 bytes at C = 64 for the 8 x 20
// tile, so one block (16 warps, at most 128 registers a thread) per SM. A
// launch that does not fit the 232,448 bytes a block may use returns
// cudaErrorInvalidValue.
//
// What bounds it on the H100: warps waiting, not the tensor cores. A
// block's time hardly depends on how many of its warps hold an item, so
// the tile is the largest whose first step still has one item a warp
// (16); more warps per SM (16 warps x 1 item against 8 x 2: 1.09 against
// 1.41 ms at C = 64, B=8) and fewer barriers (chunks of a whole tap
// against half a tap: 0.84 against 0.93 ms) were the gains. Tile rule
// (tile_for): TC = 20 up to C = 64, 16 up to 128, 8 up to 256, else 4
// (never wider than the image); TR, unless the caller gives it, is the
// tallest of 8, 6, 4, 2, 1 that fits and whose first step has at most one
// item a warp, else the shortest that fits. At C = 64 that is 8 x 20 at
// both batches: 960 blocks at B=8, 120 at B=1, where 4 x 20 (240 blocks)
// took 1.6x as long (bench_nbt1d, NVIDIA H100 80GB HBM3, 700.00 W).
// Extra arithmetic (halo pixels computed twice by neighbouring tiles): the
// four steps cover (TR+2)(TC+4) + (TR+2)(TC+2) + TR(TC+2) + TR*TC pixels
// for 4*TR*TC useful ones, 1.24x at 8 x 20, and items round each up to 32
// (52 items for 40 useful ones); two nbt1d_pair calls do 1.0x. So at
// C = 64 the block took 0.84-0.89 ms at B=8 against 0.50 for two pairs,
// and 0.111 against 0.088-0.090 at B=1 (chip_smoke.py); kernels/
// nbt1d.py::NBT1D_FUSED_MAX_C keeps it at C = 64.
//
// Masks (the TPU kernel's three, nbt1d.py:74-77, :82-91, :96-98): x rows
// and columns outside the image read as 0; a and g are 0 at columns outside
// the image (the 1x3 convs zero-pad their input, so not relu(bias)); h is 0
// at rows and columns outside the image (the second 3x1 conv zero-pads its
// input). Pixels of a ragged last tile past the image's last row or column
// are computed from zeros and never written.

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

// Warps of a block; each holds one item of 32 pixels x 32 channels.
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
// Tile columns and input channels per weight chunk at C <= 64.
constexpr int TC64 = 20;
constexpr int KC64 = 64;
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use

struct Plan {
  int TR, TC;  // output rows and columns of a tile
  int KP;      // C rounded up to 8: the K extent of one tap
  int CP;      // floats per pixel in shared memory
  int NG;      // groups of 32 output channels
  int WS;      // floats per weight row in shared memory
  int KC;      // input channels of one tap per weight chunk
  int XP, QP;  // pixels of buffer P (the x tile) and of buffer Q (a)
  size_t smem;
};

Plan plan_for(int C, int TR, int TC) {
  Plan p;
  p.TR = TR;
  p.TC = TC;
  p.KP = (C + 7) / 8 * 8;
  p.CP = p.KP + 4;
  p.NG = (C + 31) / 32;
  p.WS = p.NG * 32 + 8;
  p.KC = C <= 64 ? KC64 : C <= 192 ? 32 : 8;
  p.XP = (TR + 4) * (TC + 4);
  p.QP = (TR + 2) * (TC + 4);
  p.smem = ((size_t)(p.XP + p.QP) * p.CP + (size_t)2 * p.KC * p.WS) *
           sizeof(float);
  return p;
}

struct Params {
  const float *x, *w1, *b1, *w2, *b2, *s1, *t1, *w3, *b3, *w4, *b4, *s2, *t2;
  float* out;
  int H, W, C;
};

template <int KC>
__global__ void __launch_bounds__(THREADS)
    nbt1d_block_kernel(const Params a, const Plan pl) {
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);  // x tile, then h
  float* Q = P + (size_t)pl.XP * pl.CP;        // a, then g
  float* Wb = Q + (size_t)pl.QP * pl.CP;       // [2][KC][WS] weight chunks

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int H = a.H, W = a.W, C = a.C;
  const int TR = pl.TR, TC = pl.TC, KP = pl.KP, CP = pl.CP, NG = pl.NG;
  const int WS = pl.WS;
  const int c0 = blockIdx.x * TC, y0 = blockIdx.y * TR, n = blockIdx.z;
  const bool vec =
      (C & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w1) |
        reinterpret_cast<uintptr_t>(a.w2) | reinterpret_cast<uintptr_t>(a.w3) |
        reinterpret_cast<uintptr_t>(a.w4)) & 15) == 0;

  // Step s: dest DH x DW pixels read a src of width SW, tap d shifted by
  // d * TAP pixels.
  auto dest_w = [&](int s) { return TC + (s == 0 ? 4 : s == 3 ? 0 : 2); };
  auto dest_m = [&](int s) { return (TR + (s < 2 ? 2 : 0)) * dest_w(s); };
  auto src_w = [&](int s) { return TC + (s < 2 ? 4 : 2); };
  auto items = [&](int s) { return (dest_m(s) + 31) / 32 * NG; };
  auto passes = [&](int s) { return (items(s) + WARPS - 1) / WARPS; };
  const int kq = (KP + KC - 1) / KC;  // chunks of one tap
  const int NQ = 3 * kq;              // chunks of one pass

  // x tile (TR+4) x (TC+4) from image pixel (y0-2, c0-2), zero outside.
  {
    const int XW = TC + 4;
    const float* xn = a.x + (size_t)n * H * W * C;
    const int cv = vec ? C / 4 : C;
    for (int e = tid; e < pl.XP * cv; e += THREADS) {
      const int px = e / cv, q = e - px * cv;
      const int i = px / XW, j = px - i * XW;
      const int y = y0 - 2 + i, xc = c0 - 2 + j;
      const bool in = y >= 0 && y < H && xc >= 0 && xc < W;
      const size_t at = ((size_t)y * W + xc) * C;
      if (vec)
        cp_async<16>(P + (size_t)px * CP + 4 * q, in ? xn + at + 4 * q : a.x,
                     in ? 16 : 0);
      else
        cp_async<4>(P + (size_t)px * CP + q, in ? xn + at + q : a.x,
                    in ? 4 : 0);
    }
    const int pad = KP - C;  // channels C..KP-1, read by the last k-step
    for (int e = tid; e < pl.XP * pad; e += THREADS)
      P[(size_t)(e / pad) * CP + C + e % pad] = 0.f;
  }

  // Chunk q of step s: input channels k0 .. k0+KC-1 of tap d, every output
  // channel, into dst[KC][WS]; rows past C and columns past C are 0.
  auto load_chunk = [&](int s, int q, float* dst) {
    const float* w = s == 0 ? a.w1 : s == 1 ? a.w2 : s == 2 ? a.w3 : a.w4;
    const int d = q / kq, k0 = (q - d * kq) * KC;
    w += (size_t)d * C * C;
    const int cols = NG * 32, cv = vec ? cols / 4 : cols;
    for (int e = tid; e < KC * cv; e += THREADS) {
      const int r = e / cv, col = (e - r * cv) * (vec ? 4 : 1);
      const int ci = k0 + r;
      const bool ok = ci < C && col < C;
      const float* src = ok ? w + (size_t)ci * C + col : a.w1;
      if (vec)
        cp_async<16>(dst + r * WS + col, src, ok ? 16 : 0);
      else
        cp_async<4>(dst + r * WS + col, src, ok ? 4 : 0);
    }
  };

  float acc[2][4][4];
  int abase[2][2];  // src pixel at tap 0 of rows g, g+8 of each m-tile
  int s = 0, p = 0, q = 0;     // the chunk computed
  int ls = 0, lp = 0, lq = 0;  // the chunk loaded next
  auto advance = [&](int& s_, int& p_, int& q_) {
    if (++q_ == NQ) {
      q_ = 0;
      if (++p_ == passes(s_)) {
        p_ = 0;
        ++s_;
      }
    }
  };
  load_chunk(0, 0, Wb);
  cp_async_commit();
  advance(ls, lp, lq);

  for (int it = 0; s < 4; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // chunk `it` and the step before are whole; every warp
                      // is done with the other weight buffer
    if (ls < 4) {
      load_chunk(ls, lq, Wb + (size_t)((it + 1) & 1) * KC * WS);
      advance(ls, lp, lq);
    }
    cp_async_commit();

    const int DW = dest_w(s), M = dest_m(s), SW = src_w(s);
    const float* src = (s & 1) ? Q : P;
    // this warp's item of the pass: pixels m0.., output channels n0..
    const int item = p * WARPS + warp;
    const bool busy = item < items(s);  // the same for the whole warp
    const int m0 = item / NG * 32, n0 = item % NG * 32;
    if (q == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0 + mt * 16 + hf * 8 + g;
          int base = 0;  // rows past the step's pixels read pixel 0
          if (r < M) {
            const int i = r / DW;
            base = i * SW + (r - i * DW);
          }
          abase[mt][hf] = base;
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }

    const float* wbuf = Wb + (size_t)(it & 1) * KC * WS;
    const int d = q / kq, k0 = (q - d * kq) * KC;
    const int shift = d * ((s & 1) ? 1 : SW);
    if (busy) {
      float part[2][4][4];  // this chunk's sum, started from 0
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const int kk = k0 + 8 * ks;
        if (kk >= KP) break;  // a partial last chunk
        unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* r0 =
              src + (size_t)(abase[mt][0] + shift) * CP + kk + tg;
          const float* r1 =
              src + (size_t)(abase[mt][1] + shift) * CP + kk + tg;
          split(r0[0], ah[mt][0], al[mt][0]);
          split(r1[0], ah[mt][1], al[mt][1]);
          split(r0[4], ah[mt][2], al[mt][2]);
          split(r1[4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* c = wbuf + (8 * ks + tg) * WS + n0 + nt * 8 + g;
          split(c[0], bh[nt][0], bl[nt][0]);
          split(c[4 * WS], bh[nt][1], bl[nt][1]);
        }
        mma_3xtf32<2, 4>(part, ah, al, bh, bl);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    }

    if (busy && q == NQ - 1) {  // the item's sums are whole: epilogue
      float* dst = (s & 1) ? P : Q;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = m0 + mt * 16 + g + 8 * (i >> 1);
            const int co = n0 + nt * 8 + 2 * tg + (i & 1);
            if (r >= M || co >= KP) continue;
            const int ii = r / DW, jj = r - ii * DW;
            const float v = acc[mt][nt][i];
            const bool ch = co < C;
            if (s == 0) {  // a, at image (y0-1+ii, c0-2+jj)
              const int col = c0 - 2 + jj;
              dst[(size_t)r * CP + co] = ch && col >= 0 && col < W
                                             ? fmaxf(v + a.b1[co], 0.f)
                                             : 0.f;
            } else if (s == 1) {  // h, at image (y0-1+ii, c0-1+jj)
              const int y = y0 - 1 + ii, col = c0 - 1 + jj;
              dst[(size_t)r * CP + co] =
                  ch && y >= 0 && y < H && col >= 0 && col < W
                      ? fmaxf((v + a.b2[co]) * a.s1[co] + a.t1[co], 0.f)
                      : 0.f;
            } else if (s == 2) {  // g, at image (y0+ii, c0-1+jj)
              const int col = c0 - 1 + jj;
              dst[(size_t)r * CP + co] = ch && col >= 0 && col < W
                                             ? fmaxf(v + a.b3[co], 0.f)
                                             : 0.f;
            } else {  // out, at image (y0+ii, c0+jj)
              const int y = y0 + ii, col = c0 + jj;
              if (!ch || y >= H || col >= W) continue;
              const size_t off = (((size_t)n * H + y) * W + col) * C + co;
              a.out[off] = fmaxf(
                  (v + a.b4[co]) * a.s2[co] + a.t2[co] + a.x[off], 0.f);
            }
          }
    }
    advance(s, p, q);
  }
}

// Tile columns by channel count, tile rows by the rule in the note above
// (or the caller's T); TR = 0 when nothing fits.
Plan tile_for(int W, int C, int T) {
  int TC = C <= 64 ? TC64 : C <= 128 ? 16 : C <= 256 ? 8 : 4;
  if (TC > W) TC = W;
  if (T > 0) return plan_for(C, T, TC);
  Plan best = plan_for(C, 0, TC);
  const int tall[] = {8, 6, 4, 2, 1};
  for (int tr : tall) {
    const Plan p = plan_for(C, tr, TC);
    if (p.smem > MAX_SMEM) continue;
    best = p;
    const int items = ((tr + 2) * (TC + 4) + 31) / 32 * p.NG;  // of step 0
    if (items <= WARPS) break;
  }
  return best;
}

template <int KC>
int launch(const Params& a, const Plan& pl, dim3 grid, cudaStream_t st) {
  static bool smem_set = false;  // the kernel may use MAX_SMEM bytes
  if (pl.smem > 48 * 1024 && !smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        nbt1d_block_kernel<KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  nbt1d_block_kernel<KC><<<grid, THREADS, pl.smem, st>>>(a, pl);
  return (int)cudaGetLastError();
}

}  // namespace

// T: output rows of a tile (0: chosen here).
extern "C" int dynmm_nbt1d_block(const float* x, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* b2, const float* s1,
                                 const float* t1, const float* w3,
                                 const float* b3, const float* w4,
                                 const float* b4, const float* s2,
                                 const float* t2, float* out, int N, int H,
                                 int W, int C, int T, void* stream) {
  if ((long)N * H * W * C == 0) return 0;
  const Plan pl = tile_for(W, C, T);
  if (pl.TR <= 0 || pl.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Params a{x, w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2, out,
                 H, W, C};
  const dim3 grid((W + pl.TC - 1) / pl.TC, (H + pl.TR - 1) / pl.TR, N);
  cudaStream_t st = (cudaStream_t)stream;
  return pl.KC == 64   ? launch<64>(a, pl, grid, st)
         : pl.KC == 32 ? launch<32>(a, pl, grid, st)
                       : launch<8>(a, pl, grid, st);
}
