// Squeeze-and-excite kernels for Hopper (sm_90a), fp32 and bf16.
//
// Replaces two TPU kernels of the JAX package:
//   * dynmm_tpu/kernels/stem_fuse.py::channel_sums (_sums_kernel): per-sample
//     per-channel sums of two (B, HW, C) maps in one read (the stem
//     cell's pass 1, and the local gates' means);
//   * dynmm_tpu/kernels/se.py::fused_se (_se_kernel): mean -> @w1+b1 -> relu
//     -> @w2+b2 -> sigmoid -> x*s, here in the two-map mixed form that the
//     main path's fusion cells use,
//       out = rgb*(w + (1-w)*s_r) + depth*((1-w)*s_d).
//
// Bound on this card: bytes. The sums read each map once; the mix reads both
// maps again and writes one (the reduction forces two passes). The SE MLP is
// C*C/16*2 multiply-adds per sample and map, nothing next to the maps.
//
// Accesses. Maps move in accesses of N channels, N * sizeof(T) bytes
// (elem.cuh's loadv / storev): 16 bytes (4 fp32 or 8 bf16 channels) where C
// and the maps' alignment allow, narrower where they do not; the wrapper
// picks N from the shape and the pointers. Neighbouring threads take
// neighbouring channel groups of one pixel, then further pixel lanes.
//
// channel_sums (sums_kernel, grid (S, B, 2): split s of sample n of map z):
// thread (p, g) sums channels [g*N, g*N + N) over the pixels p, p+P, ... of
// its split, SUMS_UNROLL pixels' loads in flight at once into as many
// accumulators, added in a fixed order at the end; the P pixel lanes then
// add in shared memory and the block writes its partial sums. The TPU
// kernel carried its sum across a sequential grid; Hopper blocks run in no
// order, so the last block of each (sample, map) to finish (an atomicAdd
// ticket after __threadfence, its counter reset to 0 for the next launch,
// so a CUDA graph can replay it) adds the S partials (add_rows: lanes of
// float4 columns, IN_FLIGHT rows' loads at once) in a fixed order: the
// order depends on B, HW, C, N and the grid, never on the data. S comes
// from the wrapper's rule: about SUMS_BLOCKS_PER_SM blocks per SM over the
// batch and both maps, every pixel lane reading at least SUMS_UNROLL
// pixels, at most 32768 partial sums for the last block. This one launch
// timed no slower than the same kernel with the partials added by a second
// launch of (B, 2) blocks at the local gates' shapes, and faster at R50's
// 1024 x 30x40 (B=8: 0.0189 against 0.0208 ms in bf16, 0.0361 against
// 0.0377 in fp32; NVIDIA H100 80GB HBM3, 700.00 W, bench_cells.py).
//
// The SE cell (dynmm_se_fuse) takes two launches, three from C = SE_SPLIT_C
// up. The TPU kernel held a sample's map in VMEM and did mean -> MLP -> x*s
// in one pass; Hopper blocks cannot share a sample's map, so:
//   1. se_squeeze_kernel, grid (S, B, maps): each block sums its chunk of
//      pixels of one map (SE_UNROLL pixels' loads in flight, as in
//      channel_sums) and writes its per-channel partial sums. Below SE_SPLIT_C
//      the last block of each sample to finish (a ticket as above, on a
//      per-sample counter) adds the S partials in a fixed order into the
//      means, runs both SE MLPs once (IN_FLIGHT weights' loads at once),
//      folds in w and writes s_r' = w + (1-w)*s_r and s_d' = (1-w)*s_d
//      (at C <= 512 the MLPs' weights are at most 128 KiB a map, little
//      for one block).
//   2. From SE_SPLIT_C up, se_mlp_kernel: the means and the MLPs for all B
//      samples at once, spread over maps * se_mlp_items blocks, so each
//      weight is read once a batch (SE_BT samples a pass) instead of once a
//      sample by one block (at C = 2048 that serial tail read 4 MiB a
//      sample with 256 threads: 0.107 ms of a B=8 call), and the partials
//      are added in parallel instead of by one block a sample (at C = 2048,
//      15x20, B=8, 33 rows of 4096 floats a sample). Blocks take work items
//      in the order they start (an atomicAdd queue): first the means of
//      (sample, map, slice of channels); then layer 1 as (slice x hidden
//      units) items, which write partial sums; then layer 2 over tiles of
//      output channels, which add the slices' partials in slice order, run
//      relu, the second layer, the sigmoid and the gate mix, and write the
//      scales. An item waits for the items of its map that it reads (its
//      weights already loading); those were taken by blocks that started
//      before it, so the wait always ends. The last block to finish resets
//      the counters to 0. (The mix
//      blocks computing their own channels' layer 2 would read w2 once a
//      mix block, S*B times a batch instead of once.)
//   3. se_mix_kernel, grid (S, B): out = x_r*s_r' + x_d*s_d', each
//      thread's scales loaded once, its channel groups fixed by the layout,
//      SE_UNROLL pixels' loads of both maps in flight at once.
//      Blocks run in the reverse of the squeeze's order, so the first to run
//      read the pixels the squeeze read last, still in L2.
// S comes from the card's SM count (the wrapper's rule), the same S for 1
// and 3. Both take G, the channel groups a thread owns, as a template
// parameter that the host picks from C/N: up to SE_THREADS groups, G = 1,
// one group a thread beside other pixel lanes; above (fp32 from C = 1028 up
// to ResNet50's stage-4 cell, C = 2048), G = 2, two groups at one pixel lane.
//
// Measured a B=8 forward on an NVIDIA H100 80GB HBM3 at 700.00 W
// (bench_cells.py, in turns with the two-launch sums and the serial-tail
// SE cell they replace): channel_sums.bf16 at the stem 0.0601 ms against
// 0.1266 (bound 0.0470), fp32 0.104 against 0.109; the flagship's four SE
// cells 0.159 against 0.175 (fp32) and 0.100 against 0.121 (bf16); R50's
// four 0.577 against 0.882 (fp32) and 0.335 against 0.667 (bf16).
//
// bf16 forms (the map type T, elem.cuh): channel_sums reads bf16 maps and
// writes fp32 sums. The SE cell rounds where the Pallas fused_se does at
// bf16: the per-channel means (fp32 sums / HW) to bf16, the MLP in fp32 with
// the fp32 weights, the scale to bf16; the gate mix w + (1-w)*s and (1-w)*s
// op by op in bf16 (w rounded first), as the JAX model's fuse_mixed; in the
// mix each product and the sum are rounded. Partial sums, means and scales
// stay fp32 buffers (means and scales hold bf16 values).

#include <cuda_runtime.h>
#include <cstdint>

#include "elem.cuh"

// Pixels [q0, q1) of split s of S over HW.
__device__ __forceinline__ void split_range(int HW, int S, int s, int& q0,
                                            int& q1) {
  const int chunk = (HW + S - 1) / S;
  q0 = s * chunk < HW ? s * chunk : HW;
  q1 = q0 + chunk < HW ? q0 + chunk : HW;
}

// Every thread of the block calls this after writing what the last block
// reads. True in the last of ``blocks`` blocks to get here (an atomicAdd
// ticket on *counter, held in the shared *slot), which also resets the
// counter to 0 for the next launch.
__device__ __forceinline__ bool last_block(unsigned* counter, unsigned blocks,
                                           unsigned* slot) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1u);
  __syncthreads();
  if (*slot != blocks - 1) return false;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0;
  return true;
}

// Loads one thread keeps in flight where it adds rows of partial sums or
// walks the SE weights: issued together, then added in the loop's order.
constexpr int IN_FLIGHT = 8;

// v = p[0..V-1] through L2 (written by other blocks of this launch).
template <int V>
__device__ __forceinline__ void load_cg(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// The S rows of partial sums rows[k*stride + c], c < cols, added column by
// column in a fixed order; f(c, total) for each column. Thread (l, j) adds
// the V-float column j over rows l, l+L, ..., IN_FLIGHT rows' loads at
// once, with L = blockDim/(cols/V) lanes where the block has more threads
// than columns; the lanes then add in lane order (red: L*cols floats, at
// most V*blockDim). The order depends on S, cols and the block size only.
// V = 4 takes cols, stride and rows in float4s. Calls __syncthreads when
// L > 1; f's writes are the caller's to order.
template <int V, class F>
__device__ __forceinline__ void add_rows(const float* rows, int S,
                                         size_t stride, int cols, float* red,
                                         F f) {
  const int T_ = blockDim.x, t = threadIdx.x, CJ = cols / V;
  const int L = CJ < T_ ? T_ / CJ : 1;
  auto column = [&](int j, int l, float(&acc)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int k0 = l; k0 < S; k0 += IN_FLIGHT * L) {
      float v[IN_FLIGHT][V];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int k = k0 + u * L;
        if (k < S) {
          load_cg<V>(rows + (size_t)k * stride + j * V, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += v[u][i];
    }
  };
  if (L == 1) {
    for (int j = t; j < CJ; j += T_) {
      float acc[V];
      column(j, 0, acc);
#pragma unroll
      for (int i = 0; i < V; ++i) f(j * V + i, acc[i]);
    }
    return;
  }
  const int l = t / CJ, j = t - l * CJ;
  if (l < L) {
    float acc[V];
    column(j, l, acc);
#pragma unroll
    for (int i = 0; i < V; ++i) red[l * cols + j * V + i] = acc[i];
  }
  __syncthreads();
  for (int c = t; c < cols; c += T_) {
    float tot = 0.f;
    for (int k = 0; k < L; ++k) tot += red[k * cols + c];
    f(c, tot);
  }
}

constexpr int SUMS_THREADS = 256;  // a block's threads, or C/N if more
constexpr int SUMS_UNROLL = 4;     // pixels' loads a thread keeps in flight
// the most threads of a block: C/N groups for C <= 1024
template <int N>
constexpr int sums_max_threads = N >= 4 ? SUMS_THREADS : 1024 / N;

// grid (S, B, 2), P*CG threads: P pixel lanes of the CG = C/N channel groups.
// partial: 2*B*S*C floats; counter: 2*B zeros, left at zero; out_a, out_b:
// B*C sums each. Shared memory: max(P*C, 4*P*CG) floats (the lane sums,
// then add_rows' lanes), then the ticket.
template <int N, class T>
__global__ void __launch_bounds__(sums_max_threads<N>)
    sums_kernel(const T* __restrict__ a, const T* __restrict__ b,
                float* __restrict__ partial, float* __restrict__ out_a,
                float* __restrict__ out_b, unsigned* __restrict__ counter,
                int HW, int C, int P) {
  extern __shared__ float red[];
  const int S = gridDim.x, s = blockIdx.x, n = blockIdx.y, m = blockIdx.z;
  const int B = gridDim.y, CG = C / N, t = threadIdx.x, T_ = blockDim.x;
  const int p = t / CG, g = t - p * CG;
  const T* x = (m == 0 ? a : b) + (size_t)n * HW * C + g * N;
  int q0, q1;
  split_range(HW, S, s, q0, q1);
  float acc[SUMS_UNROLL][N];
#pragma unroll
  for (int u = 0; u < SUMS_UNROLL; ++u)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[u][i] = 0.f;
  int q = q0 + p;
  for (; q + (SUMS_UNROLL - 1) * P < q1; q += SUMS_UNROLL * P) {
    float v[SUMS_UNROLL][N];
#pragma unroll
    for (int u = 0; u < SUMS_UNROLL; ++u)
      loadv<N>(x + (size_t)(q + u * P) * C, v[u]);
#pragma unroll
    for (int u = 0; u < SUMS_UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[u][i] += v[u][i];
  }
  for (; q < q1; q += P) {
    float v[N];
    loadv<N>(x + (size_t)q * C, v);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[0][i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float tot = acc[0][i];
#pragma unroll
    for (int u = 1; u < SUMS_UNROLL; ++u) tot += acc[u][i];
    red[p * C + g * N + i] = tot;
  }
  __syncthreads();
  const size_t row = (size_t)m * B + n;  // this (map, sample)'s partials
  float* part = partial + (row * S + s) * C;
  for (int c = t; c < C; c += T_) {
    float tot = 0.f;
    for (int k = 0; k < P; ++k) tot += red[k * C + c];
    part[c] = tot;
  }
  const int R = P * C > 4 * T_ ? P * C : 4 * T_;
  if (!last_block(counter + row, S, reinterpret_cast<unsigned*>(red + R)))
    return;
  float* out = (m == 0 ? out_a : out_b) + (size_t)n * C;
  const float* pm = partial + row * S * C;
  auto put = [out](int c, float tot) { out[c] = tot; };
  if (C % 4 == 0) {
    add_rows<4>(pm, S, C, C, red, put);
  } else {
    add_rows<1>(pm, S, C, C, red, put);
  }
}

template <int N, class T>
static int sums_launch(const T* a, const T* b, float* partial, float* out_a,
                       float* out_b, unsigned* counter, int B, int HW, int C,
                       int S, cudaStream_t st) {
  const int CG = C / N;
  const int P = CG < SUMS_THREADS ? SUMS_THREADS / CG : 1;
  const int R = P * C > 4 * P * CG ? P * C : 4 * P * CG;
  const size_t smem = ((size_t)R + 4) * sizeof(float);
  sums_kernel<N, T><<<dim3(S, B, 2), P * CG, smem, st>>>(
      a, b, partial, out_a, out_b, counter, HW, C, P);
  return (int)cudaGetLastError();
}

// width: N, the channels of one access (16 bytes or fewer; C % N == 0 and
// the maps aligned to N * sizeof(T) bytes, which the wrapper checks).
template <class T>
static int channel_sums(const T* a, const T* b, float* partial, float* out_a,
                        float* out_b, unsigned* counter, int B, int HW, int C,
                        int S, int width, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || C > 1024 || width < 1 || C % width) return cudaErrorInvalidValue;
  switch (width) {
    case 1:
      return sums_launch<1>(a, b, partial, out_a, out_b, counter, B, HW, C, S,
                            st);
    case 2:
      return sums_launch<2>(a, b, partial, out_a, out_b, counter, B, HW, C, S,
                            st);
    case 4:
      return sums_launch<4>(a, b, partial, out_a, out_b, counter, B, HW, C, S,
                            st);
  }
  if constexpr (sizeof(T) == 2) {
    if (width == 8)
      return sums_launch<8>(a, b, partial, out_a, out_b, counter, B, HW, C,
                            S, st);
  }
  return cudaErrorInvalidValue;
}

// partial holds 2*B*S*C floats, counter 2*B unsigned zeros (left at zero);
// the sums are fp32 in both forms.
extern "C" int dynmm_channel_sums(const float* a, const float* b,
                                  float* partial, float* out_a, float* out_b,
                                  unsigned* counter, int B, int HW, int C,
                                  int S, int width, void* stream) {
  return channel_sums(a, b, partial, out_a, out_b, counter, B, HW, C, S,
                      width, stream);
}

extern "C" int dynmm_channel_sums_bf16(const bf16* a, const bf16* b,
                                       float* partial, float* out_a,
                                       float* out_b, unsigned* counter, int B,
                                       int HW, int C, int S, int width,
                                       void* stream) {
  return channel_sums(a, b, partial, out_a, out_b, counter, B, HW, C, S,
                      width, stream);
}

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.f / (1.f + expf(-v));
}

constexpr int SE_THREADS = 256;
// pixels' loads a squeeze or mix thread keeps in flight
constexpr int SE_UNROLL = 4;
// channel groups a thread owns at most: C <= N*SE_THREADS*SE_MAX_G
constexpr int SE_MAX_G = 2;
// from this C up the MLPs run in se_mlp_kernel, not in the squeeze's tail
constexpr int SE_SPLIT_C = 1024;
constexpr int SE_MAX_C = 2048;  // the widest cell: ResNet50's stage 4
// se_mlp_kernel's items: the means and layer 1 over slices of SE_SLICE
// channels (layer 1 for SE_L1_UNITS hidden units), layer 2 for SE_L2_COLS
// output channels; SE_BT samples a pass
constexpr int SE_SLICE = 256;
constexpr int SE_L1_UNITS = 32;
constexpr int SE_L2_COLS = 16;
constexpr int SE_BT = 8;
static_assert(SE_BT * SE_L1_UNITS == SE_THREADS, "a thread per (sample, unit)");
static_assert(SE_BT == 8, "madd8 adds eight samples");
// se_mlp_kernel's counters: the item queue, the means items and the
// layer-1 items done of each map, the blocks done
constexpr int SE_MLP_COUNTERS = 6;
// shared floats of se_mlp_kernel: two regions of SE_BT*SE_THREADS, the item
constexpr int SE_MLP_SMEM_FLOATS = 2 * SE_BT * SE_THREADS + 4;

// The squeeze's and the mix's thread mapping over CN = C/N channel groups
// of N channels, for G groups a thread (the host picks G from CN): thread
// t = p*CT + gc owns the groups gc, gc+CT, ... below CN at pixel lane p of
// P = SE_THREADS/CT, CT = ceil(CN/G). G = 1 (CN <= SE_THREADS): CT = CN,
// one group a thread beside other pixel lanes. G = 2 (CN <= 2*SE_THREADS):
// two groups at one pixel lane.
template <int G>
__device__ __forceinline__ int se_ct(int CN) {
  return G == 1 ? CN : (CN + G - 1) / G;
}

// Thread's group k is a channel group: always for G = 1, where CT = CN.
template <int G>
__device__ __forceinline__ bool se_own(int g, int CN) {
  return G == 1 || g < CN;
}

// SE MLP weights of one map, in the JAX layout: w1 (C, Cr), w2 (Cr, C).
struct SeWeights {
  const float *w1, *b1, *w2, *b2;
};

// Floats of one map's lane sums: lane p's sum of channel c sits at p*C + c,
// and P*C <= max(N*SE_THREADS, C).
constexpr int se_red_floats(int C, int N) {
  return C > N * SE_THREADS ? C : N * SE_THREADS;
}

// Shared memory (floats): the pixel lanes' sums [se_red_floats], the
// ticket, then (below SE_SPLIT_C) the finalize's means [2][C], layer-1 sums
// [2][SE_THREADS] and hidden units [2][Cr]. At bf16, N = 8, C = 512: 14,608
// bytes.
constexpr int se_smem_floats(int C, int Cr, int N) {
  return se_red_floats(C, N) + 4 +
         (C < SE_SPLIT_C ? 2 * C + 2 * SE_THREADS + 2 * Cr : 0);
}

// se_mlp_kernel's items a map: the means of each sample and slice, layer 1
// of each slice and unit range, layer 2 of each tile.
constexpr int se_mlp_items(int B, int C, int Cr) {
  return (C + SE_SLICE - 1) / SE_SLICE *
             (B + (Cr + SE_L1_UNITS - 1) / SE_L1_UNITS) +
         (C + SE_L2_COLS - 1) / SE_L2_COLS;
}

// grid (S, B, maps), SE_THREADS threads, the se_ct<G> mapping: block
// (s, n, m) sums map m (x_r, or x_d) of sample n over its chunk of pixels;
// each thread adds its N-channel groups over the pixels p, p+P, ...,
// SE_UNROLL pixels' loads in flight at once into as many accumulators,
// added in a fixed order at the end. x_d == nullptr: one map (fused_se).
// partial holds B*S*2*C floats, scales B*2*C, counter B zeros (left at
// zero). counter == nullptr (from SE_SPLIT_C up): the block only writes its
// partial sums; se_mlp_kernel adds them. T: the maps' element type.
template <int G, int N, class T>
__global__ void __launch_bounds__(SE_THREADS)
    se_squeeze_kernel(const T* __restrict__ x_r,
                      const T* __restrict__ x_d,
                      float* __restrict__ partial, float* __restrict__ scales,
                      unsigned* __restrict__ counter, SeWeights wr,
                      SeWeights wd, const float* __restrict__ w_rgb, int HW,
                      int C, int Cr) {
  extern __shared__ float sm[];
  const int S = gridDim.x, s = blockIdx.x, n = blockIdx.y, m = blockIdx.z;
  const int t = threadIdx.x, CN = C / N;
  const int CT = se_ct<G>(CN);
  const int P = SE_THREADS / CT;  // pixel lanes
  const int p = t / CT, gc = t - p * CT;
  const bool two = x_d != nullptr;
  const int RS = C > N * SE_THREADS ? C : N * SE_THREADS;  // se_red_floats

  float acc[SE_UNROLL][G][N];
#pragma unroll
  for (int u = 0; u < SE_UNROLL; ++u)
#pragma unroll
    for (int k = 0; k < G; ++k)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[u][k][i] = 0.f;
  if (p < P) {
    int q0, q1;
    split_range(HW, S, s, q0, q1);
    const T* x = (m == 0 ? x_r : x_d) + (size_t)n * HW * C;
    int q = q0 + p;
    for (; q + (SE_UNROLL - 1) * P < q1; q += SE_UNROLL * P) {
      float v[SE_UNROLL][G][N];
#pragma unroll
      for (int u = 0; u < SE_UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const int g = gc + k * CT;
          if (se_own<G>(g, CN))
            loadv<N>(x + N * ((q + u * P) * CN + g), v[u][k]);
        }
#pragma unroll
      for (int u = 0; u < SE_UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < G; ++k)
          if (se_own<G>(gc + k * CT, CN))
#pragma unroll
            for (int i = 0; i < N; ++i) acc[u][k][i] += v[u][k][i];
    }
    for (; q < q1; q += P) {
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int g = gc + k * CT;
        if (se_own<G>(g, CN)) {
          float v[N];
          loadv<N>(x + N * (q * CN + g), v);
#pragma unroll
          for (int i = 0; i < N; ++i) acc[0][k][i] += v[i];
        }
      }
    }
  }
  // lane p's sum of channel c sits at sm[p*C + c]
  float4* red4 = reinterpret_cast<float4*>(sm);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = gc + k * CT;
    if (p < P && se_own<G>(g, CN)) {
      float tot[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        tot[i] = acc[0][k][i];
#pragma unroll
        for (int u = 1; u < SE_UNROLL; ++u) tot[i] += acc[u][k][i];
      }
      const int f = (p * C + g * N) / 4;
#pragma unroll
      for (int i = 0; i < N / 4; ++i)
        red4[f + i] = make_float4(tot[4 * i], tot[4 * i + 1], tot[4 * i + 2],
                                  tot[4 * i + 3]);
    }
  }
  __syncthreads();
  float* part = partial + (((size_t)n * S + s) * 2 + m) * C;
  for (int c = t; c < C; c += SE_THREADS) {
    float r = 0.f;
    for (int k = 0; k < P; ++k) r += sm[k * C + c];
    part[c] = r;
  }
  if (counter == nullptr) return;  // se_mlp_kernel adds the partials

  // the last of sample n's blocks (both maps) to get here runs the finalize
  const int maps = gridDim.z;
  if (!last_block(counter + n, S * maps,
                  reinterpret_cast<unsigned*>(sm + RS)))
    return;

  float* mean = sm + RS + 4;        // [2][C]
  float* l1 = mean + 2 * C;         // [2][SE_THREADS]
  float* hid = l1 + 2 * SE_THREADS; // [2][Cr]
  add_rows<4>(partial + (size_t)n * S * 2 * C, S, 2 * C, maps * C, sm,
              [mean, HW](int c, float tot) {
                mean[c] = rnd<T>(tot / (float)HW);
              });
  __syncthreads();
  // layer 1, spread over the block: thread (slice, j) sums mean[c]*w1[c][j]
  // over c = slice, slice+NS, ... (IN_FLIGHT weights' loads of each map at
  // once); consecutive threads read consecutive weights. The NS slices of
  // each hidden unit then add in slice order. (This order keeps the bf16
  // scales, rounded from these sums, bit-identical to earlier builds'.)
  const int NS = SE_THREADS / Cr;
  const int sl = t / Cr, j = t - sl * Cr;
  float hr = 0.f, hd = 0.f;
  if (sl < NS) {
    for (int c0 = sl; c0 < C; c0 += IN_FLIGHT * NS) {
      float a[IN_FLIGHT], d[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int c = c0 + u * NS;
        a[u] = c < C ? wr.w1[c * Cr + j] : 0.f;
        d[u] = two && c < C ? wd.w1[c * Cr + j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int c = c0 + u * NS;
        if (c < C) {
          hr += mean[c] * a[u];
          if (two) hd += mean[C + c] * d[u];
        }
      }
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
  // layer 2, one thread per channel (IN_FLIGHT weights' loads of each map
  // at once), and the mix weight folded in
  const float w = rnd<T>(w_rgb != nullptr ? w_rgb[n] : 0.f);
  const float w1m = rnd<T>(1.f - w);
  float* sc = scales + (size_t)n * 2 * C;
  for (int c = t; c < C; c += SE_THREADS) {
    float a = 0.f, d = 0.f;
    for (int j0 = 0; j0 < Cr; j0 += IN_FLIGHT) {
      float wa[IN_FLIGHT], wb[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int jj = j0 + u;
        wa[u] = jj < Cr ? wr.w2[jj * C + c] : 0.f;
        wb[u] = two && jj < Cr ? wd.w2[jj * C + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (j0 + u < Cr) {
          a += hid[j0 + u] * wa[u];
          if (two) d += hid[Cr + j0 + u] * wb[u];
        }
      }
    }
    sc[c] = rnd<T>(w + rnd<T>(w1m * rnd<T>(sigmoidf_(a + wr.b2[c]))));
    sc[C + c] = two ? rnd<T>(w1m * rnd<T>(sigmoidf_(d + wd.b2[c]))) : 0.f;
  }
}

// acc[b] += x[b] * w for the SE_BT samples' values x (16-byte aligned, in
// shared memory)
__device__ __forceinline__ void madd8(float (&acc)[SE_BT], const float* x,
                                      float w) {
  const float4 lo = *reinterpret_cast<const float4*>(x);
  const float4 hi = *reinterpret_cast<const float4*>(x + 4);
  acc[0] += lo.x * w;
  acc[1] += lo.y * w;
  acc[2] += lo.z * w;
  acc[3] += lo.w * w;
  acc[4] += hi.x * w;
  acc[5] += hi.y * w;
  acc[6] += hi.z * w;
  acc[7] += hi.w * w;
}

// Thread 0 waits until *done reaches need (the blocks it waits for took
// their items before this block, so they run), then the block reads what
// they wrote through L2 (__ldcg).
__device__ __forceinline__ void wait_for(const unsigned* done, unsigned need) {
  if (threadIdx.x == 0) {
    const volatile unsigned* flag = done;
    for (long spin = 0; *flag < need; ++spin) {
      if (spin > (1L << 26)) __trap();  // seconds: a fault, not a wait
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// maps * se_mlp_items(B, C, Cr) blocks, SE_THREADS threads,
// SE_MLP_SMEM_FLOATS shared floats. Items, in the order blocks take them:
//   means (b, m, k): the S partials of slice k of map m of sample b (the
//     squeeze's, B*S*2*C floats) into means (B*2*C), rounded to T;
//   layer 1 (m, k, jr), after the map's means items: for every sample, the
//     slice's share of hidden units [jr*SE_L1_UNITS, +SE_L1_UNITS) into
//     hpart (KS*B*2*Cr floats, KS = ceil(C/SE_SLICE));
//   layer 2 (m, tile), after the map's layer-1 items: relu(slices' sum +
//     b1), then @w2 + b2, the sigmoid and the gate mix of output channels
//     [tile*SE_L2_COLS, +SE_L2_COLS) of every sample into scales (B*2*C).
// ctr: SE_MLP_COUNTERS zeros, left at zero.
template <class T>
__global__ void __launch_bounds__(SE_THREADS, 4)
    se_mlp_kernel(const float* __restrict__ partial,
                  float* __restrict__ means, float* __restrict__ hpart,
                  float* __restrict__ scales, unsigned* __restrict__ ctr,
                  SeWeights wr, SeWeights wd, const float* __restrict__ w_rgb,
                  int B, int S, int HW, int C, int Cr, int maps) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  unsigned* slot = reinterpret_cast<unsigned*>(sm + 2 * SE_BT * SE_THREADS);
  if (t == 0) *slot = atomicAdd(ctr, 1u);
  __syncthreads();
  int item = (int)*slot;
  const int KS = (C + SE_SLICE - 1) / SE_SLICE;
  const int JI = (Cr + SE_L1_UNITS - 1) / SE_L1_UNITS;
  if (item < maps * KS * B) {
    const int m = item / (KS * B), b = item / KS % B, k = item % KS;
    const int c0 = k * SE_SLICE;
    const int cols = C - c0 < SE_SLICE ? C - c0 : SE_SLICE;
    float* mb = means + ((size_t)b * 2 + m) * C + c0;
    add_rows<4>(partial + ((size_t)b * S * 2 + m) * C + c0, S, 2 * C, cols,
                sm, [mb, HW](int c, float tot) {
                  mb[c] = rnd<T>(tot / (float)HW);
                });
    __threadfence();
    __syncthreads();
    if (t == 0) atomicAdd(ctr + 1 + m, 1u);
  } else if ((item -= maps * KS * B) < maps * KS * JI) {
    // thread (r, jj) adds channels c0 + r, c0 + r + R, ... of the slice; its
    // SE_L1_ROWS weights load before the wait, all in flight at once
    const int m = item / (KS * JI), k = item / JI % KS;
    const int c0 = k * SE_SLICE, j0 = item % JI * SE_L1_UNITS;
    constexpr int R = SE_THREADS / SE_L1_UNITS;
    constexpr int SE_L1_ROWS = SE_SLICE / R;
    const int jj = t % SE_L1_UNITS, r = t / SE_L1_UNITS, j = j0 + jj;
    const float* w1 = m ? wd.w1 : wr.w1;
    float w[SE_L1_ROWS];
#pragma unroll
    for (int u = 0; u < SE_L1_ROWS; ++u) {
      const int c = c0 + r + u * R;
      w[u] = j < Cr && c < C ? w1[(size_t)c * Cr + j] : 0.f;
    }
    float* ms = sm;                         // [SE_SLICE][SE_BT] means
    float* red = sm + SE_BT * SE_THREADS;   // [R][SE_BT][SE_L1_UNITS]
    wait_for(ctr + 1 + m, KS * B);
    for (int b0 = 0; b0 < B; b0 += SE_BT) {
      for (int i = t; i < SE_BT * SE_SLICE; i += SE_THREADS) {
        const int bi = i / SE_SLICE, cc = i - bi * SE_SLICE;
        const int b = b0 + bi, c = c0 + cc;
        ms[cc * SE_BT + bi] =
            b < B && c < C ? __ldcg(means + ((size_t)b * 2 + m) * C + c)
                           : 0.f;
      }
      __syncthreads();
      float acc[SE_BT];
#pragma unroll
      for (int bi = 0; bi < SE_BT; ++bi) acc[bi] = 0.f;
#pragma unroll
      for (int u = 0; u < SE_L1_ROWS; ++u) {
        const int cc = r + u * R;
        if (c0 + cc < C) {
          madd8(acc, ms + cc * SE_BT, w[u]);
        }
      }
#pragma unroll
      for (int bi = 0; bi < SE_BT; ++bi)
        red[(r * SE_BT + bi) * SE_L1_UNITS + jj] = acc[bi];
      __syncthreads();
      const int bi = t / SE_L1_UNITS, b = b0 + bi;  // thread (bi, jj)
      if (b < B && j < Cr) {
        float tot = 0.f;
        for (int rr = 0; rr < R; ++rr)
          tot += red[(rr * SE_BT + bi) * SE_L1_UNITS + jj];
        hpart[(((size_t)k * B + b) * 2 + m) * Cr + j] = tot;
      }
      __syncthreads();
    }
    __threadfence();
    __syncthreads();
    if (t == 0) atomicAdd(ctr + 3 + m, 1u);
  } else {
    // thread (r, cc) adds hidden units r, r+R2, ... for output channel c;
    // its weights load before the wait, all in flight at once
    item -= maps * KS * JI;
    const int tiles = (C + SE_L2_COLS - 1) / SE_L2_COLS;
    const int m = item / tiles, c0 = item % tiles * SE_L2_COLS;
    constexpr int R2 = SE_THREADS / SE_L2_COLS;
    constexpr int SE_L2_ROWS = SE_THREADS / R2;  // Cr <= SE_THREADS
    const int cc = t % SE_L2_COLS, r = t / SE_L2_COLS, c = c0 + cc;
    const float* b1 = m ? wd.b1 : wr.b1;
    const float* w2 = m ? wd.w2 : wr.w2;
    const float* b2 = m ? wd.b2 : wr.b2;
    float w[SE_L2_ROWS];
#pragma unroll
    for (int u = 0; u < SE_L2_ROWS; ++u) {
      const int jj = r + u * R2;
      w[u] = c < C && jj < Cr ? w2[(size_t)jj * C + c] : 0.f;
    }
    float* hs = sm;                         // [Cr][SE_BT] hidden units
    float* red = sm + SE_BT * SE_THREADS;   // [R2][SE_BT][SE_L2_COLS]
    wait_for(ctr + 3 + m, KS * JI);
    for (int b0 = 0; b0 < B; b0 += SE_BT) {
      // thread t's hidden units i = t, t + SE_THREADS, ... of the pass: the
      // KS slices' layer-1 sums, two units' loads in flight at once
      constexpr int KMAX = (SE_MAX_C + SE_SLICE - 1) / SE_SLICE;
      for (int o0 = 0; t + o0 * SE_THREADS < SE_BT * Cr; o0 += 2) {
        float v[2][KMAX];
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int i = t + (o0 + o) * SE_THREADS, bi = i / Cr;
          const int jj = i - bi * Cr, b = b0 + bi;
#pragma unroll
          for (int kk = 0; kk < KMAX; ++kk)
            v[o][kk] = i < SE_BT * Cr && b < B && kk < KS
                           ? __ldcg(hpart +
                                    (((size_t)kk * B + b) * 2 + m) * Cr + jj)
                           : 0.f;
        }
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int i = t + (o0 + o) * SE_THREADS, bi = i / Cr;
          if (i < SE_BT * Cr) {
            const int jj = i - bi * Cr;
            float tot = 0.f;
#pragma unroll
            for (int kk = 0; kk < KMAX; ++kk) tot += v[o][kk];
            hs[jj * SE_BT + bi] = b0 + bi < B ? fmaxf(tot + b1[jj], 0.f) : 0.f;
          }
        }
      }
      __syncthreads();
      float acc[SE_BT];
#pragma unroll
      for (int bi = 0; bi < SE_BT; ++bi) acc[bi] = 0.f;
#pragma unroll
      for (int u = 0; u < SE_L2_ROWS; ++u) {
        const int jj = r + u * R2;
        if (jj < Cr) {
          madd8(acc, hs + jj * SE_BT, w[u]);
        }
      }
#pragma unroll
      for (int bi = 0; bi < SE_BT; ++bi)
        red[(r * SE_BT + bi) * SE_L2_COLS + cc] = acc[bi];
      __syncthreads();
      if (t < SE_BT * SE_L2_COLS) {  // thread (bi, cc)
        const int bi = t / SE_L2_COLS, b = b0 + bi;
        if (b < B && c < C) {
          float a = 0.f;
          for (int rr = 0; rr < R2; ++rr)
            a += red[(rr * SE_BT + bi) * SE_L2_COLS + cc];
          const float sg = rnd<T>(sigmoidf_(a + b2[c]));
          const float wm = rnd<T>(w_rgb != nullptr ? w_rgb[b] : 0.f);
          const float w1m = rnd<T>(1.f - wm);
          scales[((size_t)b * 2 + m) * C + c] =
              m == 0 ? rnd<T>(wm + rnd<T>(w1m * sg)) : rnd<T>(w1m * sg);
        }
      }
      __syncthreads();
    }
  }
  if (last_block(ctr + SE_MLP_COUNTERS - 1, gridDim.x, slot) && t == 0)
    for (int i = 0; i < SE_MLP_COUNTERS - 1; ++i) ctr[i] = 0;
}

// grid (S, B), SE_THREADS threads, block (x, y) mixes chunk S-1-x of sample
// B-1-y: the reverse of the squeeze's order. The squeeze's thread mapping;
// each thread loads the scales of its groups once, and SE_UNROLL pixels'
// loads of both maps at once.
template <int G, int N, class T>
__global__ void __launch_bounds__(SE_THREADS)
    se_mix_kernel(const T* __restrict__ x_r, const T* __restrict__ x_d,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int HW, int C) {
  const int S = gridDim.x;
  const int s = S - 1 - (int)blockIdx.x;
  const int n = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int t = threadIdx.x, CN = C / N;
  const int CT = se_ct<G>(CN);
  const int P = SE_THREADS / CT;
  const int p = t / CT, gc = t - p * CT;
  if (p >= P) return;
  const bool two = x_d != nullptr;
  float sr[G][N], sd[G][N];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int g = gc + k * CT;
    const bool own = se_own<G>(g, CN);
    const float* sc = scales + (size_t)n * 2 * C + g * N;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 a = own ? load4(sc + 4 * i)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = own && two ? load4(sc + C + 4 * i)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      sr[k][4 * i] = a.x;
      sr[k][4 * i + 1] = a.y;
      sr[k][4 * i + 2] = a.z;
      sr[k][4 * i + 3] = a.w;
      sd[k][4 * i] = b.x;
      sd[k][4 * i + 1] = b.y;
      sd[k][4 * i + 2] = b.z;
      sd[k][4 * i + 3] = b.w;
    }
  }
  int q0, q1;
  split_range(HW, S, s, q0, q1);
  const size_t base = (size_t)n * HW * C;
  const T* xr = x_r + base;
  const T* xd = two ? x_d + base : nullptr;
  T* o = out + base;
  // out[e..e+N) from the loaded r (and d) of group k: each product and the
  // sum rounded to T
  auto mix = [&](int e, int k, const float(&r)[N], const float(&d)[N]) {
    float v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = rnd<T>(r[i] * sr[k][i]);
    if (two) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = rnd<T>(v[i] + rnd<T>(d[i] * sd[k][i]));
    }
    storev<N>(o + e, v);
  };
  int q = q0 + p;
  for (; q + (SE_UNROLL - 1) * P < q1; q += SE_UNROLL * P) {
    float r[SE_UNROLL][G][N], d[SE_UNROLL][G][N];
#pragma unroll
    for (int u = 0; u < SE_UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int g = gc + k * CT;
        if (se_own<G>(g, CN)) {
          const int e = N * ((q + u * P) * CN + g);
          loadv<N>(xr + e, r[u][k]);
          if (two) loadv<N>(xd + e, d[u][k]);
        }
      }
#pragma unroll
    for (int u = 0; u < SE_UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int g = gc + k * CT;
        if (se_own<G>(g, CN))
          mix(N * ((q + u * P) * CN + g), k, r[u][k], d[u][k]);
      }
  }
  for (; q < q1; q += P) {
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int g = gc + k * CT;
      if (se_own<G>(g, CN)) {
        const int e = N * (q * CN + g);
        float r[N], d[N];
        loadv<N>(xr + e, r);
        if (two) loadv<N>(xd + e, d);
        mix(e, k, r, d);
      }
    }
  }
}

template <int G, int N, class T>
static int se_launch(const T* x_r, const T* x_d, float* partial,
                     float* scales, float* means, float* hpart,
                     unsigned* counter, SeWeights wr, SeWeights wd,
                     const float* w_rgb, T* out, int B, int HW, int C, int Cr,
                     int S, cudaStream_t st) {
  dim3 grid(S, B);
  const bool split = C >= SE_SPLIT_C;
  const int maps = x_d != nullptr ? 2 : 1;
  const size_t smem = (size_t)se_smem_floats(C, Cr, N) * sizeof(float);
  se_squeeze_kernel<G, N, T><<<dim3(S, B, maps), SE_THREADS, smem, st>>>(
      x_r, x_d, partial, scales, split ? nullptr : counter, wr, wd, w_rgb,
      HW, C, Cr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (split) {
    se_mlp_kernel<T><<<maps * se_mlp_items(B, C, Cr), SE_THREADS,
                       SE_MLP_SMEM_FLOATS * sizeof(float), st>>>(
        partial, means, hpart, scales, counter, wr, wd, w_rgb, B, S, HW, C,
        Cr, maps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  se_mix_kernel<G, N, T><<<grid, SE_THREADS, 0, st>>>(x_r, x_d, scales, out,
                                                     HW, C);
  return (int)cudaGetLastError();
}

template <int N, class T>
static int se_groups(const T* x_r, const T* x_d, float* partial,
                     float* scales, float* means, float* hpart,
                     unsigned* counter, SeWeights wr, SeWeights wd,
                     const float* w_rgb, T* out, int B, int HW, int C, int Cr,
                     int S, cudaStream_t st) {
  if (C / N <= SE_THREADS)
    return se_launch<1, N, T>(x_r, x_d, partial, scales, means, hpart,
                              counter, wr, wd, w_rgb, out, B, HW, C, Cr, S,
                              st);
  return se_launch<SE_MAX_G, N, T>(x_r, x_d, partial, scales, means, hpart,
                                   counter, wr, wd, w_rgb, out, B, HW, C, Cr,
                                   S, st);
}

template <class T>
static int se_fuse(const T* x_r, const T* x_d, const float* w1r,
                   const float* b1r, const float* w2r, const float* b2r,
                   const float* w1d, const float* b1d, const float* w2d,
                   const float* b2d, const float* w_rgb, float* partial,
                   float* scales, float* means, float* hpart,
                   unsigned* counter, T* out, int B, int HW, int C, int Cr,
                   int S, int width, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const SeWeights wr{w1r, b1r, w2r, b2r}, wd{w1d, b1d, w2d, b2d};
  if (width < 4 || C % width || C > SE_MAX_C ||
      C > width * SE_THREADS * SE_MAX_G || Cr < 1 || Cr > SE_THREADS)
    return cudaErrorInvalidValue;
  if (width == 4)
    return se_groups<4, T>(x_r, x_d, partial, scales, means, hpart, counter,
                           wr, wd, w_rgb, out, B, HW, C, Cr, S, st);
  if constexpr (sizeof(T) == 2) {
    if (width == 8)
      return se_groups<8, T>(x_r, x_d, partial, scales, means, hpart,
                             counter, wr, wd, w_rgb, out, B, HW, C, Cr, S,
                             st);
  }
  return cudaErrorInvalidValue;
}

// The SE cell in two launches, three from C = SE_SPLIT_C up. width: the
// channels of one access, 16 / sizeof(T) or 4 (C % width == 0, maps aligned
// to width * sizeof(T) bytes: the wrapper picks it); C <= width*SE_THREADS*
// SE_MAX_G, Cr <= SE_THREADS; S splits per sample. x_d == nullptr:
// single-map SE (w = 0, the w*d weights unused). w_rgb == nullptr means
// w = 0. partial: B*S*2*C floats; scales: B*2*C; from SE_SPLIT_C up means
// B*2*C and hpart ceil(C/SE_SLICE)*B*2*Cr (else unused); counter:
// max(B, SE_MLP_COUNTERS) unsigned zeros, left at zero. The MLP weights and
// w_rgb are fp32 in both forms.
extern "C" int dynmm_se_fuse(const float* x_r, const float* x_d,
                             const float* w1r, const float* b1r,
                             const float* w2r, const float* b2r,
                             const float* w1d, const float* b1d,
                             const float* w2d, const float* b2d,
                             const float* w_rgb, float* partial,
                             float* scales, float* means, float* hpart,
                             unsigned* counter, float* out, int B, int HW,
                             int C, int Cr, int S, int width, void* stream) {
  return se_fuse(x_r, x_d, w1r, b1r, w2r, b2r, w1d, b1d, w2d, b2d, w_rgb,
                 partial, scales, means, hpart, counter, out, B, HW, C, Cr, S,
                 width, stream);
}

// The bf16 form: bf16 maps in and out.
extern "C" int dynmm_se_fuse_bf16(const bf16* x_r, const bf16* x_d,
                                  const float* w1r, const float* b1r,
                                  const float* w2r, const float* b2r,
                                  const float* w1d, const float* b1d,
                                  const float* w2d, const float* b2d,
                                  const float* w_rgb, float* partial,
                                  float* scales, float* means, float* hpart,
                                  unsigned* counter, bf16* out, int B,
                                  int HW, int C, int Cr, int S, int width,
                                  void* stream) {
  return se_fuse(x_r, x_d, w1r, b1r, w2r, b2r, w1d, b1d, w2d, b2d, w_rgb,
                 partial, scales, means, hpart, counter, out, B, HW, C, Cr, S,
                 width, stream);
}
