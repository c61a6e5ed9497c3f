// K5: W8A8 decode GEMV, and K6: the fused W8 decode MLP.
//
// Replace the JAX package's Pallas kernels in indextts_tpu/ops/gemv.py:
// `_gemv_kernel` / `gemv_w8` and `_mlp_kernel` / `mlp_w8`.
//
//   K5  y[r, f] = acc[r, f] * (a[r] * s[f]) + bias[f],  acc = sum_d xq[r, d] w[d, f]
//   K6  h = gelu_new(acc1 * (a * s1) + b1); per group g of `hb` hidden columns
//       hq = clip(rint(h / ha_g), +-127), ha_g = max|h_g| / 127 + 1e-12;
//       out = (p_0 + b2) + p_1 + ... + p_{G-1},  p_g = acc2_g * (ha_g * s2)
//
// int8 weights (D, F) row-major, as the JAX tree stores them; xq is the int8
// decode row (1..16 rows) from `_quant_row`, a its per-row scale. Products
// accumulate exactly in int32; the float epilogue uses the same float32
// operations in the same order as the plain PyTorch versions (ops/gemv.py),
// with FMA contraction ruled out (__fmul_rn / __fadd_rn). On an H100 K5
// equals its plain version to the bit and K6 to within one unit in the last
// place. The group partials of K6 are added in group order by one thread per
// output: no float atomics, so repeated runs give the same bits.
//
// Bound on the H100: bytes. A decode row reads each weight byte once and
// does two integer operations per byte, far below the card's ridge. At
// batch 1 the work is one weight stream, so the design is about spreading
// it over the SMs: every kernel runs in clusters of 8 blocks (Hopper thread
// block clusters) that split one output tile's contraction and combine
// their int32 partials through distributed shared memory, so no partial
// sums go through device memory and each stream is one launch.
//
// Inside a block a thread owns 8 columns (one 8-byte load per weight row)
// and walks its rows in batches of 8 whose loads are all issued before any
// is used, so each thread keeps 64 bytes of the weight stream in flight.
// The accumulators are int32 registers for at most 4 rows (the decode rows,
// or a beam of 3) or, in a second instantiation, 16.
//
// - K5: a cluster owns 256 output columns; each of its blocks contracts
//   D/8 rows, one warp per weight row (256 contiguous bytes). Block rank 0
//   sums the 8 partials and applies the epilogue. c_attn (1280 x 3840) runs
//   15 clusters, the int8 logits head (1280 x 8320, the last tile half
//   used) 33.
// - K6 launch 1: a cluster owns one quantization group (hb columns), each
//   block hb/8 columns over all of D. The group's absmax is the max of the
//   8 blocks' maxima, read through distributed shared memory; the int8
//   hidden and its scales go to a small scratch (b x FH int8, b x G f32).
// - K6 launch 2: a cluster owns 32 output columns; its blocks split each
//   group's rows 8 ways, keep one int32 partial per group in shared memory,
//   and rank 0 adds the groups in order.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;
constexpr int kCluster = 8;
constexpr int kCols = 8;                // columns per thread: one 8-byte load
constexpr int kBatch = 8;               // weight rows loaded before use
constexpr int kGemvTile = 256;          // K5 output columns per cluster
constexpr int kGemvColThreads = kGemvTile / kCols;
constexpr int kGemvSlots = kThreads / kGemvColThreads;
constexpr int kMaxGroupCols = 1536 / kCluster;  // K6 launch 1 columns per block
constexpr int kFc2Tile = 32;            // K6 launch 2 output columns per cluster
constexpr int kFc2ColThreads = kFc2Tile / kCols;
constexpr int kFc2Slots = kThreads / kFc2ColThreads;

// byte j of w as a signed int
__device__ __forceinline__ int sbyte(int w, int j) {
  return static_cast<int>(static_cast<int8_t>(w >> (8 * j)));
}

template <int NB>
__device__ __forceinline__ void zero(int (&acc)[NB][kCols]) {
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0;
}

// acc[r][j] += xq[r, d] * w[d, j], j < 8, for the rows r < nb
template <int NB>
__device__ __forceinline__ void madd(int (&acc)[NB][kCols], int2 w,
                                     const int8_t* __restrict__ xq, int nb,
                                     int ldx, int d) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nb) {
      const int x = __ldg(xq + (size_t)r * ldx + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[r][j] += x * sbyte(w.x, j);
        acc[r][4 + j] += x * sbyte(w.y, j);
      }
    }
  }
}

__device__ __forceinline__ int2 load_w8(const int8_t* p) {
  return __ldg(reinterpret_cast<const int2*>(p));
}

// acc += sum over the weight rows d = d0, d0 + step, ... < d1 of
// xq[:, d] * w[d, col:col+8]; the loads of each batch of 8 rows are issued
// before any of them is used
template <int NB>
__device__ __forceinline__ void accumulate(int (&acc)[NB][kCols],
                                           const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ w,
                                           int nb, int ldx, int F, int col,
                                           int d0, int d1, int step) {
  for (int base = d0; base < d1; base += kBatch * step) {
    int2 wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int d = base + u * step;
      wv[u] = d < d1 ? load_w8(w + (size_t)d * F + col) : make_int2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int d = base + u * step;
      if (d < d1) madd(acc, wv[u], xq, nb, ldx, d);
    }
  }
}

// the block's partial sums into red[r * width + c + j] (shared, zeroed)
template <int NB>
__device__ __forceinline__ void reduce_to_shared(const int (&acc)[NB][kCols],
                                                 int* red, int nb, int width,
                                                 int c) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nb) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) atomicAdd(&red[r * width + c + j], acc[r][j]);
    }
  }
}

__device__ __forceinline__ float gelu_new(float h) {
  const float h3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, h), h), h);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, h3));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, tanhf(inner)));
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

template <int NB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
gemv_w8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ a,
               const int8_t* __restrict__ w, const float* __restrict__ s,
               const float* __restrict__ bias, float* __restrict__ y, int nb,
               int D, int F) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int c = (tid % kGemvColThreads) * kCols, slot = tid / kGemvColThreads;
  const int col = tile * kGemvTile + c;
  __shared__ int red[kMaxRows * kGemvTile];
  for (int i = tid; i < nb * kGemvTile; i += kThreads) red[i] = 0;
  __syncthreads();

  const int chunk = (D + kCluster - 1) / kCluster;
  const int d0 = rank * chunk, d1 = min(D, d0 + chunk);
  int acc[NB][kCols];
  zero(acc);
  if (col < F) accumulate(acc, xq, w, nb, D, F, col, d0 + slot, d1, kGemvSlots);
  reduce_to_shared(acc, red, nb, kGemvTile, c);
  cluster.sync();

  if (rank == 0) {
    for (int i = tid; i < nb * kGemvTile; i += kThreads) {
      const int r = i / kGemvTile, f = tile * kGemvTile + i % kGemvTile;
      if (f >= F) continue;
      int sum = 0;
      for (int q = 0; q < kCluster; ++q) sum += cluster.map_shared_rank(red, q)[i];
      y[(size_t)r * F + f] =
          __fadd_rn(__fmul_rn(__int2float_rn(sum), __fmul_rn(a[r], s[f])), bias[f]);
    }
  }
  // no block leaves while rank 0 still reads its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// K6, launch 1: fc -> gelu_new -> per-group int8 quantization
// ---------------------------------------------------------------------------

template <int NB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
mlp_fc_kernel(const int8_t* __restrict__ xq, const float* __restrict__ a,
              const int8_t* __restrict__ w1, const float* __restrict__ s1,
              const float* __restrict__ b1, int8_t* __restrict__ hq,
              float* __restrict__ ha, int nb, int D, int FH, int hb) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / kCluster;
  const int n_groups = FH / hb;
  const int width = hb / kCluster;        // columns of this block, <= 192
  const int col0 = group * hb + rank * width;
  const int tid = threadIdx.x;
  const int col_threads = width / kCols;
  const int slots = kThreads / col_threads;
  const int c = (tid % col_threads) * kCols, slot = tid / col_threads;
  __shared__ int red[kMaxRows * kMaxGroupCols];
  __shared__ float hs[kMaxRows * kMaxGroupCols];
  __shared__ int bmax[kMaxRows];
  __shared__ float scale[kMaxRows];
  for (int i = tid; i < nb * width; i += kThreads) red[i] = 0;
  if (tid < nb) bmax[tid] = 0;
  __syncthreads();

  if (slot < slots) {
    int acc[NB][kCols];
    zero(acc);
    accumulate(acc, xq, w1, nb, D, FH, col0 + c, slot, D, slots);
    reduce_to_shared(acc, red, nb, width, c);
  }
  __syncthreads();

  for (int i = tid; i < nb * width; i += kThreads) {
    const int r = i / width, col = col0 + i % width;
    float h = __fadd_rn(__fmul_rn(__int2float_rn(red[i]), __fmul_rn(a[r], s1[col])), b1[col]);
    h = gelu_new(h);
    hs[i] = h;
    // |h| >= 0, so its bits order as ints do: an exact, order-free max
    atomicMax(&bmax[r], __float_as_int(fabsf(h)));
  }
  cluster.sync();

  if (tid < nb) {
    int m = 0;
    for (int q = 0; q < kCluster; ++q) m = max(m, cluster.map_shared_rank(bmax, q)[tid]);
    const float sc = __fadd_rn(__fdiv_rn(__int_as_float(m), 127.0f), 1e-12f);
    scale[tid] = sc;
    if (rank == 0) ha[tid * n_groups + group] = sc;
  }
  __syncthreads();
  for (int i = tid; i < nb * width; i += kThreads) {
    const int r = i / width, col = col0 + i % width;
    const float q = fminf(fmaxf(rintf(__fdiv_rn(hs[i], scale[r])), -127.f), 127.f);
    hq[(size_t)r * FH + col] = (int8_t)q;
  }
  // no block leaves while another still reads its maxima
  cluster.sync();
}

// ---------------------------------------------------------------------------
// K6, launch 2: grouped fc2, groups added in order
// ---------------------------------------------------------------------------

template <int NB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
mlp_fc2_kernel(const int8_t* __restrict__ hq, const float* __restrict__ ha,
               const int8_t* __restrict__ w2, const float* __restrict__ s2,
               const float* __restrict__ b2, float* __restrict__ out, int nb,
               int D, int FH, int hb) {
  extern __shared__ int part[];  // [group][row][kFc2Tile]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kCluster;
  const int n_groups = FH / hb;
  const int tid = threadIdx.x;
  const int c = (tid % kFc2ColThreads) * kCols, slot = tid / kFc2ColThreads;
  const int col = tile * kFc2Tile + c;
  const int per_group = nb * kFc2Tile;
  for (int i = tid; i < n_groups * per_group; i += kThreads) part[i] = 0;
  __syncthreads();

  // this block's rows of group g: g * hb + rank * rows + [0, rows); a thread
  // takes `per` of them in each group, and walks all groups' rows as one
  // sequence so that its batches of loads span the groups
  const int rows = hb / kCluster;
  const int per = (rows + kFc2Slots - 1) / kFc2Slots;
  const int total = n_groups * per;
  int acc[NB][kCols];
  zero(acc);
  int g_cur = 0;
  for (int base = 0; base < total; base += kBatch) {
    int2 wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = base + u, row = slot + (k % per) * kFc2Slots;
      const int d = (k / per) * hb + rank * rows + row;
      wv[u] = k < total && row < rows ? load_w8(w2 + (size_t)d * D + col) : make_int2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = base + u, g = k / per, row = slot + (k % per) * kFc2Slots;
      if (k >= total) break;
      if (g != g_cur) {
        reduce_to_shared(acc, part + g_cur * per_group, nb, kFc2Tile, c);
        zero(acc);
        g_cur = g;
      }
      if (row < rows) madd(acc, wv[u], hq, nb, FH, g * hb + rank * rows + row);
    }
  }
  reduce_to_shared(acc, part + g_cur * per_group, nb, kFc2Tile, c);
  cluster.sync();

  if (rank == 0) {
    for (int i = tid; i < per_group; i += kThreads) {
      const int r = i / kFc2Tile, j = tile * kFc2Tile + i % kFc2Tile;
      float o = 0.f;
      for (int g = 0; g < n_groups; ++g) {
        int sum = 0;
        for (int q = 0; q < kCluster; ++q)
          sum += cluster.map_shared_rank(part, q)[g * per_group + i];
        const float p = __fmul_rn(__int2float_rn(sum), __fmul_rn(ha[r * n_groups + g], s2[j]));
        o = g == 0 ? __fadd_rn(p, b2[j]) : __fadd_rn(o, p);
      }
      out[(size_t)r * D + j] = o;
    }
  }
  cluster.sync();
}

template <int NB>
int launch_gemv(const int8_t* xq, const float* a, const int8_t* w, const float* s,
                const float* bias, float* y, int nb, int D, int F, cudaStream_t st) {
  const int tiles = (F + kGemvTile - 1) / kGemvTile;
  gemv_w8_kernel<NB><<<tiles * kCluster, kThreads, 0, st>>>(xq, a, w, s, bias, y, nb, D, F);
  return (int)cudaGetLastError();
}

template <int NB>
int launch_mlp(const int8_t* xq, const float* a, const int8_t* w1, const float* s1,
               const float* b1, const int8_t* w2, const float* s2, const float* b2,
               int8_t* hq, float* ha, float* out, int nb, int D, int FH, int hb,
               cudaStream_t st) {
  const int n_groups = FH / hb;
  mlp_fc_kernel<NB><<<n_groups * kCluster, kThreads, 0, st>>>(xq, a, w1, s1, b1, hq, ha,
                                                              nb, D, FH, hb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // set on every call: the attribute holds per device, and the call is cheap
  const int smem = n_groups * nb * kFc2Tile * (int)sizeof(int);
  e = cudaFuncSetAttribute(mlp_fc2_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  mlp_fc2_kernel<NB><<<(D / kFc2Tile) * kCluster, kThreads, smem, st>>>(
      hq, ha, w2, s2, b2, out, nb, D, FH, hb);
  return (int)cudaGetLastError();
}

}  // namespace

EXPORT int gemv_w8(const void* xq, const void* a, const void* w, const void* s,
                   const void* bias, void* y, int nb, int D, int F,
                   void* stream) {
  if (nb < 1 || nb > kMaxRows || F % kCols) return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch(static_cast<const int8_t*>(xq), static_cast<const float*>(a),
                  static_cast<const int8_t*>(w), static_cast<const float*>(s),
                  static_cast<const float*>(bias), static_cast<float*>(y), nb, D, F,
                  reinterpret_cast<cudaStream_t>(stream));
  };
  return nb <= 4 ? args(launch_gemv<4>) : args(launch_gemv<kMaxRows>);
}

EXPORT int mlp_w8(const void* xq, const void* a, const void* w1, const void* s1,
                  const void* b1, const void* w2, const void* s2, const void* b2,
                  void* hq, void* ha, void* out, int nb, int D, int FH, int hb,
                  void* stream) {
  if (nb < 1 || nb > kMaxRows || hb <= 0 || FH % hb || hb % (kCols * kCluster) ||
      hb / kCluster > kMaxGroupCols || D % kFc2Tile)
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch(static_cast<const int8_t*>(xq), static_cast<const float*>(a),
                  static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
                  static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
                  static_cast<const float*>(s2), static_cast<const float*>(b2),
                  static_cast<int8_t*>(hq), static_cast<float*>(ha), static_cast<float*>(out),
                  nb, D, FH, hb, reinterpret_cast<cudaStream_t>(stream));
  };
  return nb <= 4 ? args(launch_mlp<4>) : args(launch_mlp<kMaxRows>);
}
