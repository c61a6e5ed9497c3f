// K5: W8A8 decode GEMV, K6: the fused W8 decode MLP, K7: W4A8 decode GEMV,
// and K8: the fused W4 decode MLP.
//
// Replace the JAX package's Pallas kernels in indextts_tpu/ops/gemv.py:
// `_gemv_kernel` / `gemv_w8`, `_mlp_kernel` / `mlp_w8`, `_gemv4_kernel` /
// `gemv_w4` and `_mlp4_kernel` / `mlp_w4`.
//
//   K5  y[r, f] = acc[r, f] * (a[r] * s[f]) + bias[f],  acc = sum_d xq[r, d] w[d, f]
//   K6  h = gelu_new(acc1 * (a * s1) + b1); per group g of `hb` hidden columns
//       hq = clip(rint(h / ha_g), +-127), ha_g = max|h_g| / 127 + 1e-12;
//       out = (p_0 + b2) + p_1 + ... + p_{G-1},  p_g = acc2_g * (ha_g * s2)
//   K7  K5 over a weight of D/2 packed rows: byte (i, f) holds w[i, f] in its
//       low nibble and w[i + D/2, f] in its high nibble, both signed
//   K8  K6 with fc packed so by rows, and fc2 packed by columns: byte (k, j)
//       holds fc2[k, j] (low) and fc2[k, j + D/2] (high)
//
// int8 weights (D, F) row-major, as the JAX tree stores them; xq is the int8
// decode row (1..16 rows) from `_quant_row`, a its per-row scale. Products
// accumulate exactly in int32; the float epilogue uses the same float32
// operations in the same order as the plain PyTorch versions (ops/gemv.py),
// with FMA contraction ruled out (__fmul_rn / __fadd_rn). On an H100 K5
// equals its plain version to the bit and K6 to within one unit in the last
// place. The group partials of K6 and K8 are added in group order by one
// thread per output: no float atomics, so repeated runs give the same bits.
//
// Bound on the H100: bytes. A decode row reads each weight byte once and
// does two (W8) or four (W4) integer operations per byte, far below the
// card's ridge. At batch 1 the work is one weight stream, so the design is
// about spreading it over the SMs: every kernel runs in clusters of 8 blocks
// (Hopper thread block clusters) that split one output tile's contraction
// and combine their int32 partials through distributed shared memory, so no
// partial sums go through device memory and each stream is one launch.
//
// Inside a block a thread owns 8 columns (one 8-byte load per weight row)
// and walks its rows in batches of 8 whose loads are all issued before any
// is used, so each thread keeps 64 bytes of the weight stream in flight.
// The accumulators are int32 registers for at most 4 rows (the decode rows,
// or a beam of 3) or, in a second instantiation, 16. Under W4 a packed row
// feeds two activations, xq[i] and xq[i + D/2], and its nibbles are
// sign-extended with two shifts each.
//
// - K5 / K7: a cluster owns 256 output columns; each of its blocks
//   contracts 1/8 of the (packed) rows, one warp per row (256 contiguous
//   bytes). Block rank 0 sums the 8 partials and applies the epilogue.
//   c_attn (1280 x 3840) runs 15 clusters, the int8 logits head (1280 x
//   8320, the last tile half used) 33.
// - K6 / K8 launch 1: a cluster owns one quantization group (hb columns),
//   each block hb/8 columns over all (packed) rows. The group's absmax is
//   the max of the 8 blocks' maxima, read through distributed shared
//   memory; the int8 hidden and its scales go to a small scratch (b x FH
//   int8, b x G f32).
// - K6 launch 2: a cluster owns 32 output columns; its blocks split each
//   group's rows 8 ways, keep one int32 partial per group in shared memory,
//   and rank 0 adds the groups in order.
// - K8 launch 2: a cluster owns 32 packed columns, so the 64 outputs j and
//   j + D/2 of them; a thread reads 4 packed columns (one 4-byte load) and
//   keeps the 8 outputs they feed, so the accumulators stay as many as K6's.
//   Otherwise as K6.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;
constexpr int kCluster = 8;
constexpr int kCols = 8;                // columns per thread: one 8-byte load
constexpr int kBatch = 8;               // weight rows loaded before use
constexpr int kGemvTile = 256;          // K5/K7 output columns per cluster
constexpr int kGemvColThreads = kGemvTile / kCols;
constexpr int kGemvSlots = kThreads / kGemvColThreads;
constexpr int kMaxGroupCols = 1536 / kCluster;  // K6/K8 launch 1 columns per block
constexpr int kFc2Tile = 32;            // K6 launch 2 output columns per cluster
constexpr int kFc2ColThreads = kFc2Tile / kCols;
constexpr int kFc2Slots = kThreads / kFc2ColThreads;
constexpr int kFc2Cols4 = 4;            // K8 launch 2 packed columns per thread
constexpr int kFc2ColThreads4 = kFc2Tile / kFc2Cols4;  // of 32 per cluster
constexpr int kFc2Slots4 = kThreads / kFc2ColThreads4;

// byte j of w as a signed int
__device__ __forceinline__ int sbyte(int w, int j) {
  return static_cast<int>(static_cast<int8_t>(w >> (8 * j)));
}

// the low and the high nibble of byte j of w, each sign-extended to -8..7
__device__ __forceinline__ int lo4(int w, int j) {
  return static_cast<int>(static_cast<unsigned>(w) << (28 - 8 * j)) >> 28;
}

__device__ __forceinline__ int hi4(int w, int j) {
  return static_cast<int>(static_cast<unsigned>(w) << (24 - 8 * j)) >> 28;
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

// the same for a packed row d, whose bytes hold weight rows d (low nibbles)
// and d + half (high nibbles)
template <int NB>
__device__ __forceinline__ void madd4(int (&acc)[NB][kCols], int2 w,
                                      const int8_t* __restrict__ xq, int nb,
                                      int ldx, int d, int half) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nb) {
      const int xl = __ldg(xq + (size_t)r * ldx + d);
      const int xh = __ldg(xq + (size_t)r * ldx + d + half);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[r][j] += xl * lo4(w.x, j) + xh * hi4(w.x, j);
        acc[r][4 + j] += xl * lo4(w.y, j) + xh * hi4(w.y, j);
      }
    }
  }
}

__device__ __forceinline__ int2 load_w8(const int8_t* p) {
  return __ldg(reinterpret_cast<const int2*>(p));
}

// acc += sum over the weight rows d = d0, d0 + step, ... < d1 of
// xq[:, d] * w[d, col:col+8] (W4: of the packed rows, with the high nibbles
// against xq[:, d + half]); the loads of each batch of 8 rows are issued
// before any of them is used
template <bool W4, int NB>
__device__ __forceinline__ void accumulate(int (&acc)[NB][kCols],
                                           const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ w,
                                           int nb, int ldx, int F, int col,
                                           int d0, int d1, int step, int half) {
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
      if (d < d1) {
        if constexpr (W4) {
          madd4(acc, wv[u], xq, nb, ldx, d, half);
        } else {
          madd(acc, wv[u], xq, nb, ldx, d);
        }
      }
    }
  }
}

// the block's partial sums into red[r * width + c + j] (shared, zeroed);
// with hi > 0, acc[r][4 + j] goes to red[r * width + hi + c + j] instead
// (K8 launch 2: the outputs of the high nibbles)
template <int NB>
__device__ __forceinline__ void reduce_to_shared(const int (&acc)[NB][kCols],
                                                 int* red, int nb, int width,
                                                 int c, int hi = 0) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nb) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k = hi > 0 && j >= 4 ? hi + c + j - 4 : c + j;
        atomicAdd(&red[r * width + k], acc[r][j]);
      }
    }
  }
}

__device__ __forceinline__ float gelu_new(float h) {
  const float h3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, h), h), h);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, h3));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, tanhf(inner)));
}

// ---------------------------------------------------------------------------
// K5 / K7
// ---------------------------------------------------------------------------

template <int NB, bool W4>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ a,
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

  const int rows = W4 ? D / 2 : D;  // weight rows in memory
  const int chunk = (rows + kCluster - 1) / kCluster;
  const int d0 = rank * chunk, d1 = min(rows, d0 + chunk);
  int acc[NB][kCols];
  zero(acc);
  if (col < F) accumulate<W4>(acc, xq, w, nb, D, F, col, d0 + slot, d1, kGemvSlots, rows);
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
// K6 / K8, launch 1: fc -> gelu_new -> per-group int8 quantization
// ---------------------------------------------------------------------------

template <int NB, bool W4>
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
    const int rows = W4 ? D / 2 : D;
    int acc[NB][kCols];
    zero(acc);
    accumulate<W4>(acc, xq, w1, nb, D, FH, col0 + c, slot, rows, slots, rows);
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
// K6 / K8, launch 2: grouped fc2, groups added in order
// ---------------------------------------------------------------------------

// acc[r][j] += hq[r, d] * fc2[d, col + j] over the 4 packed columns of w:
// j < 4 the low nibbles (outputs col + j), j >= 4 the high ones (outputs
// col + D/2 + j - 4)
template <int NB>
__device__ __forceinline__ void madd_cols4(int (&acc)[NB][kCols], int w,
                                           const int8_t* __restrict__ hq, int nb,
                                           int ldx, int d) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    if (r < nb) {
      const int x = __ldg(hq + (size_t)r * ldx + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[r][j] += x * lo4(w, j);
        acc[r][4 + j] += x * hi4(w, j);
      }
    }
  }
}

// W4: the cluster's 32 packed columns feed 64 outputs; part[] holds, per
// group and row, the 32 low outputs, then the 32 high ones
template <int NB, bool W4>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
mlp_fc2_kernel(const int8_t* __restrict__ hq, const float* __restrict__ ha,
               const int8_t* __restrict__ w2, const float* __restrict__ s2,
               const float* __restrict__ b2, float* __restrict__ out, int nb,
               int D, int FH, int hb) {
  extern __shared__ int part[];  // [group][row][width]
  constexpr int col_threads = W4 ? kFc2ColThreads4 : kFc2ColThreads;
  constexpr int slots = W4 ? kFc2Slots4 : kFc2Slots;
  constexpr int width = W4 ? 2 * kFc2Tile : kFc2Tile;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kCluster;
  const int n_groups = FH / hb;
  const int ldw = W4 ? D / 2 : D;  // bytes per row of fc2
  const int tid = threadIdx.x;
  const int c = (tid % col_threads) * (W4 ? kFc2Cols4 : kCols), slot = tid / col_threads;
  const int col = tile * kFc2Tile + c;
  const int per_group = nb * width;
  for (int i = tid; i < n_groups * per_group; i += kThreads) part[i] = 0;
  __syncthreads();

  // this block's rows of group g: g * hb + rank * rows + [0, rows); a thread
  // takes `per` of them in each group, and walks all groups' rows as one
  // sequence so that its batches of loads span the groups
  const int rows = hb / kCluster;
  const int per = (rows + slots - 1) / slots;
  const int total = n_groups * per;
  const int hi = W4 ? kFc2Tile : 0;
  int acc[NB][kCols];
  zero(acc);
  int g_cur = 0;
  for (int base = 0; base < total; base += kBatch) {
    int2 wv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = base + u, row = slot + (k % per) * slots;
      const int d = (k / per) * hb + rank * rows + row;
      const int8_t* p = w2 + (size_t)d * ldw + col;
      if (!(k < total && row < rows)) {
        wv[u] = make_int2(0, 0);
      } else if constexpr (W4) {
        wv[u] = make_int2(__ldg(reinterpret_cast<const int*>(p)), 0);
      } else {
        wv[u] = load_w8(p);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = base + u, g = k / per, row = slot + (k % per) * slots;
      if (k >= total) break;
      if (g != g_cur) {
        reduce_to_shared(acc, part + g_cur * per_group, nb, width, c, hi);
        zero(acc);
        g_cur = g;
      }
      if (row < rows) {
        const int d = g * hb + rank * rows + row;
        if constexpr (W4) {
          madd_cols4(acc, wv[u].x, hq, nb, FH, d);
        } else {
          madd(acc, wv[u], hq, nb, FH, d);
        }
      }
    }
  }
  reduce_to_shared(acc, part + g_cur * per_group, nb, width, c, hi);
  cluster.sync();

  if (rank == 0) {
    for (int i = tid; i < per_group; i += kThreads) {
      const int r = i / width, k = i % width;
      const int j = tile * kFc2Tile + (k < kFc2Tile ? k : D / 2 + k - kFc2Tile);
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

template <int NB, bool W4>
int launch_gemv(const int8_t* xq, const float* a, const int8_t* w, const float* s,
                const float* bias, float* y, int nb, int D, int F, cudaStream_t st) {
  const int tiles = (F + kGemvTile - 1) / kGemvTile;
  gemv_kernel<NB, W4><<<tiles * kCluster, kThreads, 0, st>>>(xq, a, w, s, bias, y, nb, D, F);
  return (int)cudaGetLastError();
}

template <int NB, bool W4>
int launch_mlp(const int8_t* xq, const float* a, const int8_t* w1, const float* s1,
               const float* b1, const int8_t* w2, const float* s2, const float* b2,
               int8_t* hq, float* ha, float* out, int nb, int D, int FH, int hb,
               cudaStream_t st) {
  const int n_groups = FH / hb;
  mlp_fc_kernel<NB, W4><<<n_groups * kCluster, kThreads, 0, st>>>(xq, a, w1, s1, b1, hq,
                                                                  ha, nb, D, FH, hb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // set on every call: the attribute holds per device, and the call is cheap
  const int width = W4 ? 2 * kFc2Tile : kFc2Tile;
  const int smem = n_groups * nb * width * (int)sizeof(int);
  e = cudaFuncSetAttribute(mlp_fc2_kernel<NB, W4>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (W4 ? D / 2 : D) / kFc2Tile;
  mlp_fc2_kernel<NB, W4><<<tiles * kCluster, kThreads, smem, st>>>(hq, ha, w2, s2, b2, out,
                                                                   nb, D, FH, hb);
  return (int)cudaGetLastError();
}

template <bool W4>
int gemv_entry(const void* xq, const void* a, const void* w, const void* s,
               const void* bias, void* y, int nb, int D, int F, void* stream) {
  if (nb < 1 || nb > kMaxRows || F % kCols || (W4 && D % 2)) return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch(static_cast<const int8_t*>(xq), static_cast<const float*>(a),
                  static_cast<const int8_t*>(w), static_cast<const float*>(s),
                  static_cast<const float*>(bias), static_cast<float*>(y), nb, D, F,
                  reinterpret_cast<cudaStream_t>(stream));
  };
  return nb <= 4 ? args(launch_gemv<4, W4>) : args(launch_gemv<kMaxRows, W4>);
}

template <bool W4>
int mlp_entry(const void* xq, const void* a, const void* w1, const void* s1,
              const void* b1, const void* w2, const void* s2, const void* b2,
              void* hq, void* ha, void* out, int nb, int D, int FH, int hb,
              void* stream) {
  if (nb < 1 || nb > kMaxRows || hb <= 0 || FH % hb || hb % (kCols * kCluster) ||
      hb / kCluster > kMaxGroupCols || D % (W4 ? 2 * kFc2Tile : kFc2Tile))
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch(static_cast<const int8_t*>(xq), static_cast<const float*>(a),
                  static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
                  static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
                  static_cast<const float*>(s2), static_cast<const float*>(b2),
                  static_cast<int8_t*>(hq), static_cast<float*>(ha), static_cast<float*>(out),
                  nb, D, FH, hb, reinterpret_cast<cudaStream_t>(stream));
  };
  return nb <= 4 ? args(launch_mlp<4, W4>) : args(launch_mlp<kMaxRows, W4>);
}

}  // namespace

EXPORT int gemv_w8(const void* xq, const void* a, const void* w, const void* s,
                   const void* bias, void* y, int nb, int D, int F, void* stream) {
  return gemv_entry<false>(xq, a, w, s, bias, y, nb, D, F, stream);
}

// w: (D/2, F) packed bytes
EXPORT int gemv_w4(const void* xq, const void* a, const void* w, const void* s,
                   const void* bias, void* y, int nb, int D, int F, void* stream) {
  return gemv_entry<true>(xq, a, w, s, bias, y, nb, D, F, stream);
}

EXPORT int mlp_w8(const void* xq, const void* a, const void* w1, const void* s1,
                  const void* b1, const void* w2, const void* s2, const void* b2,
                  void* hq, void* ha, void* out, int nb, int D, int FH, int hb,
                  void* stream) {
  return mlp_entry<false>(xq, a, w1, s1, b1, w2, s2, b2, hq, ha, out, nb, D, FH, hb, stream);
}

// w1: (D/2, FH) packed by rows; w2: (FH, D/2) packed by columns
EXPORT int mlp_w4(const void* xq, const void* a, const void* w1, const void* s1,
                  const void* b1, const void* w2, const void* s2, const void* b2,
                  void* hq, void* ha, void* out, int nb, int D, int FH, int hb,
                  void* stream) {
  return mlp_entry<true>(xq, a, w1, s1, b1, w2, s2, b2, hq, ha, out, nb, D, FH, hb, stream);
}
