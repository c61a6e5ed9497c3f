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
// with FMA contraction ruled out (__fmul_rn / __fadd_rn). On an H100 K5 and
// K7 equal their plain versions to the bit. The group partials of K6 and K8
// are added in group order by one thread per output: no float atomics, so
// repeated runs give the same bits.
//
// Bound on the H100: bytes. A decode row reads each weight byte once and
// does two (W8) or four (W4) integer operations per byte, far below the
// card's ridge. At batch 1 the work is one weight stream, so the design is
// about spreading it over the SMs and having it all in flight at once:
// every kernel runs in clusters of 8 blocks (Hopper thread block clusters)
// that get their weights by TMA and combine their int32 partials through
// distributed shared memory, so each call is one launch.
//
// - K5 / K7: a cluster owns a tile of 64, 128 or 256 output columns, the
//   widest whose grid gives every SM a block (ops/gemv.py `gemv_plan`; at
//   full width c_proj 64 columns in 160 blocks, c_attn 128 in 240, the
//   int8 logits head 256 in 264, its last tile half used), and block k of
//   it the k-th eighth of the (packed) weight rows. The block asks the copy
//   engine for its whole slice at once, so that it waits one device-memory
//   round trip: one 2-D box of rows x tile bytes up to 256 rows (5-40 KB a
//   block at full width; 5-8 smaller boxes, contracted as each lands, ran
//   slower at these sizes), else several, one lane and one barrier each.
//   A thread owns 4 columns and walks row quads with dp4a on
//   4 x 4 byte tiles transposed in registers; the decode rows are
//   regrouped in shared memory to match, once a block, so a warp reads
//   consecutive words. Under W4 a packed row feeds xq[i] (low nibbles) and
//   xq[i + D/2] (high), each nibble as a byte 16 times its value. Lanes
//   that share columns add by shuffles; each warp then stores its int32
//   partials straight into the shared memory of the rank that finishes
//   those columns (rank k: the tile's k-th eighth), and after one cluster
//   barrier each rank adds what it received and applies the epilogue,
//   whose operands it loaded at the start. A slice larger than a block
//   holds (past 12288 weight rows at 64 columns) goes in passes of boxes.
//   Blocks of 256 threads, for 4 rows or 16.
// - K6 / K8 follow the JAX kernel's pass over the hidden's groups, with the
//   groups in parallel: one cluster per group of hb columns, and block k of
//   it owns hidden columns [k*hb/8, (k+1)*hb/8) of the group. One thread
//   asks the copy engine (TMA) for the block's whole weight slice: the fc
//   columns as 2-D boxes (rows x hb/8 bytes, a barrier per box, so the fc
//   phase starts on the first box) and, once the first box has landed, its
//   contiguous fc2 rows as 1-D bulk copies; at full width 2 x 80 KB (W8) or
//   2 x 40 KB (W4) per SM. The block contracts its fc slice over all rows,
//   applies the epilogue and gelu_new, takes the group's absmax over the
//   cluster (distributed shared memory) and quantizes its own hidden slice,
//   which never leaves the SM. It then contracts its fc2 rows into int32
//   partials over all D outputs; rank k adds the 8 blocks' partials of
//   outputs [k*D/8, (k+1)*D/8): the group's float partial. The last group
//   keeps its own and, once a counter per span says the others have written
//   theirs to a (G - 1, b, D) scratch, adds the G partials in order.
//   Both contractions use dp4a on 4 x 4 byte tiles transposed in registers
//   (the weights keep their row-major layout); x and the hidden are
//   regrouped in shared memory to match, so a warp reads consecutive words.
//   Under W4 each nibble enters dp4a as a byte 16 times its value. Blocks
//   of up to 4 rows run 512 threads, of up to 16 rows 256.

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 16;
constexpr int kCluster = 8;
constexpr int kMaxSmem = 232448 - 1024;  // a block's shared memory on sm_90, less the static

// spins until *p == v (a gpu-scope acquire), with the same watchdog
__device__ __forceinline__ void wait_count(const unsigned* p, unsigned v) {
  const long long t0 = clock64();
  for (;;) {
    unsigned n;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(n) : "l"(p) : "memory");
    if (n == v) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// w[i] holds 4 bytes of row i of a 4 x 4 byte tile; returns its columns:
// byte i of t[j] is byte j of w[i]
__device__ __forceinline__ void transpose4(const int (&w)[4], int (&t)[4]) {
  const int a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[2], w[3], 0x5140);
  const int c = __byte_perm(w[0], w[1], 0x7362), d = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(a, b, 0x5410);
  t[1] = __byte_perm(a, b, 0x7632);
  t[2] = __byte_perm(c, d, 0x5410);
  t[3] = __byte_perm(c, d, 0x7632);
}

// the signed nibbles of each byte of t, as bytes 16 times their value: a
// dot product of them is 16 times the nibbles' one, and exact
__device__ __forceinline__ int lo16(int t) { return (t << 4) & 0xF0F0F0F0; }
__device__ __forceinline__ int hi16(int t) { return t & 0xF0F0F0F0; }

__host__ __device__ __forceinline__ int up128(int n) { return (n + 127) / 128 * 128; }

// The contractions see the row count at compile time: the decode path's
// single row gets loops free of per-row branches, so that the compiler can
// issue the next row quads' loads early.
template <int NB, class Body>
__device__ __forceinline__ void for_rows(int nb, Body&& body) {
  if constexpr (NB <= 4) {
    if (nb == 1) return body(std::integral_constant<int, 1>());
  }
  body(std::integral_constant<int, NB>());
}

__device__ __forceinline__ float gelu_new(float h) {
  const float h3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, h), h), h);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(h, h3));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, tanhf(inner)));
}

// ---------------------------------------------------------------------------
// K5 / K7: one launch, one cluster per tile of output columns
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;
constexpr int kMaxBoxes = 32;  // weight boxes (and their barriers) a block holds at once

// every output of a tile's rank-th eighth of columns, for every row, is
// finished by one thread: at most two a thread
static_assert(kMaxRows * (256 / kCluster) <= 2 * kGemvThreads, "K5/K7 epilogue slots");

// the int32 partials a K5/K7 block sends per output once the lanes that
// share columns have added by shuffles: one a warp while a weight row of the
// tile is narrower than a warp's 32 words, else one a slot of threads
__host__ __device__ constexpr int gemv_partials(int tile) {
  return kGemvThreads / (tile / 4 < 32 ? 32 : tile / 4);
}

// The dynamic shared memory of a K5/K7 block (byte offsets): the weight
// boxes of one pass, pass_rows x tile bytes; the pass's decode rows
// regrouped, nb x pass_rows bytes (W4: twice, the rows that meet the low
// nibbles and those that meet the high ones); and the partials the
// cluster's blocks send this block for its outputs, kCluster x
// gemv_partials x nb x tile/kCluster int32
struct GemvSmem {
  int x, recv, total;
  __host__ __device__ GemvSmem(int nb, int pass_rows, int tile, bool w4) {
    x = up128(pass_rows * tile);
    recv = x + up128(nb * pass_rows * (w4 ? 2 : 1));
    total = recv + up128(gemv_partials(tile) * nb * tile * 4) + 128;  // + 128: the base is aligned
  }
};

// y[r, f] for the tile of `tile` columns at blockIdx.x / 8; block `rank` of
// the cluster contracts (packed) weight rows [rank * R/8, (rank + 1) * R/8),
// as boxes of rb rows, pass_boxes at a time, and finishes the tile's
// rank-th eighth of columns
template <int NB, bool W4>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kGemvThreads)
gemv_kernel(const __grid_constant__ CUtensorMap w_map, const int8_t* __restrict__ xq,
            const float* __restrict__ a, const float* __restrict__ s,
            const float* __restrict__ bias, float* __restrict__ y, int nb, int D, int F,
            int tile, int rb, int pass_boxes) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int col0 = blockIdx.x / kCluster * tile;
  const int R = W4 ? D / 2 : D, n_boxes = R / kCluster / rb;
  const int d0 = rank * (R / kCluster);  // the block's first weight row
  const int q4 = rb / 4, units = tile / 4, slots = kGemvThreads / units;
  const int tid = threadIdx.x, lane = tid % 32, u = tid % units, slot = tid / units;
  const int cpr = tile / kCluster, n_parts = gemv_partials(tile);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const GemvSmem L(nb, pass_boxes * rb, tile, W4);
  const int* w_s = reinterpret_cast<const int*>(smem);
  int* x_s = reinterpret_cast<int*>(smem + L.x);
  int* recv = reinterpret_cast<int*>(smem + L.recv);
  __shared__ uint64_t bars[kMaxBoxes];

  // 1. The block says it has started: the others may store into its shared
  //    memory once they have seen every block's arrival. The outputs this
  //    rank finishes (the tile's rank-th eighth of columns, every row) have
  //    their epilogue operands loaded now, so that the latency lies under
  //    the weights'.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (tid == 0)
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&w_map))
                 : "memory");
  const int outs = nb * cpr;
  float ep_a[2] = {}, ep_s[2] = {}, ep_b[2] = {};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = tid + k * kGemvThreads, f = col0 + rank * cpr + i % cpr;
    if (i < outs && f < F) {
      ep_a[k] = a[i / cpr];
      ep_s[k] = s[f];
      ep_b[k] = bias[f];
    }
  }

  for_rows<NB>(nb, [&](auto rows) {
    constexpr int ROWS = decltype(rows)::value;
    int acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    for (int b0 = 0, pass = 0; b0 < n_boxes; b0 += pass_boxes, ++pass) {
      const int boxes = min(pass_boxes, n_boxes - b0), quads = boxes * q4;
      // 2. lane c of the first warp asks the copy engine for box c of the
      //    pass, on barrier c: at every width of this model one pass, the
      //    block's whole slice at once
      if (tid < boxes) {
        if (pass == 0) {
          mbar_init(&bars[tid], 1);
          asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
        mbar_expect_tx(&bars[tid], rb * tile);
        tma_load_2d(smem + tid * rb * tile, &w_map, col0, d0 + (b0 + tid) * rb, &bars[tid]);
      }
      // 3. the pass's decode rows, regrouped: word c*q4 + k of row r holds x
      //    at rows k + i*q4 of box c (i < 4), so that a warp reads
      //    consecutive words of a box
      for (int e = tid; e < nb * quads; e += kGemvThreads) {
        const int r = e / quads, Q = e % quads;
        const int8_t* xr = xq + (size_t)r * D + d0 + (b0 + Q / q4) * rb + Q % q4;
        constexpr int kWords = W4 ? 2 : 1;  // W4: x at row d, then at row d + D/2
#pragma unroll
        for (int h = 0; h < kWords; ++h) {
          int word = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) word |= (xr[i * q4 + h * R] & 0xFF) << (8 * i);
          x_s[kWords * e + h] = word;
        }
      }
      __syncthreads();

      // 4. a thread owns 4 columns (one word of each weight row) and every
      //    slots-th quad of the pass, each box as it lands; dp4a on the
      //    transposed 4 x 4 bytes. Under W4 each byte's low nibble meets x
      //    at row d, its high nibble x at row d + D/2, as bytes 16 times
      //    their value.
      for (int c = 0; c < boxes; ++c) {
        int k = (slot - c * q4 % slots + slots) % slots;  // the first quad of box c
        if (k >= q4) continue;
        mbar_wait(&bars[c], pass & 1);
        const int* wb = w_s + c * rb * units + u;
#pragma unroll 2
        for (; k < q4; k += slots) {
          const int Q = c * q4 + k;
          int wv[4], t[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = wb[(k + i * q4) * units];
          transpose4(wv, t);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (ROWS == 1 || r < nb) {
              if constexpr (W4) {
                const int xl = x_s[2 * (r * quads + Q)], xh = x_s[2 * (r * quads + Q) + 1];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  acc[r][j] = __dp4a(lo16(t[j]), xl, acc[r][j]);
                  acc[r][j] = __dp4a(hi16(t[j]), xh, acc[r][j]);
                }
              } else {
                const int xw = x_s[r * quads + Q];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a(t[j], xw, acc[r][j]);
              }
            }
          }
        }
      }
      // a further pass's boxes and rows go over this one's
      if (b0 + pass_boxes < n_boxes) __syncthreads();
    }

    // 5. the lanes of a warp that share columns add by shuffles (at 64
    //    columns a warp holds two slots); then each warp (or slot) stores
    //    its partial of 4 columns straight into the shared memory of the
    //    rank that finishes them, once every block has started: no shared
    //    atomics, no second pass
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    const int p = tid / (units < 32 ? 32 : units), owner = 4 * u / cpr;
    int* dst = cluster.map_shared_rank(recv, owner) + (rank * n_parts + p) * nb * cpr +
               4 * u - owner * cpr;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (ROWS == 1 || r < nb) {
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = W4 ? acc[r][j] >> 4 : acc[r][j];
          for (int off = units; off < 32; off *= 2) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
        }
        if (lane < units)
          *reinterpret_cast<int4*>(dst + r * cpr) = make_int4(v[0], v[1], v[2], v[3]);
      }
    }
  });
  // every block's partials have landed (the arrivals release the stores,
  // the wait acquires them); no block reads another's memory past here
  cluster.sync();

  // 6. rank k adds the partials of its outputs (int32: exact in any order)
  //    and applies the epilogue with the plain version's float32 operations
  //    in their order
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = tid + k * kGemvThreads, c = i % cpr, f = col0 + rank * cpr + c;
    if (i < outs && f < F) {
      const int r = i / cpr;
      int sum = 0;
#pragma unroll 8
      for (int q = 0; q < kCluster * n_parts; ++q) sum += recv[(q * nb + r) * cpr + c];
      y[(size_t)r * F + f] =
          __fadd_rn(__fmul_rn(__int2float_rn(sum), __fmul_rn(ep_a[k], ep_s[k])), ep_b[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// K6 / K8: one launch, one cluster per hidden group
// ---------------------------------------------------------------------------

// The dynamic shared memory of one block (byte offsets). `w` hidden columns
// of the block's group slice; R (packed) rows of fc; fc2 rows of RB bytes.
//   fc     R x w bytes, the fc column slice (2-D TMA, in chunks of rc rows)
//   x      the decode rows, 4 bytes of a row quad per word (W4: the low
//          nibbles' word, then the high nibbles'): nb x D bytes
//   xq     a copy of xq (nb x D bytes), which x is regrouped from
//   part   the block's int32 fc2 partials (nb x D), over fc, x and xq, which
//          the fc phase leaves dead; so a block needs at most about
//          max(R*w + 2*nb*D, 4*nb*D) + w*RB bytes: at 16 rows up to 201 KB
//          (W8) and 169 KB (W4) at D=2048, FH=8192
//   fc2    w x RB bytes, the block's fc2 rows (1-D bulk copies)
//   hq     the block's quantized hidden, 4 bytes of a row quad per word
//   red    nb x w int32 fc sums, then the hidden as float
//   vec    copies of s1 and b1 at the block's w hidden columns, and of s2 and
//          b2 at its D/8 outputs

struct MlpSmem {
  int x, xq, fc2, hq, red, vec, vec_bytes, total;
  __host__ __device__ MlpSmem(int nb, int D, int w, bool w4) {
    const int R = w4 ? D / 2 : D, RB = w4 ? D / 2 : D;
    x = up128(R * w);
    xq = x + up128(nb * D);
    const int dead = xq + up128(nb * D);  // fc, x and xq: then part
    fc2 = dead > nb * D * 4 ? dead : up128(nb * D * 4);
    hq = fc2 + up128(w * RB);
    red = hq + up128(nb * w);
    vec = red + up128(nb * w * 4);
    vec_bytes = 2 * w * 4 + 2 * (D / 8) * 4;
    total = vec + up128(vec_bytes) + 128;  // + 128: the base is aligned in the kernel
  }
};

constexpr int kMaxChunks = 32;  // fc chunks (TMA boxes) per block
constexpr int kPiece = 16384;   // bytes per bulk copy of fc2

// threads of a K6/K8 block: more warps hide more shared-memory latency in
// the contractions, as far as the 16-row accumulators leave registers
__host__ __device__ constexpr int mlp_threads(int nb) { return nb <= 4 ? 512 : 256; }

template <int NB, bool W4>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(mlp_threads(NB), 1)
mlp_kernel(const __grid_constant__ CUtensorMap fc_map, const int8_t* __restrict__ xq,
           const float* __restrict__ a, const float* __restrict__ s1,
           const float* __restrict__ b1, const int8_t* __restrict__ w2,
           const float* __restrict__ s2, const float* __restrict__ b2,
           float* __restrict__ parts, unsigned* __restrict__ arrived,
           float* __restrict__ out, int nb, int D, int FH, int hb, int rc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / kCluster, n_groups = FH / hb;
  const int w = hb / kCluster;               // hidden columns of this block
  const int col0 = g * hb + rank * w;
  const int R = W4 ? D / 2 : D, RB = W4 ? D / 2 : D;
  const int n_chunks = R / rc, quads = R / 4;
  constexpr int kT = mlp_threads(NB);
  const int tid = threadIdx.x, lane = tid % 32;

  // aligned by pointer arithmetic on the shared array, so that the compiler
  // keeps its accesses in the shared space (LDS, not generic loads)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const MlpSmem L(nb, D, w, W4);
  int8_t* fc_s = reinterpret_cast<int8_t*>(smem);
  int* part = reinterpret_cast<int*>(smem);
  int8_t* fc2_s = reinterpret_cast<int8_t*>(smem + L.fc2);
  int* x_s = reinterpret_cast<int*>(smem + L.x);
  int* hq_s = reinterpret_cast<int*>(smem + L.hq);
  int* red = reinterpret_cast<int*>(smem + L.red);
  float* hs = reinterpret_cast<float*>(red);
  const int span = D / kCluster, j0 = rank * span;  // the outputs this rank finishes
  int8_t* xq_s = reinterpret_cast<int8_t*>(smem + L.xq);
  float* s1_s = reinterpret_cast<float*>(smem + L.vec);
  float* b1_s = s1_s + w;
  float* s2_s = b1_s + w;
  float* b2_s = s2_s + span;
  // barriers: fc chunks, all of fc2, the vectors
  __shared__ uint64_t bars[kMaxChunks + 2];
  __shared__ float a_s[kMaxRows];
  __shared__ int bmax[kMaxRows];
  __shared__ float scale[kMaxRows];
  uint64_t* vec_bar = &bars[n_chunks + 1];

  // fc2 is requested once the first fc box has landed (at once if fc is one
  // box): fc's boxes then go ahead of it in the memory queues, and the
  // steps between the two contractions overlap fc2's arrival
  const int fc2_after = n_chunks > 1 ? 0 : -1;
  auto issue_fc2 = [&] {
    const int bytes = w * RB;
    const int8_t* src = w2 + (size_t)(g * hb + rank * w) * RB;
    mbar_expect_tx(&bars[n_chunks], bytes);
    for (int off = 0; off < bytes; off += kPiece)
      bulk_load(fc2_s + off, src + off, min(kPiece, bytes - off), &bars[n_chunks]);
  };

  // 1. one thread starts the block's copies, the small vectors first: at
  //    full width 2 x 80 KB of weights (W8) in flight
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&fc_map))
                 : "memory");
    for (int c = 0; c <= n_chunks + 1; ++c) mbar_init(&bars[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < nb) bmax[tid] = 0;
  for (int i = tid; i < nb * w; i += kT) red[i] = 0;
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(vec_bar, nb * D + L.vec_bytes);
    bulk_load(xq_s, xq, nb * D, vec_bar);
    bulk_load(s1_s, s1 + col0, w * 4, vec_bar);
    bulk_load(b1_s, b1 + col0, w * 4, vec_bar);
    bulk_load(s2_s, s2 + j0, span * 4, vec_bar);
    bulk_load(b2_s, b2 + j0, span * 4, vec_bar);
    for (int c = 0; c < n_chunks; ++c) {
      mbar_expect_tx(&bars[c], rc * w);
      tma_load_2d(fc_s + c * rc * w, &fc_map, col0, c * rc, &bars[c]);
    }
    if (fc2_after < 0) issue_fc2();
  }
  if (tid < nb) a_s[tid] = a[tid];  // after the copies start: its latency is off their path
  // the decode rows, regrouped: quad q of chunk c covers the fc rows
  // c*rc + k + i*rc/4 (i < 4, q = c*rc/4 + k), so that a warp reads
  // consecutive words of the fc slice; word q of row r holds x at those rows
  mbar_wait(vec_bar);
  for (int e = tid; e < nb * quads; e += kT) {
    const int r = e / quads, q = e % quads, q4 = rc / 4;
    const int row = (q / q4) * rc + q % q4;
    const int8_t* xr = xq_s + r * D;
    int lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo |= (xr[row + i * q4] & 0xFF) << (8 * i);
      if constexpr (W4) hi |= (xr[row + i * q4 + R] & 0xFF) << (8 * i);
    }
    if constexpr (W4) {
      x_s[2 * e] = lo;
      x_s[2 * e + 1] = hi;
    } else {
      x_s[e] = lo;
    }
  }
  __syncthreads();

  // 2. fc: a thread owns 4 columns (one word of each row) and walks row
  //    quads; dp4a on the transposed 4 x 4 bytes. Under W4 each byte's low
  //    nibble meets x at row d, its high nibble x at row d + D/2.
  for_rows<NB>(nb, [&](auto rows) {
    constexpr int ROWS = decltype(rows)::value;
    const int units = w / 4, slots = kT / units;
    const int u = tid % units, slot = tid / units;
    const int q4 = rc / 4;
    int acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(&bars[c]);
      if (tid == 0 && c == fc2_after) issue_fc2();
      if (slot >= slots) continue;
      const int* wc = reinterpret_cast<const int*>(fc_s + c * rc * w);
#pragma unroll 4
      for (int k = slot; k < q4; k += slots) {
        int wv[4], t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = wc[(k + i * q4) * units + u];
        transpose4(wv, t);
        const int q = c * q4 + k;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (ROWS == 1 || r < nb) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if constexpr (W4) {
                acc[r][j] = __dp4a(lo16(t[j]), x_s[2 * (r * quads + q)], acc[r][j]);
                acc[r][j] = __dp4a(hi16(t[j]), x_s[2 * (r * quads + q) + 1], acc[r][j]);
              } else {
                acc[r][j] = __dp4a(t[j], x_s[r * quads + q], acc[r][j]);
              }
            }
          }
        }
      }
    }
    // lanes that share a unit first add by shuffles (units a power of two
    // below 32), so an address of red takes at most 8 atomics
    const bool shuffle = units < 32 && (32 % units) == 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (ROWS == 1 || r < nb) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int v = W4 ? acc[r][j] >> 4 : acc[r][j];
          if (shuffle)
            for (int off = units; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (slot < slots && (!shuffle || lane < units)) atomicAdd(&red[r * w + 4 * u + j], v);
        }
      }
    }
  });
  __syncthreads();

  // 3. the epilogue and gelu_new; each row's max |h| over the block (by
  //    warps when a warp lies in one row), then the group's over the
  //    cluster (|h| >= 0, so its bits order as ints do: an exact max)
  for (int i = tid; i < nb * w; i += kT) {
    const int r = i / w, c = i % w;
    const float h = gelu_new(
        __fadd_rn(__fmul_rn(__int2float_rn(red[i]), __fmul_rn(a_s[r], s1_s[c])), b1_s[c]));
    hs[i] = h;
    int m = __float_as_int(fabsf(h));
    if (w % 32 == 0) m = __reduce_max_sync(0xffffffffu, m);
    if (w % 32 != 0 || lane == 0) atomicMax(&bmax[r], m);
  }
  cluster.sync();

  // the block's hidden slice, quantized with the group's scale (max / 127,
  // divided as the JAX kernels do), regrouped as x was: word k of row r
  // holds the hidden at columns k + i*w/4. Phase 4 splits the rows kp ways
  // when it has threads to spare, and then adds into zeroed partials.
  const int hq4 = w / 4, units2 = RB / 4;
  const int kp = max(1, min(hq4, kT / units2));
  if (kp > 1)
    for (int i = tid; i < nb * D; i += kT) part[i] = 0;
  for (int i = tid; i < nb * w; i += kT) {
    const int r = i / w, c = i % w;
    int m = 0;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) m = max(m, cluster.map_shared_rank(bmax, q)[r]);
    const float sc = __fadd_rn(__fdiv_rn(__int_as_float(m), 127.0f), 1e-12f);
    if (c == 0) scale[r] = sc;
    const float q = fminf(fmaxf(rintf(__fdiv_rn(hs[i], sc)), -127.f), 127.f);
    reinterpret_cast<int8_t*>(hq_s)[(r * hq4 + c % hq4) * 4 + c / hq4] = (int8_t)q;
  }
  __syncthreads();

  // 4. fc2 over the block's w rows: a thread owns one word of each row (4
  //    outputs; W4: 4 packed columns, outputs j and j + D/2) and every
  //    kp-th row quad; the sums go over fc, x and xq, now read
  mbar_wait(&bars[n_chunks]);
  for_rows<NB>(nb, [&](auto rows) {
    constexpr int ROWS = decltype(rows)::value;
    const int units = units2;
    const int* wc = reinterpret_cast<const int*>(fc2_s);
    for (int e = tid; e < units * kp; e += kT) {
      const int u = e % units;
      int acc[ROWS][W4 ? 8 : 4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < (W4 ? 8 : 4); ++j) acc[r][j] = 0;
#pragma unroll 4
      for (int k = e / units; k < hq4; k += kp) {
        int wv[4], t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = wc[(k + i * hq4) * units + u];
        transpose4(wv, t);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (ROWS == 1 || r < nb) {
            const int h = hq_s[r * hq4 + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if constexpr (W4) {
                acc[r][j] = __dp4a(lo16(t[j]), h, acc[r][j]);
                acc[r][4 + j] = __dp4a(hi16(t[j]), h, acc[r][4 + j]);
              } else {
                acc[r][j] = __dp4a(t[j], h, acc[r][j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (ROWS == 1 || r < nb) {
          int* p = part + r * D + 4 * u;
          if constexpr (W4) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] >>= 4;
          }
          if (kp > 1) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              atomicAdd(p + j, acc[r][j]);
              if constexpr (W4) atomicAdd(p + D / 2 + j, acc[r][4 + j]);
            }
          } else {
            *reinterpret_cast<int4*>(p) = make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            if constexpr (W4)
              *reinterpret_cast<int4*>(p + D / 2) =
                  make_int4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
          }
        }
      }
    }
  });
  cluster.sync();

  // 5. rank q adds the 8 blocks' partials of outputs [j0, j0 + span)
  //    through distributed shared memory: p_g, the group's float partial.
  //    Every group but the last writes it to `parts` and counts itself in
  //    arrived[q]; the last group keeps its own in shared memory (over fc2,
  //    now read), waits for the count, adds the partials in order, b2 with
  //    group 0, and re-arms the counter. The writes are ordered before the
  //    count by the block barrier and one thread's fence, the reads after
  //    it by the acquire and the block barrier.
  const bool owner = g == n_groups - 1;
  float* own = reinterpret_cast<float*>(fc2_s);
  for (int i = tid; i < nb * span; i += kT) {
    const int r = i / span, j = j0 + i % span;
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) sum += cluster.map_shared_rank(part, q)[r * D + j];
    const float p = __fmul_rn(__int2float_rn(sum), __fmul_rn(scale[r], s2_s[j - j0]));
    if (owner) {
      own[i] = p;
    } else {
      parts[((size_t)g * nb + r) * D + j] = p;
    }
  }
  // the block has read the cluster's shared memory (relaxed: the arrive
  // need not wait for the stores above)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    if (owner) {
      wait_count(arrived + rank, n_groups - 1);
      arrived[rank] = 0;
    } else {
      __threadfence();
      atomicAdd(arrived + rank, 1u);
    }
  }
  if (owner) {
    __syncthreads();
    for (int i = tid; i < nb * span; i += kT) {
      const int r = i / span, j = j0 + i % span;
      float o = n_groups == 1 ? own[i] : __ldcg(parts + (size_t)r * D + j);
      o = __fadd_rn(o, b2_s[j - j0]);
#pragma unroll 4
      for (int gg = 1; gg < n_groups - 1; ++gg)
        o = __fadd_rn(o, __ldcg(parts + ((size_t)gg * nb + r) * D + j));
      if (n_groups > 1) o = __fadd_rn(o, own[i]);
      out[(size_t)r * D + j] = o;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Host-side set-up of the K5-K8 launches, kept across calls and shared by
// the calling threads under one lock: the tensor map of each weight seen in
// each box shape (it depends only on the weight's address, shape and box).
std::mutex host_lock;
std::map<std::tuple<const void*, int, int, int, int>, CUtensorMap> weight_maps;
constexpr size_t kMaxMaps = 4096;  // past this many weights the cache starts over

// allows `kernel` `smem` bytes of dynamic shared memory on the current
// device (allowed: the bytes each device has been allowed so far), and
// gives the tensor map of the int8 (rows, cols) row-major weight w in boxes
// of box_rows x box_cols bytes
int launch_setup(const void* kernel, int* allowed, int smem, const void* w, int cols, int rows,
                 int box_cols, int box_rows, CUtensorMap* map) {
  const int e = allow_smem(kernel, allowed, smem);
  if (e != 0) return e;
  std::lock_guard<std::mutex> hold(host_lock);
  const auto key = std::make_tuple(w, cols, rows, box_cols, box_rows);
  const auto found = weight_maps.find(key);
  if (found != weight_maps.end()) {
    *map = found->second;
    return 0;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (weight_maps.size() >= kMaxMaps) weight_maps.clear();
  weight_maps.emplace(key, *map);
  return 0;
}

// w: (R, F) int8 (R = D, or D/2 packed rows under W4); the plan (tile,
// rb, pass_boxes) from ops/gemv.py `gemv_plan`. Columns past F in the last
// tile come in as zeros (the box's out-of-bounds fill) and are not written.
template <int NB, bool W4>
int launch_gemv(const int8_t* xq, const float* a, const int8_t* w, const float* s,
                const float* bias, float* y, int nb, int D, int F, int tile, int rb,
                int pass_boxes, cudaStream_t st) {
  const int R = W4 ? D / 2 : D, block_rows = R / kCluster;
  if ((tile != 64 && tile != 128 && tile != 256) || R % (4 * kCluster) || rb < 4 || rb % 4 ||
      rb > 256 || block_rows % rb || pass_boxes < 1 || pass_boxes > kMaxBoxes)
    return (int)cudaErrorInvalidValue;
  if (pass_boxes > block_rows / rb) pass_boxes = block_rows / rb;
  const GemvSmem L(nb, pass_boxes * rb, tile, W4);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int allowed[kMaxDevices] = {};  // bytes, per instantiation
  CUtensorMap map;
  const int e = launch_setup(reinterpret_cast<const void*>(gemv_kernel<NB, W4>), allowed,
                             L.total, w, F, R, tile, rb, &map);
  if (e != 0) return e;
  gemv_kernel<NB, W4><<<(F + tile - 1) / tile * kCluster, kGemvThreads, L.total, st>>>(
      map, xq, a, s, bias, y, nb, D, F, tile, rb, pass_boxes);
  return (int)cudaGetLastError();
}

// parts: a (G - 1, nb, D) f32 scratch; arrived: kCluster zeroed counters
// that each call leaves zeroed, so calls on one stream may share them
template <int NB, bool W4>
int launch_mlp(const int8_t* xq, const float* a, const int8_t* w1, const float* s1,
               const float* b1, const int8_t* w2, const float* s2, const float* b2,
               float* parts, unsigned* arrived, float* out, int nb, int D, int FH, int hb,
               cudaStream_t st) {
  const int R = W4 ? D / 2 : D, w = hb / kCluster;
  // rows per fc chunk: the largest multiple of 4 that divides R, at most a
  // TMA box's 256
  int rc = (R < 256 ? R : 256) / 4 * 4;
  while (R % rc) rc -= 4;
  const MlpSmem L(nb, D, w, W4);
  if (R / rc > kMaxChunks || L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int allowed[kMaxDevices] = {};  // bytes, per instantiation
  CUtensorMap map;
  const int e = launch_setup(reinterpret_cast<const void*>(mlp_kernel<NB, W4>), allowed,
                             L.total, w1, FH, R, w, rc, &map);
  if (e != 0) return e;
  mlp_kernel<NB, W4><<<FH / hb * kCluster, mlp_threads(NB), L.total, st>>>(
      map, xq, a, s1, b1, w2, s2, b2, parts, arrived, out, nb, D, FH, hb, rc);
  return (int)cudaGetLastError();
}

template <bool W4>
int gemv_entry(const void* xq, const void* a, const void* w, const void* s,
               const void* bias, void* y, int nb, int D, int F, int tile, int rb,
               int pass_boxes, void* stream) {
  // F: the weight's row stride, a multiple of 16 bytes for the copy engine
  if (nb < 1 || nb > kMaxRows || F < 16 || F % 16 || (W4 && D % 2))
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch(static_cast<const int8_t*>(xq), static_cast<const float*>(a),
                  static_cast<const int8_t*>(w), static_cast<const float*>(s),
                  static_cast<const float*>(bias), static_cast<float*>(y), nb, D, F, tile, rb,
                  pass_boxes, reinterpret_cast<cudaStream_t>(stream));
  };
  return nb <= 4 ? args(launch_gemv<4, W4>) : args(launch_gemv<kMaxRows, W4>);
}

template <bool W4>
int mlp_entry(const void* xq, const void* a, const void* w1, const void* s1,
              const void* b1, const void* w2, const void* s2, const void* b2,
              void* parts, void* arrived, void* out, int nb, int D, int FH, int hb,
              void* stream) {
  // a block's hidden slice: a multiple of 16 bytes wide and at most a TMA
  // box's 256; D/8 outputs per block, a multiple of 4 (16-byte copies)
  if (nb < 1 || nb > kMaxRows || hb <= 0 || FH % hb || FH % 16 || hb % (16 * kCluster) ||
      hb / kCluster > 256 || D % 32)
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto launch) {
    return launch(static_cast<const int8_t*>(xq), static_cast<const float*>(a),
                  static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
                  static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
                  static_cast<const float*>(s2), static_cast<const float*>(b2),
                  static_cast<float*>(parts), static_cast<unsigned*>(arrived),
                  static_cast<float*>(out), nb, D, FH, hb, reinterpret_cast<cudaStream_t>(stream));
  };
  return nb <= 4 ? args(launch_mlp<4, W4>) : args(launch_mlp<kMaxRows, W4>);
}

}  // namespace

// w: (D, F) int8; tile, rb, pass_boxes: the launch plan (ops/gemv.py
// `gemv_plan`)
EXPORT int gemv_w8(const void* xq, const void* a, const void* w, const void* s,
                   const void* bias, void* y, int nb, int D, int F, int tile, int rb,
                   int pass_boxes, void* stream) {
  return gemv_entry<false>(xq, a, w, s, bias, y, nb, D, F, tile, rb, pass_boxes, stream);
}

// w: (D/2, F) packed bytes
EXPORT int gemv_w4(const void* xq, const void* a, const void* w, const void* s,
                   const void* bias, void* y, int nb, int D, int F, int tile, int rb,
                   int pass_boxes, void* stream) {
  return gemv_entry<true>(xq, a, w, s, bias, y, nb, D, F, tile, rb, pass_boxes, stream);
}

// decode rows one K6/K8 launch takes at width D with hidden groups of hb
// columns: kMaxRows, or fewer where a block's shared memory holds fewer; 0
// where not even one row fits
EXPORT int mlp_max_rows(int D, int hb, int w4) {
  int nb = kMaxRows;
  while (nb > 0 && MlpSmem(nb, D, hb / kCluster, w4 != 0).total > kMaxSmem) --nb;
  return nb;
}

// parts: (FH/hb - 1, nb, D) f32 scratch; arrived: 8 zeroed uint32 counters
EXPORT int mlp_w8(const void* xq, const void* a, const void* w1, const void* s1,
                  const void* b1, const void* w2, const void* s2, const void* b2,
                  void* parts, void* arrived, void* out, int nb, int D, int FH, int hb,
                  void* stream) {
  return mlp_entry<false>(xq, a, w1, s1, b1, w2, s2, b2, parts, arrived, out, nb, D, FH, hb,
                          stream);
}

// w1: (D/2, FH) packed by rows; w2: (FH, D/2) packed by columns
EXPORT int mlp_w4(const void* xq, const void* a, const void* w1, const void* s1,
                  const void* b1, const void* w2, const void* s2, const void* b2,
                  void* parts, void* arrived, void* out, int nb, int D, int FH, int hb,
                  void* stream) {
  return mlp_entry<true>(xq, a, w1, s1, b1, w2, s2, b2, parts, arrived, out, nb, D, FH, hb,
                         stream);
}
