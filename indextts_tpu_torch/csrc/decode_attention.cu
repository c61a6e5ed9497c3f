// K1 / K4: ragged single-token decode attention with a masked hole, one
// launch a call.
//
// Replaces the JAX package's Pallas kernels in indextts_tpu/ops/
// decode_attention.py (rows 1-5 of the kernel table): K1, over a float32
// or bfloat16 cache, `_kernel` / `ragged_decode_attention` (no hole),
// `_kernel_t` / `ragged_decode_attention_t` (transposed cache + hole, the
// one GPT2Attention calls with attn_impl="pallas_ragged") and
// `_kernel_blocked` / `ragged_decode_attention_blocked`; K4, over an int8
// cache with per-(head, token) f32 scales (models/gpt2.py `quantize_kv`),
// `_kernel_blocked_q8` / `ragged_decode_attention_blocked_q8` and
// `_kernel_grid_q8`. Those layouts exist for Mosaic's lane tiles and the
// TPU's DMA; here the cache keeps its natural (B, H, cap, Dh) layout, the
// scales (B, H, cap), and one template covers all five.
//
// out[b,h] = softmax_t(q.k_t * Dh^-1/2) . v_t over keys t < valid[b] outside
// [hole_start[b], hole_end[b]), in fp32; Dh is 64. K4 folds the scales in
// as the TPU kernel does, s = (q.k8) * ksc[t] * Dh^-1/2 and
// acc += (p * vsc[t]) * v8: nothing is dequantized in memory. A row with no
// attending key returns zeros.
//
// Bound on the H100: bytes. A call reads each valid K and V row once and
// does 4 FLOPs a byte (fp32; 16 on int8), far below the card's ridge: at
// B=1, H=20 that is 3.9 MB (fp32, 383 keys) to 17 MB (1657 keys), one to
// five microseconds at 3.35 TB/s. So the call is a chain of latencies
// unless the whole range is in flight at once and the launch is paid once.
// The design:
//
// - One launch: a cluster of 8 blocks (ranks) per (b, h), grid (8, H, B).
//   Rank r takes the r-th eighth of [0, min(valid, cap)), a whole number of
//   16-key chunks, computed here from valid (device data): the grid
//   follows the shape, the work follows valid_len, and the host never
//   syncs (ops/decode_attention.py `rank_span` is the same split).
// - A rank's K rows, and its V rows, are each one contiguous run of the
//   cache. Lanes of two warps ask the copy engine for all of it at once,
//   as 1-D bulk copies of up to 128 keys (`cp.async.bulk`, an mbarrier
//   each), up to `rk` keys a round (ops/decode_attention.py `round_keys`:
//   208 fp32 keys, 256 bf16 or int8; a rank's whole share up to cap 1664
//   or 2048). A longer share goes in rounds, with an online softmax across
//   them. K4's scales come by plain loads, a key a thread, issued with the
//   copies.
// - Thread t takes the score of key t of the round once its copy has
//   landed: 16 reads of 4 dims from its K row against q in shared memory,
//   each lane starting at another 4-dim slot so that a warp's reads fall
//   in distinct banks (rows 64-256 B apart would put one dim of every row
//   in one bank). Then one max a round, one exp a key (in base 2), and P.V
//   with 16 lanes a V row (4 dims each), 16 rows at a time, the 16 rows'
//   partials added in shared memory in a fixed order.
// - Each rank sends its (m, l, acc[64]) into rank 0's shared memory by
//   asynchronous stores (`st.async`) that complete their bytes on a
//   barrier of rank 0, after a cluster arrive made at the start; the other
//   ranks are then done, and rank 0 adds the 8 in rank order. No global
//   scratch and no atomics: a call and a CUDA-graph replay give the same
//   bits.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kDh = 64;
constexpr int kCluster = 8;                 // ranks per (b, h)
constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                  // a rank's share is whole chunks of keys
constexpr int kCopy = 128;                  // keys a bulk copy (and its barrier)
constexpr int kMaxRound = kThreads;         // keys a round: one score a thread
constexpr int kMaxCopies = kMaxRound / kCopy;
constexpr int kRows = kThreads / 16;        // V rows P.V takes at a time, 16 lanes each
constexpr int kAcc = 4;                     // a rank's partial: m, l, 2 unused, acc[64]
constexpr int kPart = kAcc + kDh;
// dynamic shared memory a block may take so that two fit an SM's 228 KB,
// each with its 1 KB reserved and at most 4 KB static
constexpr int kMaxSmem = 233472 / 2 - 1024 - 4096;

static_assert(kCopy % kChunk == 0 && kMaxRound % kCopy == 0, "copies of whole chunks");

// The dynamic shared memory of a block (byte offsets) for rounds of rk
// keys of row_bytes each: the K rows, the V rows, the probabilities (K4:
// times vsc) and the P.V partials, kRows x 64 floats
struct Smem {
  int v, p, red, total;
  __host__ __device__ Smem(int rk, int row_bytes) {
    v = rk * row_bytes;
    p = 2 * rk * row_bytes;
    red = p + rk * 4;
    total = red + kRows * kDh * 4;
  }
};

// keys [start, end) of [0, min(valid, cap)) that rank `rank` takes
__device__ __forceinline__ void rank_span(int valid, int cap, int rank, int& start, int& end) {
  const int n = max(0, min(valid, cap));
  const int per = (n + kChunk * kCluster - 1) / (kChunk * kCluster) * kChunk;
  start = min(rank * per, n);
  end = min(start + per, n);
}

template <typename T>
__device__ __forceinline__ void copy_keys(T* dst, const T* src, int keys, uint64_t* bar) {
  const int bytes = keys * kDh * (int)sizeof(T);
  mbar_expect_tx(bar, bytes);
  bulk_load(dst, src, bytes, bar);
}

// the address of p's counterpart in the shared memory of cluster rank `rank`
__device__ __forceinline__ uint32_t rank_addr(const void* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(addr) : "r"(smem_addr(p)), "r"(rank));
  return addr;
}

// stores x at `addr` in another rank's shared memory and completes its 4
// bytes on that rank's barrier `bar` (both from rank_addr), without waiting
__device__ __forceinline__ void store_remote(uint32_t addr, float x, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::
                   "r"(addr), "f"(x), "r"(bar)
               : "memory");
}

// waits for the first phase of a barrier that other ranks arrive on, with
// acquire at cluster scope; traps after ~2^34 cycles as mbar_wait does
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

template <typename T, bool kQ8>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ valid,
              const int* __restrict__ hole_s, const int* __restrict__ hole_e,
              float* __restrict__ out, int H, int cap, int rk, float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kRowBytes = kDh * (int)sizeof(T);
  // the 4-dim slot thread t starts at: distinct banks across a warp's
  // reads of 16 (fp32), 8 (bf16) or 4 (int8) bytes from rows kRowBytes
  // apart (one dim of every row would otherwise fall in one bank)
  constexpr int kRot = kRowBytes >= 128 ? 1 : 128 / kRowBytes;

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(rk, kRowBytes);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  float* red = reinterpret_cast<float*>(smem + L.red);
  __shared__ float4 qs[kDh / 4];
  __shared__ float recv[kCluster * kPart];  // rank 0: every rank's partial
  __shared__ float wmax[kWarps], wsum[kWarps];
  __shared__ uint64_t kbar[kMaxCopies], vbar[kMaxCopies], landed;

  // 1. The loads that depend on nothing go out first. The block's barrier
  //    for the ranks' partials is made visible to the cluster, and the
  //    block says it has started: the others send into rank 0's shared
  //    memory once they have seen every arrival. Then the block takes its
  //    share and asks for round 0 (lane j of warp 0 K copy j, of warp 1 V
  //    copy j) and, under K4, thread t loads the scales of its key.
  const size_t bh = (size_t)b * H + h;
  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < kDh / 4) qv = load4(q + bh * kDh + tid * 4);
  const int vl = valid[b], hs = hole_s[b], he = hole_e[b];
  if (tid == 0) {
    mbar_init(&landed, 1);
    if (rank == 0) mbar_expect_tx(&landed, kCluster * (kDh + 2) * 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  int start, end;
  rank_span(vl, cap, rank, start, end);
  const int rounds = (end - start + rk - 1) / rk;
  const T* kb = k + bh * cap * kDh;
  const T* vb = v + bh * cap * kDh;
  const bool k_lane = tid < kMaxCopies, v_lane = tid >= 32 && tid < 32 + kMaxCopies;
  const int j = k_lane ? tid : tid - 32;  // the copy a copy lane asks for
  // the copy lane's copy of the round that starts at key t0
  auto request = [&](int t0) {
    const int n = min(rk, end - t0) - j * kCopy;
    if (n > 0)
      copy_keys((k_lane ? ks : vs) + j * kCopy * kDh,
                (k_lane ? kb : vb) + (size_t)(t0 + j * kCopy) * kDh, min(kCopy, n),
                k_lane ? &kbar[j] : &vbar[j]);
  };
  if (k_lane || v_lane) {
    mbar_init(k_lane ? &kbar[j] : &vbar[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    request(start);
  }
  float kscale = 1.f, vscale = 1.f;  // K4: the scales of the thread's key
  if (kQ8 && tid < min(rk, end - start)) {
    kscale = ksc[bh * cap + start + tid];
    vscale = vsc[bh * cap + start + tid];
  }
  if (tid < kDh / 4) qs[tid] = qv;
  __syncthreads();

  // the softmax runs in base 2: s = q.k * Dh^-1/2 * log2(e), p = 2^(s - m)
  const float scale2 = scale * 1.4426950408889634f;
  float m_run = -INFINITY, l_run = 0.f, acc_run = 0.f;  // acc_run: dim tid (tid < 64)
  const int row = tid / 16, c4 = (tid & 15) * 4;         // P.V: V row and dims of a thread
  for (int r = 0; r < rounds; ++r) {
    const int r0 = start + r * rk, nr = min(rk, end - r0), parity = r & 1;
    // 2. scores: thread t takes key r0 + t, in four partial sums
    float s = -INFINITY;
    if (tid < nr) {
      const int key = r0 + tid;
      if (kQ8 && r > 0) {
        kscale = ksc[bh * cap + key];
        vscale = vsc[bh * cap + key];
      }
      mbar_wait(&kbar[tid / kCopy], parity);
      const T* kr = ks + tid * kDh;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < kDh / 4; ++c) {
        const int slot = (c + tid / kRot) & (kDh / 4 - 1);
        const float4 kv = load4(kr + slot * 4), qc = qs[slot];
        d[c & 3] = fmaf(qc.x, kv.x, d[c & 3]);
        d[c & 3] = fmaf(qc.y, kv.y, d[c & 3]);
        d[c & 3] = fmaf(qc.z, kv.z, d[c & 3]);
        d[c & 3] = fmaf(qc.w, kv.w, d[c & 3]);
      }
      float dot = (d[0] + d[1]) + (d[2] + d[3]);
      if (kQ8) dot *= kscale;
      if (key < hs || key >= he) s = dot * scale2;
    }
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) wmax[warp] = mx;
    __syncthreads();
    // 3. one max a round, one exp a key
    float M = m_run;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wmax[w]);
    const float e = s == -INFINITY ? 0.f : exp2f(s - M);
    if (tid < nr) ps[tid] = kQ8 ? e * vscale : e;
    float sum = e;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) wsum[warp] = sum;
    const float alpha = M == -INFINITY ? 1.f : exp2f(m_run - M);
    __syncthreads();
    float lr = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lr += wsum[w];
    l_run = l_run * alpha + lr;
    m_run = M;
    // 4. P.V once the V rows have landed: 16 lanes a row, rows row, row +
    //    16, ...; the 16 rows' partials added in row order
    for (int c = 0; c * kCopy < nr; ++c) mbar_wait(&vbar[c], parity);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = row; t < nr; t += kRows) {
      const float p = ps[t];
      const float4 vv = load4(vs + t * kDh + c4);
      a.x = fmaf(p, vv.x, a.x);
      a.y = fmaf(p, vv.y, a.y);
      a.z = fmaf(p, vv.z, a.z);
      a.w = fmaf(p, vv.w, a.w);
    }
    *reinterpret_cast<float4*>(&red[row * kDh + c4]) = a;
    __syncthreads();
    if (tid < kDh) {
      float pv = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv += red[i * kDh + tid];
      acc_run = acc_run * alpha + pv;
    }
    // the rows are read: the next round's may come in
    if (r + 1 < rounds) {
      __syncthreads();
      if (k_lane || v_lane) request(r0 + rk);
    }
  }

  // 5. Once every block has started, each rank's (m, l, acc) goes into
  //    rank 0's shared memory by asynchronous stores that complete their
  //    bytes on rank 0's barrier; the other ranks are then done. Rank 0
  //    waits for the 8 x 66 values and adds the ranks' partials in rank
  //    order. A rank with no attending key sends (-inf, 0, 0).
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid < kDh) {
    const uint32_t to = rank_addr(recv + rank * kPart, 0), bar = rank_addr(&landed, 0);
    store_remote(to + (kAcc + tid) * 4, acc_run, bar);
    if (tid == 0) {
      store_remote(to, m_run, bar);
      store_remote(to + 4, l_run, bar);
    }
  }
  if (rank == 0 && tid < kDh) {
    mbar_wait_cluster(&landed);
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < kCluster; ++i) M = fmaxf(M, recv[i * kPart]);
    float Lsum = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int i = 0; i < kCluster; ++i) {
        const float f = exp2f(recv[i * kPart] - M);
        Lsum += recv[i * kPart + 1] * f;
        A += recv[i * kPart + kAcc + tid] * f;
      }
    }
    out[bh * kDh + tid] = A / fmaxf(Lsum, 1e-30f);
  }
}

// rk: keys a round, a multiple of 16 up to 256 (ops/decode_attention.py
// `round_keys`)
template <typename T, bool kQ8>
int launch(const void* q, const void* k, const void* v, const void* ksc, const void* vsc,
           const void* valid, const void* hole_s, const void* hole_e, void* out, int B, int H,
           int cap, int rk, float scale, void* stream) {
  const int smem = Smem(rk, kDh * (int)sizeof(T)).total;
  if (B < 1 || H < 1 || cap < 1 || rk < kChunk || rk % kChunk || rk > kMaxRound ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static int allowed[kMaxDevices] = {};
  const int e = allow_smem(reinterpret_cast<const void*>(decode_kernel<T, kQ8>), allowed, smem);
  if (e != 0) return e;
  decode_kernel<T, kQ8><<<dim3(kCluster, H, B), kThreads, smem,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<const int*>(valid), static_cast<const int*>(hole_s),
      static_cast<const int*>(hole_e), static_cast<float*>(out), H, cap, rk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, 64) f32; k, v (B, H, cap, 64) f32 or bf16; valid, hole_s,
// hole_e (B,) int32; out (B, H, 64) f32. q, k, v 16-byte aligned.
EXPORT int ragged_decode_attention(const void* q, const void* k, const void* v,
                                   const void* valid, const void* hole_s,
                                   const void* hole_e, void* out, int B, int H, int cap,
                                   int rk, int bf16, float scale, void* stream) {
  if (bf16)
    return launch<__nv_bfloat16, false>(q, k, v, nullptr, nullptr, valid, hole_s, hole_e, out,
                                         B, H, cap, rk, scale, stream);
  return launch<float, false>(q, k, v, nullptr, nullptr, valid, hole_s, hole_e, out, B, H, cap,
                              rk, scale, stream);
}

// k8, v8 (B, H, cap, 64) int8; ksc, vsc (B, H, cap) f32
EXPORT int ragged_decode_attention_q8(const void* q, const void* k8, const void* v8,
                                      const void* ksc, const void* vsc, const void* valid,
                                      const void* hole_s, const void* hole_e, void* out,
                                      int B, int H, int cap, int rk, float scale,
                                      void* stream) {
  return launch<int8_t, true>(q, k8, v8, ksc, vsc, valid, hole_s, hole_e, out, B, H, cap, rk,
                              scale, stream);
}
