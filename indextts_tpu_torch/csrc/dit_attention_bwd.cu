// K9 and K10: the backward of K3, the DiT's full-sequence attention with a
// key-padding mask, in float32.
//
// Replace the two Pallas kernels of the library's flash attention backward
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// indextts_tpu/models/s2mel.py `DiTAttention._flash` differentiates through
// its custom_vjp when the CFM step trains: K9 is `_flash_attention_bwd_dkv`
// (dK and dV), K10 `_flash_attention_bwd_dq` (dQ). Semantics are those of
// the package's XLA path (s2mel.py `DiTAttention.__call__`) under jax.grad:
// scores s = q.k Dh^-1/2, a masked key's score the constant -1e9 (so it
// sends no gradient to q or k, even in a row with no valid key, whose
// softmax is uniform over all T keys and whose dV is not zero), keys past
// T (tile overhang) no keys at all, pad query rows ordinary rows.
//
// Inputs: q, k, v, dO (B, H, T, 64) float32 read through their strides
// (unit stride on the last axis, the others multiples of 4 floats, 16-byte
// aligned bases); key_mask (B, T) bytes through its strides; stats (B, H,
// T, 2) contiguous, each row's m and log2 l from K3's forward
// (dit_attention.cu), in base 2; delta (B, H, T) contiguous, D = rowsum(dO
// o O), computed outside as the library computes `di` in XLA. Each kernel
// recomputes p = 2^((s - m) - log2 l) with s in base 2, then dP = dO.V^T
// and dS = p (dP - D), zero at masked and absent keys:
//   K9:  dV = P^T.dO, dK = Dh^-1/2 dS^T.Q   (a block owns 64 keys)
//   K10: dQ = Dh^-1/2 dS.K                  (a block owns 64 query rows)
// dQ has its own pass, as in the library, so no sum crosses blocks: each
// output element is summed by one thread in a fixed order, and a second
// call gives the same bits.
//
// Bound on the H100: operations. K9 does 8 T n Dh FLOPs per (b, h) (S, dP,
// dV, dK) and K10 6 T n Dh (S, dP, dQ), n the valid keys, against ~16-24 T
// Dh bytes. Both run K3's arithmetic: 3xTF32 on mma.sync.m16n8k8 (x = hi +
// lo, a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, float32 accumulation; the
// helpers are common.cuh's), so the floor is 3 x FLOPs over 495 TFLOP/s.
//
// Design (FlashAttention-2's backward on the tensor cores). A block of 4
// warps owns 64 rows of one (b, h), 16 a warp: K10 query rows, K9 keys.
// Each warp keeps the raw float32 rows of its two A operands in shared
// memory (K10: Q, scaled by Dh^-1/2 log2(e) as K3 scales it, and dO; K9:
// K and V) and splits the 8 values a lane needs for two k-steps into high
// and low parts just before they are used (once for 4 B fragments x 3
// products); kept split in registers they would take 128 of them, and
// kept raw 64 still left the kernels at 255 registers with spills. The
// other side streams through a 2-stage ring of 32-row tiles of two tensors
// (K10: K and V; K9: Q, scaled into base 2 as K3 scales it, and dO, with
// each query's m, log2 l and D beside them) by 16-byte cp.async, the next
// tile in flight while one is computed; each thread splits the chunks it
// copied in place (high over the copy, low a tile further on), and one
// barrier a tile publishes the split tile to all 4 warps. Per tile a warp
// computes two products over the 64 head dims into 16 x 32 accumulators,
// K3's S = Q.K^T read (lane (g, t) reads 16-byte chunk 2t + (jj & 1) +
// 8(jj >> 1) of the tile's row 8n + g, dims in K3's permuted order):
//   K10: S = Q'.K^T (K3's products in K3's order: K3's bits) and
//        dP = dO.V^T, then dS = p (dP - D) in registers, then dQ += dS.K
//        with dS straight from the accumulator as the A operand (it holds
//        keys (2t, 2t+1) where A wants k-indices (t, t+4): k-index t reads
//        K's row 2t), K3's P.V read of the tile.
//   K9:  S^T = K.Q'^T (K3's products in K3's order) and dP^T = V.dO^T put
//        keys on the M side, so P^T and dS^T come out of the accumulators
//        as the A operands of dV += P^T.dO and dK += dS^T.Q', which
//        contract over the tile's queries and read its rows as K3 reads V.
// Q' and dO (K9), K (K10) are read both ways from one split tile: rows
// padded to 68 floats, a 16-byte read per lane, both patterns free of bank
// conflicts (a quarter warp covers the 32 banks once), as are the reads of
// a warp's own rows; the per-query m, log2 l and D are one float4 and one
// float2 a key group, broadcast. The tensor cores round each accumulation
// toward zero, and dP - D cancels: dP is summed a k-step at a time from
// zero and added in float32, and so is each tile's share of dQ, dK, dV.
//
// Masked key tiles are skipped, exactly. K10: a key tile without a valid
// key sends dQ nothing (dS is 0 at masked and absent keys in every row),
// so every warp finds the next tile holding a valid key with one ballot
// over its 32 mask bytes and the ring loads and computes only those; a
// batch row with no valid key walks none and writes dQ = 0. K9: a warp
// whose 16 keys are all masked, in a batch row with a valid key, has P = 0
// (2^(-1e9 - m) underflows) and dS = 0 on them, so it computes nothing
// and writes dK = dV = 0; a block whose 64 keys are all masked or absent
// there loads nothing. In a batch row with no valid key nothing is skipped
// (dV is 1/T of the sum of dO). The tests read the mask bytes, not a
// length: the mask may be any pattern. Tile overhang past T is zero-filled;
// K9 sets p = 0 at absent queries.
//
// Budget: 128 threads, at most 255 registers a thread (two blocks an SM);
// shared memory 2 stages x 4 x 32 x 68 x 4 B + 4 warps x 2 x 16 x 68 x 4 B
// = 104,448 B (K10), + 768 B of per-query statistics (K9): two blocks fit
// an SM's 228 KB, 8 warps an SM. `dit_attention_bwd_attributes` reports
// each kernel's registers and local (spill) bytes; chip_smoke.py prints
// them and fails on a spill. Waves at the main path (B=2, H=8, T=898):
// 15 x 8 x 2 = 240 blocks of each kernel on 132 SMs x 2 slots, 0.91 of a
// wave (K9: 2 of each (b, h)'s 15 blocks hold no valid key there and
// return); a CFM step's B=8 gives 960, 3.6 waves.
// wgmma would read tf32 operands K-major from shared memory only, so the
// products over queries (K9) and keys (K10) would need transposed tiles:
// later work, with TMA.

#include "common.cuh"

namespace {

constexpr int kD = 64;               // head width
constexpr int kWarps = 4;            // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;     // rows a block owns, 16 a warp
constexpr int kBN = 32;              // rows of the other side a tile
constexpr int kGroups = kBN / 8;     // groups of 8 rows a tile
constexpr int kStages = 2;           // tiles in the ring
constexpr int kPitch = kD + 4;       // floats per shared row
constexpr int kTile = kBN * kPitch;  // floats of one part of one tensor's tile
// a stage: X's high parts (first its copy), X's low parts, the same for Y
constexpr int kStage = 4 * kTile;
// a warp's own 16 rows of its two A operands, raw float32
constexpr int kOwn = 2 * 16 * kPitch;
constexpr int kSmemDq = (kStages * kStage + kWarps * kOwn) * (int)sizeof(float);
// K9 adds each query's (m, log2 l) and D a stage
constexpr int kSmemDkv = kSmemDq + kStages * kBN * (int)(sizeof(float2) + sizeof(float));
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBN == 32, "a key tile's mask is one ballot");

// element strides: q, k, v, dO, then the two outputs (K9: dK, dV; K10: dQ,
// unused), over (b, h, t); key_mask's over (b, t) in bytes
struct Layout {
  long long q[3], k[3], v[3], o[3], g0[3], g1[3], m[2];
};

// kBytes global -> shared through L1, zero-filled when !full
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
               "n"(kBytes), "r"(full ? kBytes : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// rows [r0, r0 + kBN) of x and y into a stage: thread tid copies 16-byte
// chunk tid % 16 of rows tid / 16 + 8i; rows past T are zero-filled
__device__ __forceinline__ void copy_tile(float* stage, const float* x, long long sx,
                                          const float* y, long long sy, int r0, int T) {
  const int c = 4 * (threadIdx.x % 16);
#pragma unroll
  for (int r = threadIdx.x / 16; r < kBN; r += kThreads / 16) {
    const int row = r0 + r;
    const long long rr = row < T ? row : 0;
    cp_async16(smem_addr(stage + r * kPitch + c), x + rr * sx + c, row < T);
    cp_async16(smem_addr(stage + 2 * kTile + r * kPitch + c), y + rr * sy + c, row < T);
  }
}

// the chunks this thread copied into a stage, X's times xs, split in place:
// the high parts over the copy, the low parts a tile further on
__device__ __forceinline__ void split_tile(float* stage, float xs) {
  const int c = 4 * (threadIdx.x % 16);
#pragma unroll
  for (int r = threadIdx.x / 16; r < kBN; r += kThreads / 16) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float4* hp = reinterpret_cast<float4*>(stage + 2 * m * kTile + r * kPitch + c);
      const float s = m ? 1.f : xs;
      const float4 x = *hp;
      uint4 hi, lo;
      split(x.x * s, hi.x, lo.x);
      split(x.y * s, hi.y, lo.y);
      split(x.z * s, hi.z, lo.z);
      split(x.w * s, hi.w, lo.w);
      *reinterpret_cast<uint4*>(hp) = hi;
      *reinterpret_cast<uint4*>(hp + kTile / 4) = lo;
    }
  }
}

// rows [r0, r0 + 16) of x, times `scale`, zeros past T, into a warp's own
// rows (16 x kPitch floats)
__device__ __forceinline__ void own_rows(float* own, const float* x, long long sx, int r0,
                                         int T, float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = lane; i < 16 * 16; i += 32) {
    const int r = i / 16, c = 4 * (i % 16);
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) y = load4(x + (r0 + r) * sx + c);
    *reinterpret_cast<float4*>(own + r * kPitch + c) =
        make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
  }
}

// The tensor cores add each product into the accumulator rounding toward
// zero, so a long sum drifts toward zero; dP - D cancels, and in a row
// with one valid key dK is a sum of such differences alone. dP is summed
// as `kFresh`: each k-step's three products from zero on the tensor
// cores, then added in float32 (to nearest); dot_rows adds each tile's sum
// so. On an H100, with one accumulator for all, dK was off by 2.4e-5 of
// max(1, max|dK|) at T=255 with one valid key (past the 2e-5 the checks
// allow); summed so, by 7.9e-6. S keeps K3's single accumulator and K3's
// order of products, so that p matches K3's statistics.

// acc += A.B^T over the 64 dims: A a warp's own 16 rows, B the tile's kBN
// rows (high parts at `tile`, low parts a tile further on). The dims are
// contracted in K3's permuted order: in steps 2jj and 2jj+1 lane t covers
// the 4 dims of chunk c = 2t + (jj & 1) + 8(jj >> 1), k-index t dims 4c
// and 4c+2, k-index t+4 dims 4c+1 and 4c+3. acc element e of group n is
// row g (e < 2) or g+8, tile row 8n + 2t + (e & 1). kHiLoFirst: the
// products a_hi.b_lo, a_lo.b_hi, a_hi.b_hi, which with A and B swapped
// are K3's a_lo.b_hi, a_hi.b_lo, a_hi.b_hi.
template <bool kHiLoFirst, bool kFresh>
__device__ __forceinline__ void dot_dims(float (&acc)[kGroups][4], const float* own,
                                         const float* tile, int g, int t) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int c = 4 * (2 * t + (jj & 1) + 8 * (jj >> 1));
    const float4 x0 = *reinterpret_cast<const float4*>(own + g * kPitch + c);
    const float4 x1 = *reinterpret_cast<const float4*>(own + (g + 8) * kPitch + c);
    // A fragments of steps 2jj + hh: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      split(elem(x0, 2 * hh), ah[hh][0], al[hh][0]);
      split(elem(x1, 2 * hh), ah[hh][1], al[hh][1]);
      split(elem(x0, 2 * hh + 1), ah[hh][2], al[hh][2]);
      split(elem(x1, 2 * hh + 1), ah[hh][3], al[hh][3]);
    }
    uint4 th[kGroups], tl[kGroups];
#pragma unroll
    for (int n = 0; n < kGroups; ++n) {
      th[n] = *reinterpret_cast<const uint4*>(tile + (8 * n + g) * kPitch + c);
      tl[n] = *reinterpret_cast<const uint4*>(tile + kTile + (8 * n + g) * kPitch + c);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      unsigned bh[kGroups][2], bl[kGroups][2];
#pragma unroll
      for (int n = 0; n < kGroups; ++n) {
        bh[n][0] = elem(th[n], 2 * hh);
        bh[n][1] = elem(th[n], 2 * hh + 1);
        bl[n][0] = elem(tl[n], 2 * hh);
        bl[n][1] = elem(tl[n], 2 * hh + 1);
      }
      float part[kGroups][4] = {};
      float (&d)[kGroups][4] = kFresh ? part : acc;
      if (kHiLoFirst) {
#pragma unroll
        for (int n = 0; n < kGroups; ++n) mma(d[n], ah[hh], bl[n]);
#pragma unroll
        for (int n = 0; n < kGroups; ++n) mma(d[n], al[hh], bh[n]);
#pragma unroll
        for (int n = 0; n < kGroups; ++n) mma(d[n], ah[hh], bh[n]);
      } else {
        mma3(d, ah[hh], al[hh], bh, bl);
      }
      if (kFresh) {
#pragma unroll
        for (int n = 0; n < kGroups; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }
    }
  }
}

// acc += P.X over the tile's kBN rows, summed from zero on the tensor cores
// and added in float32: P in dot_dims' accumulator layout, X the tile (high
// parts at `tile`); as K3's P.V, k-index t of group kg is tile row
// 8kg + 2t and k-index t+4 row 8kg + 2t + 1, and column g of output group
// n is dim 4g + n (n < 4) or 32 + 4g + n - 4, so a lane's B operands are
// two 16-byte chunks of each of two rows
__device__ __forceinline__ void dot_rows(float (&acc)[8][4], const float (&p)[kGroups][4],
                                         const float* tile, int g, int t) {
  float part[8][4] = {};
#pragma unroll
  for (int kg = 0; kg < kGroups; ++kg) {
    unsigned ah[4], al[4];
    split(p[kg][0], ah[0], al[0]);
    split(p[kg][2], ah[1], al[1]);
    split(p[kg][1], ah[2], al[2]);
    split(p[kg][3], ah[3], al[3]);
    const uint4* xr = reinterpret_cast<const uint4*>(tile + (8 * kg + 2 * t) * kPitch + 4 * g);
    constexpr int kRow = kPitch / 4, kLo = kTile / 4;  // in 16-byte chunks
    const uint4 xh[4] = {xr[0], xr[8], xr[kRow], xr[kRow + 8]};
    const uint4 xl[4] = {xr[kLo], xr[kLo + 8], xr[kLo + kRow], xr[kLo + kRow + 8]};
    unsigned bh[8][2], bl[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      bh[n][0] = elem(xh[n / 4], n % 4);
      bh[n][1] = elem(xh[2 + n / 4], n % 4);
      bl[n][0] = elem(xl[n / 4], n % 4);
      bl[n][1] = elem(xl[2 + n / 4], n % 4);
    }
    mma3(part, ah, al, bh, bl);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// rows r0 and r1 of a 16 x 64 accumulator (dot_rows' column order) times
// `scale` into x: row g's columns 2t and 2t+1 of groups 0-3 are dims
// 8t..8t+7, of groups 4-7 dims 32+8t..32+8t+7
__device__ __forceinline__ void store_rows(float* x, long long sx, const float (&o)[8][4],
                                           int r0, int r1, int T, int t, float scale) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = 32 * half + 8 * t, n = 4 * half;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r1 : r0, e = 2 * i;
      if (r >= T) continue;
      float* p = x + r * sx + c;
      *reinterpret_cast<float4*>(p) = make_float4(o[n][e] * scale, o[n + 1][e] * scale,
                                                  o[n + 2][e] * scale, o[n + 3][e] * scale);
      *reinterpret_cast<float4*>(p + 4) =
          make_float4(o[n][e + 1] * scale, o[n + 1][e + 1] * scale, o[n + 2][e + 1] * scale,
                      o[n + 3][e + 1] * scale);
    }
  }
}

// K9: a block owns keys [64 blockIdx.x, +64) of (b, h) = (blockIdx.z,
// blockIdx.y) and walks every query tile
__global__ void __launch_bounds__(kThreads, 2)
dit_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
                        const float* __restrict__ dout, const float2* __restrict__ stats,
                        const float* __restrict__ delta, float* __restrict__ dk,
                        float* __restrict__ dv, const Layout L, int T, float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float* own = sm + kStages * kStage + warp * kOwn;  // K, then V
  float2* st_s = reinterpret_cast<float2*>(sm + kStages * kStage + kWarps * kOwn);
  float* di_s = reinterpret_cast<float*>(st_s + kStages * kBN);
  const long long bh = (long long)b * H + h;
  const uint8_t* mb = key_mask + b * L.m[0];
  const float* qb = q + b * L.q[0] + h * L.q[1];
  const float* ob = dout + b * L.o[0] + h * L.o[1];

  // this warp's keys r0 = 16 warp + g and r1 = r0 + 8 of the block's; a
  // warp with a valid key computes, and in a batch row with no valid key
  // every warp with a key below T; the others write zeros
  const int w0 = blockIdx.x * kBM + warp * 16;
  const int r0 = w0 + g, r1 = r0 + 8;
  const bool v0 = r0 < T && mb[r0 * L.m[1]] != 0, v1 = r1 < T && mb[r1 * L.m[1]] != 0;
  const bool warp_valid = __any_sync(kFull, v0 || v1);
  const bool block_valid = __syncthreads_or(v0 || v1);
  bool row_valid = block_valid;
  if (!block_valid) {
    bool any = false;
    for (int j = tid; j < T; j += kThreads) any |= mb[j * L.m[1]] != 0;
    row_valid = __syncthreads_or(any);
  }
  const bool active = w0 < T && (warp_valid || !row_valid);
  // a block none of whose warps computes loads nothing
  const int n_tiles = block_valid || !row_valid ? (T + kBN - 1) / kBN : 0;

  // query tile j into its stage, with each query's (m, log2 l) and D; one
  // group a call, empty past the last tile, so that the waits count alike
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      const int st = j % kStages, q0 = j * kBN;
      copy_tile(sm + st * kStage, qb, L.q[2], ob, L.o[2], q0, T);
      const int i = q0 + tid % kBN, ic = i < T ? i : 0;
      if (tid < kBN)
        cp_async_ca<8>(smem_addr(st_s + st * kBN + tid), stats + bh * T + ic, i < T);
      else if (tid < 2 * kBN)
        cp_async_ca<4>(smem_addr(di_s + st * kBN + tid - kBN), delta + bh * T + ic, i < T);
    }
    commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_tile(j);
  if (active) {
    own_rows(own, k + b * L.k[0] + h * L.k[1], L.k[2], w0, T, 1.f);
    own_rows(own + 16 * kPitch, v + b * L.v[0] + h * L.v[1], L.v[2], w0, T, 1.f);
  }

  float acc_k[8][4] = {}, acc_v[8][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    // this thread's copies of tile j have landed: it splits them (Q scaled
    // into base 2 as K3 scales it); after the barrier the whole tile is
    // split, and every warp is done with tile j - 1, whose stage the next
    // copy refills
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    const int st = j % kStages;
    float* stage = sm + st * kStage;
    split_tile(stage, scale * kLog2e);
    __syncthreads();
    load_tile(j + kStages - 1);
    if (!active) continue;

    // S^T = K.Q'^T (base 2) and dP^T = V.dO^T: element e of group n is key
    // r0 (e < 2) or r1, query 8n + 2t + (e & 1) of the tile
    float s[kGroups][4] = {}, dp[kGroups][4] = {};
    dot_dims<true, false>(s, own, stage, g, t);
    dot_dims<false, true>(dp, own + 16 * kPitch, stage + 2 * kTile, g, t);
    // P^T and dS^T in place; a masked key scores -1e9, an absent query has p = 0
    const int n_q = T - j * kBN;
    const float4* stq = reinterpret_cast<const float4*>(st_s + st * kBN);
    const float2* diq = reinterpret_cast<const float2*>(di_s + st * kBN);
#pragma unroll
    for (int n = 0; n < kGroups; ++n) {
      const float4 m = stq[4 * n + t];  // queries 8n + 2t and 8n + 2t + 1
      const float2 d = diq[4 * n + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = e < 2 ? v0 : v1;
        const float mq = e & 1 ? m.z : m.x, lq = e & 1 ? m.w : m.y, dq = e & 1 ? d.y : d.x;
        float p = ex2(((valid ? s[n][e] : kNegInf) - mq) - lq);
        if (n_q < kBN && 8 * n + 2 * t + (e & 1) >= n_q) p = 0.f;
        dp[n][e] = valid ? p * (dp[n][e] - dq) : 0.f;
        s[n][e] = p;
      }
    }
    dot_rows(acc_v, s, stage + 2 * kTile, g, t);  // dV += P^T.dO
    dot_rows(acc_k, dp, stage, g, t);             // dK += dS^T.Q'
  }

  // Q' = Q Dh^-1/2 log2(e): dK = Dh^-1/2 dS^T.Q = dS^T.Q' / log2(e)
  store_rows(dk + b * L.g0[0] + h * L.g0[1], L.g0[2], acc_k, r0, r1, T, t, 1.f / kLog2e);
  store_rows(dv + b * L.g1[0] + h * L.g1[1], L.g1[2], acc_v, r0, r1, T, t, 1.f);
}

// K10: a block owns query rows [64 blockIdx.x, +64) of (b, h) and walks
// the key tiles that hold a valid key
__global__ void __launch_bounds__(kThreads, 2)
dit_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
                       const float* __restrict__ dout, const float2* __restrict__ stats,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       const Layout L, int T, float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float* own = sm + kStages * kStage + warp * kOwn;  // Q', then dO
  const long long bh = (long long)b * H + h;
  const uint8_t* mb = key_mask + b * L.m[0];
  const float* kb = k + b * L.k[0] + h * L.k[1];
  const float* vb = v + b * L.v[0] + h * L.v[1];
  const int n_tiles = (T + kBN - 1) / kBN;

  // the valid keys of tile j as bits (lane i: key 32j + i), and the first
  // tile at or after j that holds one (n_tiles if none); every warp finds
  // the same tiles
  auto valid_bits = [&](int j) {
    const int key = j * kBN + lane;
    return __ballot_sync(kFull, key < T && mb[key * L.m[1]] != 0);
  };
  auto next_tile = [&](int j) {
    while (j < n_tiles && !valid_bits(j)) ++j;
    return j;
  };

  // the i-th tile with a valid key into stage i % kStages; one group a
  // call, empty past the last such tile
  int j_load = next_tile(0), i_load = 0;
  auto load_next = [&]() {
    if (j_load < n_tiles) {
      copy_tile(sm + (i_load % kStages) * kStage, kb, L.k[2], vb, L.v[2], j_load * kBN, T);
      j_load = next_tile(j_load + 1);
    }
    ++i_load;
    commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_next();

  // this warp's 16 query rows, Q scaled into base 2 as K3 scales it; a warp
  // past T only helps load
  const int w0 = blockIdx.x * kBM + warp * 16;
  const bool active = w0 < T;
  const int r0 = w0 + g, r1 = r0 + 8;
  float2 st0 = make_float2(0.f, 0.f), st1 = st0;
  float d0 = 0.f, d1 = 0.f;
  if (active) {
    own_rows(own, q + b * L.q[0] + h * L.q[1], L.q[2], w0, T, scale * kLog2e);
    own_rows(own + 16 * kPitch, dout + b * L.o[0] + h * L.o[1], L.o[2], w0, T, 1.f);
    if (r0 < T) {
      st0 = stats[bh * T + r0];
      d0 = delta[bh * T + r0];
    }
    if (r1 < T) {
      st1 = stats[bh * T + r1];
      d1 = delta[bh * T + r1];
    }
  }

  float acc[8][4] = {};
  for (int j = next_tile(0), i = 0; j < n_tiles; j = next_tile(j + 1), ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    float* stage = sm + (i % kStages) * kStage;
    split_tile(stage, 1.f);
    __syncthreads();
    load_next();
    if (!active) continue;
    const unsigned w = valid_bits(j);

    // S = Q'.K^T (base 2, K3's bits) and dP = dO.V^T: element e of group n
    // is row r0 (e < 2) or r1, key 8n + 2t + (e & 1) of the tile
    float s[kGroups][4] = {}, dp[kGroups][4] = {};
    dot_dims<false, false>(s, own, stage, g, t);
    dot_dims<false, true>(dp, own + 16 * kPitch, stage + 2 * kTile, g, t);
    // dS in place, 0 at masked and absent keys
#pragma unroll
    for (int n = 0; n < kGroups; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = (w >> (8 * n + 2 * t + (e & 1))) & 1u;
        const float2 st = e < 2 ? st0 : st1;
        const float di = e < 2 ? d0 : d1;
        s[n][e] = valid ? ex2((s[n][e] - st.x) - st.y) * (dp[n][e] - di) : 0.f;
      }
    }
    dot_rows(acc, s, stage, g, t);  // dQ += dS.K
  }
  if (!active) return;
  store_rows(dq + b * L.g0[0] + h * L.g0[1], L.g0[2], acc, r0, r1, T, t, scale);
}

Layout layout(const long long* strides) {
  Layout L;
  for (int i = 0; i < 3; ++i) {
    L.q[i] = strides[i];
    L.k[i] = strides[3 + i];
    L.v[i] = strides[6 + i];
    L.o[i] = strides[9 + i];
    L.g0[i] = strides[12 + i];
    L.g1[i] = strides[15 + i];
  }
  L.m[0] = strides[18];
  L.m[1] = strides[19];
  return L;
}

int allowed_dkv[kMaxDevices], allowed_dq[kMaxDevices];

}  // namespace

// strides: 20 element strides, those of q, k, v, dout, dk and dv over
// (b, h, t), then key_mask's over (b, t); stats (B, H, T, 2) and delta
// (B, H, T) contiguous float32
EXPORT int dit_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout, const void* stats,
                                 const void* delta, void* dk, void* dv,
                                 const long long* strides, int B, int H, int T, float scale,
                                 void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int e = allow_smem((const void*)dit_attn_bwd_dkv_kernel, allowed_dkv, kSmemDkv);
  if (e) return e;
  const dim3 grid((T + kBM - 1) / kBM, H, B);
  dit_attn_bwd_dkv_kernel<<<grid, kThreads, kSmemDkv, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<const float*>(dout),
      static_cast<const float2*>(stats), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), layout(strides), T, scale);
  return (int)cudaGetLastError();
}

// strides: as above, dq's in the place of dk's (dv's unused)
EXPORT int dit_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* key_mask, const void* dout, const void* stats,
                                const void* delta, void* dq, const long long* strides, int B,
                                int H, int T, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int e = allow_smem((const void*)dit_attn_bwd_dq_kernel, allowed_dq, kSmemDq);
  if (e) return e;
  const dim3 grid((T + kBM - 1) / kBM, H, B);
  dit_attn_bwd_dq_kernel<<<grid, kThreads, kSmemDq, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<const float*>(dout),
      static_cast<const float2*>(stats), static_cast<const float*>(delta),
      static_cast<float*>(dq), layout(strides), T, scale);
  return (int)cudaGetLastError();
}

// out[0], out[1]: K9's registers a thread and local (spill) bytes a
// thread; out[2], out[3]: K10's
EXPORT int dit_attention_bwd_attributes(int* out) {
  const void* kernels[2] = {(const void*)dit_attn_bwd_dkv_kernel,
                            (const void*)dit_attn_bwd_dq_kernel};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kernels[i]);
    if (e != cudaSuccess) return (int)e;
    out[2 * i] = a.numRegs;
    out[2 * i + 1] = (int)a.localSizeBytes;
  }
  return 0;
}
