// K3: DiT full-sequence attention with a key-padding mask.
//
// Replaces the Pallas flash kernel the JAX package calls from
// indextts_tpu/models/s2mel.py `DiTAttention._flash` (JAX's library
// jax.experimental.pallas.ops.tpu.flash_attention). Semantics follow the
// package's XLA path beside it: non-causal, scores q.k * Dh^-1/2, masked keys
// get NEG_INF = -1e9, softmax over all T keys in fp32, so every query row
// (pad queries included) attends to the valid keys and stays finite, and a
// row with no valid key averages v over all T keys.
//
// q, k, v: (B, H, T, 64) float32 and out (B, H, T, 64), each read or written
// through its strides (`Layout`: unit stride on the last axis, the others
// multiples of 4 floats, 16-byte aligned bases); key_mask: (B, T) bytes
// through its strides.
//
// Bound on the H100: operations. 4*T*T*Dh FLOPs per (b, h) against 16*T*Dh
// bytes; at T ~ 800 that is ~200 FLOPs per byte. Outside the tensor cores
// float32 runs at 67 TFLOP/s; the tensor cores run TF32 (11 significant
// bits) at 495. This kernel keeps float32 accuracy on the tensor cores with
// 3xTF32: x = hi + lo, both TF32, and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// (the dropped lo.lo term is ~2^-22 of the product), three products per
// product, so its floor is 3 x FLOPs over 495 TFLOP/s. The helpers (split,
// mma, mma3, ex2) are common.cuh's, shared with K9 and K10.
//
// Design (FlashAttention-2 on mma.sync.m16n8k8 TF32): a block of 8 warps
// owns 128 query rows of one (b, h); each warp owns 16 rows, whose Q
// fragments it scales by Dh^-1/2 log2(e), splits once and keeps in
// registers, so that the scores come out in base 2 for ex2. 64-key K and V
// tiles stream through a 2-stage ring of 16-byte cp.async copies, the next
// tile in flight while one is computed; each thread splits the chunks it copied into TF32
// high and low parts in shared memory (the high over the copy), so a tile
// is split once for all 8 warps, and one barrier a tile publishes it. The
// head dims are contracted, and the output columns held, in a permuted order
// in which a lane's operands are whole 16-byte chunks, and shared rows are
// padded to 68 floats, which keeps those reads free of bank conflicts. Per
// tile a warp computes S = Q.K^T (8 key groups x 8 steps of 8 dims), the
// online softmax on the accumulator fragment (a lane holds rows g and g+8,
// keys 2t and 2t+1 of each group of 8; the row max is two quad shuffles),
// and O += P.V with P taken straight from S's registers: the accumulator
// holds keys (2t, 2t+1) where the A operand wants k-indices (t, t+4), so
// k-index t reads V's row 2t and k-index t+4 row 2t+1 (the sum over keys
// does not care about their order). Tile overhang past T scores -inf (not a
// key), a masked key -1e9: both mean the same in base 2.
//
// Row statistics (`stats`, a training forward): with a non-null pointer the
// float32 kernel also writes each query row's log-sum-exp in base 2, the
// counterpart of the library forward's `save_residuals` (its l and m), as
// two floats: m, the row's largest base-2 score, and log2 l, where l is the
// sum of 2^(s - m) over the row's keys. The backward (dit_attention_bwd.cu)
// recomputes p = 2^((s - m) - log2 l). One float m + log2 l would not do:
// in a row with no valid key m = -1e9, whose float32 step (64) swallows
// log2 l, and that row's p = 1/T would come back as 1. A null pointer
// launches the instantiation without the store (`kStats` false), the
// serving path's kernel as it was.
//
// The bfloat16 instantiation (`dit_attention_bf16`: a bfloat16 DiT,
// runtime.s2mel_dtype; the same TPU kernel replaced) reads q, k and v in
// bfloat16 through the same strides (multiples of 8 elements, 16-byte
// aligned bases) and writes a bfloat16 output in the same layout. Scores
// q.k * Dh^-1/2 in float32, taken into base 2, masked as above, the online
// softmax in float32, P rounded to bfloat16 as the A operand of P.V with
// float32 accumulation, O divided by the float32 row sum and rounded once.
//
// Bound on the H100: operations, 4*T*n*Dh FLOPs per (b, h) over 989
// TFLOP/s bf16, n the valid keys (0.0029 ms at the main path). At Dh = 64
// the exponentials cost as much: the SFU's 16 ex2 a clock an SM against
// the tensor cores' 4096 FLOPs is 256 FLOPs an ex2, the 4 Dh of a score,
// so the kernel can approach its bound only with the softmax of one tile
// overlapped with another's products.
//
// Design (a FlashAttention-3-style forward on wgmma, for Hopper):
// - Warp roles: a block of kC + 1 warpgroups owns 64 kC query rows of one
//   (b, h). Warpgroups 0..kC-1 are consumers, 64 rows each; warpgroup kC
//   is the producer, one thread of which issues every TMA load. Q's rows
//   come once; 128-key K and V tiles stream through a ring of 4 stages,
//   each with a full barrier for K, one for V (TMA's transaction bytes) and
//   an empty barrier that each consumer warp arrives on when its products
//   have read the stage. The tensor maps are 4-D over (d, t, h, b) with the
//   views' real strides (the DiT's strided q, k, v are not copied), boxes
//   of 64 dims x 128 key rows (64 kC query rows) in the 128-byte swizzle (a
//   row of 64 bfloat16 is one 128-byte swizzle row); rows past T come in
//   as zeros. They are encoded on the host (`cuTensorMapEncodeTiled`
//   through the runtime's entry-point query; a null lookup is an error, no
//   fallback) and passed as __grid_constant__ parameters, so a captured
//   graph replays them.
// - Products: S = Q.K^T is wgmma m64n128k16 from shared memory (Q and K
//   K-major, as stored), 4 steps of 16 head dims; O += P.V is wgmma
//   m64n64k16 with P in registers (the S accumulator's layout is the A
//   fragment's, so P is rounded to bfloat16 where it lies) and V read
//   MN-major from its tile through the transpose bit, 8 steps of 16 keys.
//   No transposed copies, no ldmatrix.
// - Overlap, between warpgroups: a consumer issues S, waits for it, runs
//   the tile's softmax, issues P.V and waits for it; while it runs its
//   softmax, the other consumers' products keep the tensor cores busy. At
//   Dh = 64 a tile's softmax (64 scores a thread: 64 ex2 on the SFU, whose
//   16 a clock an SM make them as long as the two products at the tensor
//   cores' full rate, and ~4 ALU operations a score besides) outlasts a
//   warpgroup's two products, so more consumers hide more of it. Measured
//   on an H100 in turns, three free-running consumers beat
//   FlashAttention-3's intra-warpgroup pipelining with two consumers in
//   ping-pong at the longest segment and at 16 rows; with three, that
//   pipelining spills. The softmax is instantiated for a tile of valid
//   keys only (no masking, the scale folded into the exponent's FMA) and
//   for a mixed tile, chosen before the products are issued, so no branch
//   comes between a wgmma and its wait (the compiler would otherwise wait
//   for every product at the branch).
// - Masks: the block reads its batch row's (T,) mask bytes once, all
//   warps, into shared memory as bits (4 words a tile) and classes each
//   tile: no valid key, all valid, or mixed. Where the batch row has a
//   valid key, both roles walk only the tiles holding one: a skipped tile
//   would add 2^(-1e9 - m) = 0 to l and O, and where it came first its
//   l and O would be scaled by 2^(-1e9 - m) = 0 once a valid key arrived,
//   so skipping changes no bit in any order. A row with no valid key
//   skips nothing (it averages v over all T keys). An all-valid tile skips
//   the masking arithmetic. The test reads the mask bits, not a length.
// - Blocks: a grid of 2-consumer blocks that fits in one wave of the SMs is
//   latency-bound and runs as such (kC = 2: more SMs, fewer rows each);
//   a larger grid runs 3 consumers a block (kC = 3), which share each K
//   and V tile among 192 rows.
// - Budget: kC = 2: 384 threads at 168 registers (__launch_bounds__(384,
//   1)), the producer gives back to 40 and the consumers take 232
//   (setmaxnreg); kC = 3: 512 threads at 128, the producer 32, the
//   consumers 160. A consumer thread holds O (32 floats), a 64 x 128 S tile
//   (64 floats) and P (32 registers of two bfloat16).
//   `dit_attention_bf16_attributes` reports the registers at launch and
//   the local (spill) bytes of both, which chip_smoke.py requires to be 0.
//   Shared memory: Q (16 or 24 KB) + 4 stages x (16 + 16) KB + 104 B of
//   barriers + 17 B a key tile of mask words and class, and 1 KB to align
//   the swizzled tiles to 1024 bytes: 157,184 B (kC = 3) at T=2946; one
//   block an SM.
// - Waves on 132 SMs: the main path (B=2, H=8, T=898) kC = 2, 8 x 8 x 2 =
//   128 blocks, 0.97 of a wave; the longest segment (T=2946) kC = 3, 16 x
//   8 x 2 = 256 blocks, 1.94 waves; the batched solve's 16 rows (T=898)
//   kC = 3, 5 x 8 x 16 = 640 blocks, 4.85 waves.
// - Determinism: no atomics; each output element is summed in one fixed
//   order, so a second call, and contiguous copies of strided views, give
//   the same bits.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kD = 64;                 // head width
constexpr int kWarps = 8;              // query warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;       // query rows per block, 16 a warp
constexpr int kBN = 64;                // keys per tile
constexpr int kStages = 2;             // tiles in the ring
constexpr int kPitch = kD + 4;         // floats per shared row
constexpr int kTile = kBN * kPitch;    // floats per K or V tile
// a stage: K's high parts (first its copy), K's low parts, the same for V
constexpr int kSmemBytes = kStages * 4 * kTile * (int)sizeof(float);
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// element strides, in floats (q, k, v, out: b, h, t) and bytes (mask: b, t)
struct Layout {
  long long q[3], k[3], v[3], o[3], m[2];
};

template <bool kStats>
__global__ void __launch_bounds__(kThreads, 1)
dit_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
                float* __restrict__ out, float* __restrict__ stats, const Layout L, int T,
                float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float* kb = k + b * L.k[0] + h * L.k[1];
  const float* vb = v + b * L.v[0] + h * L.v[1];
  const uint8_t* mb = key_mask + b * L.m[0];
  const int n_tiles = (T + kBN - 1) / kBN;

  // key tile j into its stage: thread tid copies 16-byte column c of rows
  // tid/16 + i*kThreads/16 of K and V; keys past T are zero-filled. One
  // group a call, empty past the last tile, so that the waits count alike.
  const int c_copy = 4 * (tid % 16);
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      float* ks = sm + (j % kStages) * 4 * kTile;
      float* vs = ks + 2 * kTile;
#pragma unroll
      for (int r = tid / 16; r < kBN; r += kThreads / 16) {
        const int key = j * kBN + r;
        const long long kr = key < T ? key : 0;
        cp_async16(smem_addr(ks + r * kPitch + c_copy), kb + kr * L.k[2] + c_copy, key < T);
        cp_async16(smem_addr(vs + r * kPitch + c_copy), vb + kr * L.v[2] + c_copy, key < T);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_tile(j);
  // the chunks this thread copied into stage st, split in place: the high
  // parts over the copy, the low parts a tile further on
  auto split_tile = [&](int st) {
    float* ks = sm + st * 4 * kTile;
#pragma unroll
    for (int r = tid / 16; r < kBN; r += kThreads / 16) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float4* hp = reinterpret_cast<float4*>(ks + 2 * m * kTile + r * kPitch + c_copy);
        const float4 x = *hp;
        uint4 hi, lo;
        split(x.x, hi.x, lo.x);
        split(x.y, hi.y, lo.y);
        split(x.z, hi.z, lo.z);
        split(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(hp) = hi;
        *reinterpret_cast<uint4*>(hp + kTile / 4) = lo;
      }
    }
  };

  // this warp's 16 query rows; a warp past T only helps load
  const int row0 = blockIdx.x * kBM + warp * 16;
  const bool active = row0 < T;
  const int r0 = row0 + g, r1 = row0 + g + 8;
  // The 64 dims are contracted in 8 steps of 8 in a permuted order, so
  // that each lane's operands are whole 16-byte chunks: in steps 2jj and
  // 2jj+1 lane t covers the 4 dims of chunk c = 2t + (jj & 1) + 8(jj >> 1),
  // k-index t dims 4c and 4c+2, k-index t+4 dims 4c+1 and 4c+3.
  // A fragments of Q, step s: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
  unsigned qh[8][4], ql[8][4];
  {
    scale *= kLog2e;
    const float* qb = q + b * L.q[0] + h * L.q[1];
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = 4 * (2 * t + (jj & 1) + 8 * (jj >> 1));
      const float4 x0 = r0 < T ? load4(qb + r0 * L.q[2] + c) : zero;
      const float4 x1 = r1 < T ? load4(qb + r1 * L.q[2] + c) : zero;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int st = 2 * jj + hh;
        split(elem(x0, 2 * hh) * scale, qh[st][0], ql[st][0]);
        split(elem(x1, 2 * hh) * scale, qh[st][1], ql[st][1]);
        split(elem(x0, 2 * hh + 1) * scale, qh[st][2], ql[st][2]);
        split(elem(x1, 2 * hh + 1) * scale, qh[st][3], ql[st][3]);
      }
    }
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // this thread's copies of tile j have landed: it splits them; after the
    // barrier the whole tile is split, and every warp is done with tile
    // j - 1, whose stage the next copy refills
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    split_tile(j % kStages);
    __syncthreads();
    load_tile(j + kStages - 1);
    if (!active) continue;
    const float* ks = sm + (j % kStages) * 4 * kTile;
    const float* vs = ks + 2 * kTile;
    const int key0 = j * kBN, n_keys = T - key0;  // keys of the tile that exist
    const bool mk_lo = lane < n_keys && mb[(key0 + lane) * L.m[1]] != 0;
    const bool mk_hi = lane + 32 < n_keys && mb[(key0 + lane + 32) * L.m[1]] != 0;

    // S = Q.K^T: lane (g, t) reads chunk c of K's row 8n+g for key group n,
    // high and low parts: b0, b1 of step 2jj from its first two floats, of
    // 2jj+1 from the others
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = 4 * (2 * t + (jj & 1) + 8 * (jj >> 1));
      uint4 kh[8], kl[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        kh[n] = *reinterpret_cast<const uint4*>(ks + (8 * n + g) * kPitch + c);
        kl[n] = *reinterpret_cast<const uint4*>(ks + kTile + (8 * n + g) * kPitch + c);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        unsigned bh[8][2], bl[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          bh[n][0] = elem(kh[n], 2 * hh);
          bh[n][1] = elem(kh[n], 2 * hh + 1);
          bl[n][0] = elem(kl[n], 2 * hh);
          bl[n][1] = elem(kl[n], 2 * hh + 1);
        }
        mma3(s, qh[2 * jj + hh], ql[2 * jj + hh], bh, bl);
      }
    }

    // mask, then the online softmax; element e of group n is row g (e < 2)
    // or g+8, key 8n + 2t + (e & 1). A tile of valid keys only skips the mask.
    const unsigned w_lo = __ballot_sync(0xffffffffu, mk_lo);
    const unsigned w_hi = __ballot_sync(0xffffffffu, mk_hi);
    if (n_keys < kBN || (w_lo & w_hi) != 0xffffffffu) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          const bool valid = ((n < 4 ? w_lo : w_hi) >> (c & 31)) & 1u;
          s[n][e] = c >= n_keys ? -INFINITY : valid ? s[n][e] : kNegInf;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[n][e] - (e < 2 ? m0 : m1));
        s[n][e] = p;
        if (e < 2) l0 += p;
        else l1 += p;
      }
    }

    // O += P.V over key group kg: A (c0, c2, c1, c3) of S's group kg, at
    // k-indices t -> key 2t and t+4 -> key 2t+1. The output columns are
    // permuted too: column col of output group n is dim 4col + n (n < 4) or
    // 32 + 4col + n - 4, so lane g's B operands for all 8 groups are two
    // 16-byte chunks of each of V's rows 8kg+2t and 8kg+2t+1.
#pragma unroll
    for (int kg = 0; kg < 8; ++kg) {
      unsigned ah[4], al[4];
      split(s[kg][0], ah[0], al[0]);
      split(s[kg][2], ah[1], al[1]);
      split(s[kg][1], ah[2], al[2]);
      split(s[kg][3], ah[3], al[3]);
      const uint4* vr = reinterpret_cast<const uint4*>(vs + (8 * kg + 2 * t) * kPitch + 4 * g);
      constexpr int kRow = kPitch / 4, kLo = kTile / 4;  // in 16-byte chunks
      const uint4 vh[4] = {vr[0], vr[8], vr[kRow], vr[kRow + 8]};
      const uint4 vl[4] = {vr[kLo], vr[kLo + 8], vr[kLo + kRow], vr[kLo + kRow + 8]};
      unsigned bh[8][2], bl[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        bh[n][0] = elem(vh[n / 4], n % 4);
        bh[n][1] = elem(vh[2 + n / 4], n % 4);
        bl[n][0] = elem(vl[n / 4], n % 4);
        bl[n][1] = elem(vl[2 + n / 4], n % 4);
      }
      mma3(o, ah, al, bh, bl);
    }
  }
  if (!active) return;

  // a row's sum is spread over its quad
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  if (kStats && t == 0) {  // (B, H, T, 2) contiguous: m, log2 l
    float2* sb = reinterpret_cast<float2*>(stats) + (long long)(b * gridDim.y + h) * T;
    if (r0 < T) sb[r0] = make_float2(m0, log2f(l0));
    if (r1 < T) sb[r1] = make_float2(m1, log2f(l1));
  }
  // row g's columns 2t and 2t+1 of groups 0-3 are dims 8t..8t+7, of groups
  // 4-7 dims 32+8t..32+8t+7
  float* ob = out + b * L.o[0] + h * L.o[1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = 32 * half + 8 * t, n = 4 * half;
    if (r0 < T) {
      float* p = ob + r0 * L.o[2] + c;
      *reinterpret_cast<float4*>(p) = make_float4(o[n][0] * i0, o[n + 1][0] * i0,
                                                  o[n + 2][0] * i0, o[n + 3][0] * i0);
      *reinterpret_cast<float4*>(p + 4) = make_float4(o[n][1] * i0, o[n + 1][1] * i0,
                                                      o[n + 2][1] * i0, o[n + 3][1] * i0);
    }
    if (r1 < T) {
      float* p = ob + r1 * L.o[2] + c;
      *reinterpret_cast<float4*>(p) = make_float4(o[n][2] * i1, o[n + 1][2] * i1,
                                                  o[n + 2][2] * i1, o[n + 3][2] * i1);
      *reinterpret_cast<float4*>(p + 4) = make_float4(o[n][3] * i1, o[n + 1][3] * i1,
                                                      o[n + 2][3] * i1, o[n + 3][3] * i1);
    }
  }
}


// ---- the bfloat16 instantiation ----------------------------------------

constexpr int kBN16 = 128;                 // keys a tile
constexpr int kStages16 = 4;               // K and V tiles in the ring
constexpr int kRowBytes = kD * 2;          // a row of 64 bfloat16: one 128-byte swizzle row
constexpr int kTileBytes = kBN16 * kRowBytes;
constexpr int kWords = kBN16 / 32;         // mask words a tile
constexpr int kMaxSmem16 = 232448;         // a block's shared memory on sm_90
// a key tile's class, from the mask bits
constexpr uint8_t kNoValid = 0, kMixed = 1, kAllValid = 2;

// The block of kC consumer warpgroups (64 query rows each) and one
// producer warpgroup. Shared memory from a 1024-byte aligned base: Q, the
// ring (a stage: K then V), the barriers (full_q, full_k[], full_v[],
// empty[]), then each tile's mask words and its class. Registers a thread
// after setmaxnreg: the block starts at 65536 / threads a thread (rounded
// down to 8: __launch_bounds__(threads, 1)); the producer gives back down
// to `producer_regs` and the consumers take up to `consumer_regs`.
template <int kC>
struct Block16 {
  static constexpr int threads = 128 * (kC + 1);
  static constexpr int warps = threads / 32;
  static constexpr int rows = 64 * kC;
  static constexpr int q_bytes = rows * kRowBytes;
  static constexpr int ring_off = q_bytes;
  static constexpr int bar_off = ring_off + kStages16 * 2 * kTileBytes;
  static constexpr int mask_off = bar_off + 8 * (1 + 3 * kStages16);
  static constexpr int producer_regs = kC == 3 ? 32 : 40;
  static constexpr int consumer_regs = kC == 3 ? 160 : 232;
  static_assert(128 * (producer_regs + kC * consumer_regs) <= 65536 / threads / 8 * 8 * threads,
                "setmaxnreg asks for more registers than the block holds");
  // dynamic shared memory of a launch over n_tiles key tiles (1024 bytes
  // of slack to align the base)
  static constexpr int smem(int n_tiles) { return 1024 + mask_off + n_tiles * (4 * kWords + 1); }
};

// two bfloat16 (lo: the smaller column) in one register, rounded to nearest even
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// wgmma's descriptor of a tile in shared memory as TMA's 128-byte swizzle
// lays it out: 128-byte rows, 8-row groups of 1024 bytes (the stride byte
// offset, 64 x 16 B), the leading byte offset unused at these widths (1),
// layout type 1 (128-byte swizzle). The tile bases are 1024-byte aligned,
// so the base offset is 0, and a step along a row adds its bytes to the
// start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until this warp's committed products have completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the registers' values as of here: code after the fence reads them after
// the preceding wgmma_wait, not before
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)

// d (= or +=) a.b over 64 query rows x 128 keys x 16 head dims; a (Q) and
// b (K) both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += a.b over 64 query rows x 64 head dims x 16 keys; a (P) in registers
// as the accumulator's layout leaves it, b (V) MN-major in shared memory
// (the transpose bit)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef F16
#undef F4

// S = Q.K^T over the 64 head dims: 4 steps of 16, 32 bytes on along the rows
__device__ __forceinline__ void qk_tile(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_qk(s, sw128_desc(q_addr + 32 * kk), sw128_desc(k_addr + 32 * kk), kk);
}

// O += P.V over the tile's 128 keys: 8 steps of 16 keys, 2048 bytes apart
__device__ __forceinline__ void pv_tile(float (&o)[32], const unsigned (&p)[32], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             sw128_desc(v_addr + 2048 * kk));
}

// The scores of one tile into base 2 and masked, then the online softmax:
// s becomes P (float32), m and l (rows g and g + 8) are updated, and al is
// the factor that scales the O accumulated so far. Element 4i + e of s is
// row g (e < 2) or g + 8, key 8i + 2t + (e & 1) of the tile; `words` the
// tile's 4 mask words. A tile of valid keys only (kAll) skips the mask. The
// maxima and sums run 4 apart a row, which keeps their chains short.
template <bool kAll>
__device__ __forceinline__ void softmax_tile(float (&s)[64], const uint32_t* words, int n_keys,
                                             int t, float scale, float (&m)[2], float (&l)[2],
                                             float (&al)[2]) {
  constexpr bool fold = kAll;  // the scale folded into the exponent's FMA
  if (!kAll) {
    unsigned w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = words[i] >> (2 * t);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * i + 2 * t + (e & 1);
        const bool valid = (w[i / 4] >> (8 * (i % 4) + (e & 1))) & 1u;
        s[4 * i + e] = valid ? s[4 * i + e] * scale : key < n_keys ? kNegInf : -INFINITY;
      }
    }
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) mx[r][k] = -INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = mx[e / 2][2 * (i % 2) + (e & 1)];
      x = fmaxf(x, s[4 * i + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (fold) x *= scale;  // scale > 0: the largest scaled score is the largest score scaled
    const float mn = fmaxf(m[r], x);
    al[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
  float ls[2][4] = {};
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mr = m[e / 2];
      const float p = ex2(fold ? fmaf(s[4 * i + e], scale, -mr) : s[4 * i + e] - mr);
      s[4 * i + e] = p;
      ls[e / 2][2 * (i % 2) + (e & 1)] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + ((ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]));
}

template <int kC>
__global__ void __launch_bounds__(Block16<kC>::threads, 1)
dit_attn_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const uint8_t* __restrict__ key_mask, __nv_bfloat16* __restrict__ out,
                     const Layout L, int T, float scale) {
  extern __shared__ uint8_t smem16_raw[];
  uint8_t* sm = smem16_raw + ((1024 - (smem_addr(smem16_raw) & 1023)) & 1023);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + Block16<kC>::bar_off);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages16;
  uint64_t* empty = full_v + kStages16;
  const int n_tiles = (T + kBN16 - 1) / kBN16;
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + Block16<kC>::mask_off);
  uint8_t* cls = reinterpret_cast<uint8_t*>(words + kWords * n_tiles);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_blk = blockIdx.x * Block16<kC>::rows;
  // consumer warpgroups with a row below T
  const int n_active = min(kC, (T - row_blk + 63) / 64);

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages16; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty[st], 4 * n_active);  // each warp of the active consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the producer's thread asks for Q at once, which lands while the mask is read
  if (tid == 128 * kC) {
    mbar_expect_tx(full_q, Block16<kC>::q_bytes);
    tma_load_4d(sm, &qmap, 0, row_blk, h, b, full_q);
  }

  // The batch row's mask bytes, read once by all warps, as bits: warp w
  // takes key tiles w, w + W, ... (W the block's warps), 4 tiles (16 bytes
  // a lane) in flight;
  // word i of tile j holds keys 128j + 32i + lane (0 past T), and the
  // tile's class says whether it has no valid key, only valid keys, or both.
  const uint8_t* mb = key_mask + b * L.m[0];
  bool any = false;
  for (int j0 = warp; j0 < n_tiles; j0 += 4 * Block16<kC>::warps) {
    bool bit[4][kWords];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int key = (j0 + u * Block16<kC>::warps) * kBN16 + 32 * i + lane;
        bit[u][i] = key < T && mb[key * L.m[1]] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * Block16<kC>::warps;
      unsigned all = ~0u, some = 0u;
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const unsigned w = __ballot_sync(0xffffffffu, bit[u][i]);
        all &= w;
        some |= w;
        if (lane == 0 && j < n_tiles) words[kWords * j + i] = w;
      }
      if (lane == 0 && j < n_tiles) cls[j] = all == ~0u ? kAllValid : some ? kMixed : kNoValid;
      any |= some != 0;
    }
  }
  // Tiles without a valid key are skipped where the batch row has one; a
  // row without any skips nothing and masks every tile.
  const bool skip = __syncthreads_or(any);
  // the next tile to walk after tile j, the same in every lane: shuffled
  // from lane 0, so the compiler knows the loops around wgmma for uniform
  auto next_tile = [&](int j) {
    ++j;
    if (skip)
      while (j < n_tiles && cls[j] == kNoValid) ++j;
    return __shfl_sync(0xffffffffu, j, 0);
  };
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);  // this warp's warpgroup

  if (wg == kC) {
    // the producer: one thread keeps the ring's loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Block16<kC>::producer_regs));
    if (tid == 128 * kC) {
      int st = 0;
      unsigned ph = 0;
      for (int j = next_tile(-1); j < n_tiles; j = next_tile(j)) {
        mbar_wait(&empty[st], ph ^ 1);
        uint8_t* ks = sm + Block16<kC>::ring_off + 2 * st * kTileBytes;
        mbar_expect_tx(&full_k[st], kTileBytes);
        tma_load_4d(ks, &kmap, 0, j * kBN16, h, b, &full_k[st]);
        mbar_expect_tx(&full_v[st], kTileBytes);
        tma_load_4d(ks + kTileBytes, &vmap, 0, j * kBN16, h, b, &full_v[st]);
        if (++st == kStages16) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else if (wg < n_active) {
    // a consumer warpgroup: 64 query rows, 16 a warp; lane (g, t) holds
    // rows g and g + 8 of its warp's
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Block16<kC>::consumer_regs));
    const int g = lane / 4, t = lane % 4;
    const int r0 = row_blk + 64 * wg + 16 * (warp % 4) + g, r1 = r0 + 8;
    const uint32_t q_addr = smem_addr(sm) + 64 * wg * kRowBytes;
    const uint32_t ring = smem_addr(sm) + Block16<kC>::ring_off;
    scale *= kLog2e;
    float o[32], s[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];
    unsigned p[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // One tile: S = Q.K^T, its softmax (instantiated for the tile's class,
    // which is known before the products are issued), O rescaled, P
    // rounded to bfloat16 in S's registers, O += P.V, the stage released.
    // A warpgroup waits for its own products; the other two keep the
    // tensor cores busy meanwhile.
    auto tile = [&](auto all, int j, int st, unsigned ph) {
      mbar_wait(&full_k[st], ph);
      wgmma_fence();
      qk_tile(s, q_addr, ring + 2 * st * kTileBytes);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      softmax_tile<decltype(all)::value>(s, words + kWords * j, T - j * kBN16, t, scale, m, l,
                                         al);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o[i] *= al[i % 4 / 2];
        // P as the A operand of P.V: k-step kk takes S's key groups 2kk, 2kk+1
        p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      }
      mbar_wait(&full_v[st], ph);
      wgmma_fence();
      pv_tile(o, p, ring + (2 * st + 1) * kTileBytes);
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      mbar_arrive(&empty[st], lane == 0);
    };
    mbar_wait(full_q, 0);
    int st = 0;
    unsigned ph = 0;
    for (int j = next_tile(-1); j < n_tiles; j = next_tile(j)) {
      if (__shfl_sync(0xffffffffu, skip ? (int)cls[j] : (int)kMixed, 0) == kAllValid)
        tile(std::true_type{}, j, st, ph);
      else
        tile(std::false_type{}, j, st, ph);
      if (++st == kStages16) {
        st = 0;
        ph ^= 1;
      }
    }

    float l0 = l[0], l1 = l[1];
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    // row g (and g + 8), dims 8i + 2t and 8i + 2t + 1 of dim group i
    __nv_bfloat16* ob = out + b * L.o[0] + h * L.o[1];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (r0 < T)
        *reinterpret_cast<unsigned*>(ob + r0 * L.o[2] + c) =
            pack_bf16(o[4 * i] * i0, o[4 * i + 1] * i0);
      if (r1 < T)
        *reinterpret_cast<unsigned*>(ob + r1 * L.o[2] + c) =
            pack_bf16(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
    }
  }
}

}  // namespace

static Layout layout(const long long* strides) {
  Layout L;
  for (int i = 0; i < 3; ++i) {
    L.q[i] = strides[i];
    L.k[i] = strides[3 + i];
    L.v[i] = strides[6 + i];
    L.o[i] = strides[9 + i];
  }
  L.m[0] = strides[12];
  L.m[1] = strides[13];
  return L;
}

// strides: 14 element strides, those of q, k, v and out over (b, h, t), then
// key_mask's over (b, t); stats: null, or (B, H, T, 2) contiguous float32
// for each row's m and log2 l
EXPORT int dit_attention(const void* q, const void* k, const void* v,
                         const void* key_mask, void* out, void* stats,
                         const long long* strides, int B, int H, int T, float scale,
                         void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const Layout L = layout(strides);
  auto kernel = stats ? dit_attn_kernel<true> : dit_attn_kernel<false>;
  // set on every call: the attribute holds per device, and the call is cheap
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((T + kBM - 1) / kBM, H, B);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<float*>(out), static_cast<float*>(stats), L, T, scale);
  return (int)cudaGetLastError();
}

// The tensor map of a (B, H, T, 64) bfloat16 view: 4-D over (d, t, h, b)
// with the view's strides (element strides st over (b, h, t), multiples of
// 8), boxes of 64 x rows with the 128-byte swizzle; rows past T come in as
// zeros.
static int bf16_map(CUtensorMap* map, const void* base, const long long* st, int B, int H,
                    int T, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, (cuuint32_t)rows, 1, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <int kC>
static int launch_bf16(const void* q, const void* k, const void* v, const void* key_mask,
                       void* out, const Layout& L, int B, int H, int T, float scale,
                       cudaStream_t stream) {
  using Blk = Block16<kC>;
  const int smem = Blk::smem((T + kBN16 - 1) / kBN16);
  if (smem > kMaxSmem16) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  int e = bf16_map(&qmap, q, L.q, B, H, T, Blk::rows);
  if (e == 0) e = bf16_map(&kmap, k, L.k, B, H, T, kBN16);
  if (e == 0) e = bf16_map(&vmap, v, L.v, B, H, T, kBN16);
  static int allowed[kMaxDevices] = {};
  if (e == 0)
    e = allow_smem(reinterpret_cast<const void*>(dit_attn_bf16_kernel<kC>), allowed, smem);
  if (e != 0) return e;
  const dim3 grid((T + Blk::rows - 1) / Blk::rows, H, B);
  dit_attn_bf16_kernel<kC><<<grid, Blk::threads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<const uint8_t*>(key_mask),
      static_cast<__nv_bfloat16*>(out), L, T, scale);
  return (int)cudaGetLastError();
}

// The same over bfloat16 q, k, v and out. A grid of 2-consumer blocks that
// fits in one wave of the card's SMs (the main path's solve) is latency-
// bound and takes 2 consumers a block, which spreads it over more SMs;
// a larger grid takes 3, which share each K and V tile among more rows.
EXPORT int dit_attention_bf16(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, const long long* strides,
                              int B, int H, int T, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const Layout L = layout(strides);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long blocks2 = (long long)((T + Block16<2>::rows - 1) / Block16<2>::rows) * H * B;
  return blocks2 <= sms ? launch_bf16<2>(q, k, v, key_mask, out, L, B, H, T, scale, s)
                        : launch_bf16<3>(q, k, v, key_mask, out, L, B, H, T, scale, s);
}

// The bfloat16 kernel's registers a thread at launch (before setmaxnreg)
// and local (spill) bytes a thread on the current card, for its blocks of
// 2 and of 3 consumers: out[0], out[1]; out[2], out[3].
EXPORT int dit_attention_bf16_attributes(int* out) {
  const void* kernels[2] = {reinterpret_cast<const void*>(dit_attn_bf16_kernel<2>),
                            reinterpret_cast<const void*>(dit_attn_bf16_kernel<3>)};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kernels[i]);
    if (e != cudaSuccess) return (int)e;
    out[2 * i] = a.numRegs;
    out[2 * i + 1] = (int)a.localSizeBytes;
  }
  return 0;
}
