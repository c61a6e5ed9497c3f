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
// product, so its floor is 3 x FLOPs over 495 TFLOP/s.
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
// runtime.s2mel_dtype) reads q, k and v in bfloat16 through the same
// strides (multiples of 8 elements, 16-byte aligned bases) and writes a
// bfloat16 output in the same layout. Both products run in one pass on the
// bfloat16 tensor cores (mma.sync.m16n8k16, float32 accumulation): bound
// by operations, 4*T*T*Dh FLOPs per (b, h) over 989 TFLOP/s. Its design is
// FlashAttention-2's plain form: a block of 4 warps owns 64 query rows,
// each warp 16, whose Q fragments (unscaled) it keeps in registers; 64-key
// K and V tiles in a 2-stage cp.async ring (rows padded to 72 elements);
// S = Q.K^T from 32-bit reads of K's rows, scaled by Dh^-1/2 log2(e) in
// float32, masked and taken through the online softmax in float32 exactly
// as above; P rounded to bfloat16 straight from S's registers as the A
// operand of O += P.V (the accumulator's keys (2t, 2t+1) of two key groups
// are the A fragment's k-indices of one 16-key step); V's B fragments by
// ldmatrix.trans from its row-major tile. The float32 row sums normalize
// O, which is rounded to bfloat16 once.

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full (the source is not read)
__device__ __forceinline__ void cp_async16(unsigned dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away), lo the exact
// rest, of which the tensor cores read the top 19 bits
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // cvt.rna.tf32.f32 is slower
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x by the hardware's approximation (ex2.approx), 0 at -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a.b over one m16n8k8 TF32 tile
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32 for 8 accumulators sharing a, the small products first
__device__ __forceinline__ void mma3(float (&d)[8][4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&bh)[8][2],
                                     const unsigned (&bl)[8][2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(d[n], ah, bh[n]);
}

__device__ __forceinline__ float elem(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ unsigned elem(const uint4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

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
        cp_async16(smem_u32(ks + r * kPitch + c_copy), kb + kr * L.k[2] + c_copy, key < T);
        cp_async16(smem_u32(vs + r * kPitch + c_copy), vb + kr * L.v[2] + c_copy, key < T);
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

constexpr int kWarps16 = 4;
constexpr int kThreads16 = 32 * kWarps16;
constexpr int kBM16 = 16 * kWarps16;  // query rows per block
constexpr int kPitch16 = kD + 8;      // bfloat16 elements per shared row (144 bytes)
constexpr int kTile16 = kBN * kPitch16;

// d += a.b over one m16n8k16 bfloat16 tile, float32 accumulation
__device__ __forceinline__ void mma16(float (&d)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bfloat16 (lo: the smaller column) in one register, rounded to nearest even
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void cp_async16_bf16(unsigned dst, const __nv_bfloat16* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

__global__ void __launch_bounds__(kThreads16)
dit_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ key_mask,
                     __nv_bfloat16* __restrict__ out, const Layout L, int T, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sm[kStages * 2 * kTile16];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* kb = k + b * L.k[0] + h * L.k[1];
  const __nv_bfloat16* vb = v + b * L.v[0] + h * L.v[1];
  const uint8_t* mb = key_mask + b * L.m[0];
  const int n_tiles = (T + kBN - 1) / kBN;

  // key tile j into its stage: thread tid copies 16-byte chunk tid % 8 of
  // rows tid / 8 + 16 i of K and V; keys past T are zero-filled
  const int c_copy = 8 * (tid % 8);
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      __nv_bfloat16* ks = sm + (j % kStages) * 2 * kTile16;
      __nv_bfloat16* vs = ks + kTile16;
#pragma unroll
      for (int r = tid / 8; r < kBN; r += kThreads16 / 8) {
        const int key = j * kBN + r;
        const long long kr = key < T ? key : 0;
        cp_async16_bf16(smem_u32(ks + r * kPitch16 + c_copy), kb + kr * L.k[2] + c_copy,
                        key < T);
        cp_async16_bf16(smem_u32(vs + r * kPitch16 + c_copy), vb + kr * L.v[2] + c_copy,
                        key < T);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_tile(j);

  // this warp's 16 query rows; a warp past T only helps load. A fragments
  // of Q for the 4 steps of 16 dims: a0 (g, 2t..), a1 (g+8, 2t..),
  // a2 (g, 2t+8..), a3 (g+8, 2t+8..)
  const int row0 = blockIdx.x * kBM16 + warp * 16;
  const bool active = row0 < T;
  const int r0 = row0 + g, r1 = row0 + g + 8;
  unsigned qa[4][4];
  {
    const __nv_bfloat16* qb = q + b * L.q[0] + h * L.q[1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t;
      qa[kk][0] = r0 < T ? *reinterpret_cast<const unsigned*>(qb + r0 * L.q[2] + c) : 0u;
      qa[kk][1] = r1 < T ? *reinterpret_cast<const unsigned*>(qb + r1 * L.q[2] + c) : 0u;
      qa[kk][2] = r0 < T ? *reinterpret_cast<const unsigned*>(qb + r0 * L.q[2] + c + 8) : 0u;
      qa[kk][3] = r1 < T ? *reinterpret_cast<const unsigned*>(qb + r1 * L.q[2] + c + 8) : 0u;
    }
  }
  scale *= kLog2e;

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    load_tile(j + kStages - 1);
    if (!active) continue;
    const __nv_bfloat16* ks = sm + (j % kStages) * 2 * kTile16;
    const __nv_bfloat16* vs = ks + kTile16;
    const int key0 = j * kBN, n_keys = T - key0;
    const bool mk_lo = lane < n_keys && mb[(key0 + lane) * L.m[1]] != 0;
    const bool mk_hi = lane + 32 < n_keys && mb[(key0 + lane + 32) * L.m[1]] != 0;

    // S = Q.K^T: key group n (8 keys), B operand from row 8n+g of K
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (8 * n + g) * kPitch16 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma16(s[n], qa[kk], *reinterpret_cast<const unsigned*>(kr + 16 * kk),
              *reinterpret_cast<const unsigned*>(kr + 16 * kk + 8));
    }

    // scale into base 2, mask, online softmax (as the float32 kernel)
    const unsigned w_lo = __ballot_sync(0xffffffffu, mk_lo);
    const unsigned w_hi = __ballot_sync(0xffffffffu, mk_hi);
    const bool all_valid = n_keys >= kBN && (w_lo & w_hi) == 0xffffffffu;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const bool valid = ((n < 4 ? w_lo : w_hi) >> (c & 31)) & 1u;
        const float x = s[n][e] * scale;
        s[n][e] = all_valid ? x : c >= n_keys ? -INFINITY : valid ? x : kNegInf;
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

    // O += P.V, 16 keys a step: A from key groups 2kk and 2kk+1 of S; the
    // B fragments of dim groups n and n+1 from one ldmatrix.x4.trans, lane
    // l naming row (l & 7) of matrix l / 8: keys 16kk + 8((l / 8) & 1) on,
    // dims 8(n + l / 16) on
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = 16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        const unsigned addr = smem_u32(vs + key * kPitch16 + 8 * (n + (lane >> 4)));
        unsigned b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(addr));
        mma16(o[n], pa, b0, b1);
        mma16(o[n + 1], pa, b2, b3);
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  // row g (and g+8), dims 8n + 2t and 8n + 2t + 1 of dim group n
  __nv_bfloat16* ob = out + b * L.o[0] + h * L.o[1];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < T)
      *reinterpret_cast<unsigned*>(ob + r0 * L.o[2] + c) = pack_bf16(o[n][0] * i0, o[n][1] * i0);
    if (r1 < T)
      *reinterpret_cast<unsigned*>(ob + r1 * L.o[2] + c) = pack_bf16(o[n][2] * i1, o[n][3] * i1);
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

// The same over bfloat16 q, k, v and out.
EXPORT int dit_attention_bf16(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, const long long* strides,
                              int B, int H, int T, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const Layout L = layout(strides);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((T + kBM16 - 1) / kBM16, H, B);
  dit_attn_bf16_kernel<<<grid, kThreads16, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<__nv_bfloat16*>(out), L, T, scale);
  return (int)cudaGetLastError();
}
