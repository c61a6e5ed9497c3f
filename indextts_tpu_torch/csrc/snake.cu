// K2: fused anti-aliased SnakeBeta (BigVGAN's Activation1d).
//
// Replaces the JAX package's Pallas kernels in indextts_tpu/ops/
// snake_pallas.py: `_kernel` / `anti_alias_snake_pallas` (channels on
// lanes) and `_kernel_t` / `anti_alias_snake_pallas_t` (time on lanes). The
// two layouts exist for the TPU's lane width; here one kernel takes x as
// (B, C, T), the layout torch's Conv1d gives.
//
// Per channel row: edge-pad -> 2x kaiser-sinc upsample as two 6-tap
// polyphase FIRs with gain 2 -> SnakeBeta u + sin^2(alpha u) / (beta + 1e-9)
// (alpha, beta exp'd when logscale) -> edge clamp of the up signal at the
// global ends (up[m<0] := up[0], up[m>2T-1] := up[2T-1]) -> 12-tap stride-2
// low-pass. Same polyphase algebra as indextts_tpu/ops/snake.py
// `anti_alias_snake_sliced`. "Pair g" below is the up signal's two samples
// 2g (even phase, from x[g-3..g+2]) and 2g+1 (odd, from x[g-2..g+3]);
// output t reads the even phase of pairs t-2..t+3 and the odd of t-3..t+2.
//
// Two kernels, one for each dtype of x and the output.
//
// float32 (`anti_alias_snake`). Bound on the H100: bytes. The function
// reads x once and writes the output once: 8 bytes against ~58 FLOPs and
// two sines an output. The design keeps the 2x-rate signal in registers
// and the instruction stream short enough to stay near the byte time:
// - A warp owns a chunk of 32 * R consecutive outputs of one row, lane l
//   the R from l * R, in registers; one chunk a warp, R = 12 (ops/snake.py
//   `snake_plan` plans the grid; the launcher checks the plan). x comes in
//   16-byte loads where T % 4 == 0, else in scalar loads (kVec).
// - A lane computes the pair of each of its R positions once, with its two
//   sines. The +-3 inputs and +-3 pairs it needs beyond its own come from
//   the neighbouring lanes by __shfl_sync. The 6 pairs beyond the warp's
//   ends are computed in one more step by lanes 0-2 and 29-31, whose x
//   also hold lane 0's and lane 31's input halo: no shared memory is used.
// - The taps are a kernel parameter (the constant bank), the up FIR's gain
//   of 2 folded into them (ops/snake.py `kernel_taps`).
// - Only a chunk that reaches within 6 inputs of a row's end takes the
//   path with the edge padding, the edge clamp and the bounded stores,
//   under a warp-uniform branch; every other chunk runs branch-free.
// - The sine is reduced by pi and taken by a polynomial on the FMA pipe
//   (`sin_pm`): its sign does not matter to sin^2.
// Chosen on the card (PERF.md): R = 12, a launch bound of 8 blocks an SM.
//
// bfloat16 (`anti_alias_snake_bf16`, K2-bf16: the JAX package's bfloat16
// vocoder; x and the output bfloat16, alpha and beta read as stored,
// bfloat16 or float32). Its bytes (4 an output) take 3.756 ms over a
// batched vocoder call (8 rows, PERF.md), but the float32 design run on
// bfloat16 issued ~70 instructions a lane per output, ~7.5 ms of issue:
// the instruction stream bound it, not the bytes. This kernel moves both
// FIRs onto the tensor cores (mma.sync m16n8k16, bfloat16 operands,
// float32 sums), which leaves 28 instructions a lane per output in a group
// of 8 steps (SASS, tools/snake_times.py --probe); with the loads and
// stores cut out its time is about the bytes' (PERF.md), the mma.sync
// products and the FMA pipe's work adding up rather than overlapping:
// - 16 rows (B * C flattened) on M, time on N and K: the up FIR is a 16 x
//   16 window of x (exact in bfloat16, by ldmatrix) times banded Toeplitz
//   matrices of the even and odd taps, each split hi + lo in bfloat16 (4
//   mma for 8 pairs); the down FIR takes the snaked pair blocks' C
//   fragments as A fragments (as FlashAttention-2's P.V), split u = hi +
//   lo, against the banded down taps left and right of an 8-output block
//   (hi.hi, lo.hi, hi.lo: 6 mma). Error below ~2^-15 relative before the
//   output's one rounding to bfloat16, to nearest even.
// - The snake on the C fragments by sin^2 v = (1 - cos 2v) / 2, the cosine
//   on the SFU (`__cosf`): ~5 issue slots a sample.
// - x arrives in 64 x 16 TMA boxes (the 128-byte swizzle) into a ring of 4
//   a warp on mbarriers, the warp's lane 0 its own producer; outputs leave
//   by TMA stores from two swizzled boxes a warp. Where TMA cannot describe
//   x (T % 8 != 0) the same kernel reads and writes global memory directly.
// - Replicate padding and the up signal's edge clamp act on the fragments,
//   on a row's first and last blocks only, under warp-uniform branches.
// - Warps are persistent over (row tile, time segment) items, so the ring
//   runs on from one item into the next; ops/snake.py `snake_bf16_plan`
//   picks the segment length L for the card's SMs.
//
// tools/snake_times.py --probe rebuilds edited copies of this file and
// counts each kernel's instructions per output.

#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block: ops/snake.py SNAKE_WARPS
constexpr int kR = 12;  // outputs a lane: ops/snake.py SNAKE_LANE_OUTPUTS
constexpr int kThreads = 32 * kWarps;
// 8 blocks an SM cap a thread at 64 registers (72 without; the interior
// path alone needs 48, the edge path the rest) for 32 resident warps
constexpr int kMinBlocks = 8;
constexpr unsigned kAll = 0xffffffffu;

// even and odd: the up FIR's polyphase taps times its gain of 2; down: the
// 12-tap low-pass
struct Taps {
  float even[6], odd[6], down[12];
};

// +-sin(v), enough for sin^2: v = j pi + r with j the nearest integer to
// v / pi, so |r| <= pi / 2 and sin(v) = (-1)^j sin(r). r comes from a
// two-constant Cody-Waite reduction (pi as a float, then the float of the
// rest), sin(r) from an odd minimax polynomial of degree 9 (approximation
// error 4.6e-9 on [-pi/2, pi/2]): ten instructions on the FMA pipe, within
// about 1.3e-7 of sin(v) up to |v| = 30. j is rounded by adding and taking
// away 1.5 * 2^23, which FRND would run on the quarter-rate pipe. j is
// exact below |v| = 2^22; past that the reduction loses accuracy (sinf's
// slow path is left out). The main path's |v| stays below 14
// (chip_smoke.py prints it).
__device__ __forceinline__ float sin_pm(float v) {
  constexpr float kShift = 12582912.f;  // 1.5 * 2^23
  const float j = fmaf(v, 0.318309873f, kShift) - kShift;
  float r = fmaf(j, -3.14159274f, v);
  r = fmaf(j, 8.74227766e-8f, r);
  const float r2 = r * r;
  float p = fmaf(2.6000548e-6f, r2, -1.9806615e-4f);
  p = fmaf(p, r2, 8.333017e-3f);
  p = fmaf(p, r2, -0.16666657f);
  return fmaf(r2 * r, p, r);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// four consecutive outputs: one 16-byte store
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float snake(float u, float a, float inv) {
  const float s = sin_pm(u * a);  // its sign cancels in inv * s * s
  return u + inv * s * s;
}

// pair g from xw[m] = x[g - 3 + m], m = 0..6; the products and sums in the
// plain version's order
__device__ __forceinline__ void pair(const Taps& tp, const float* xw, float a, float inv,
                                     float& pe, float& po) {
  float e = tp.even[0] * xw[0];
  float o = tp.odd[0] * xw[1];
#pragma unroll
  for (int m = 1; m < 6; ++m) {
    e = e + tp.even[m] * xw[m];
    o = o + tp.odd[m] * xw[1 + m];
  }
  pe = snake(e, a, inv);
  po = snake(o, a, inv);
}

// The pair a lane computes beyond its own: lanes 0, 1, 2 the pairs t0-1,
// t0-2, t0-3 left of the warp; lanes 31, 30, 29 the pairs t1, t1+1, t1+2
// right of it (t1 = t0 + 32 R); on the edge path lane 3 the pair 0 and lane
// 28 the pair T-1, whose samples up[0] and up[2T-1] the edge clamp repeats.
// Other lanes: none (kNone).
constexpr int kNone = -(1 << 30);

__device__ __forceinline__ int extra_pair(int lane, int t0, int T, int R, bool edge) {
  if (lane < 3) return t0 - 1 - lane;
  if (lane > 28) return t0 + 32 * R + 31 - lane;
  if (edge && lane == 3) return 0;
  if (edge && lane == 28) return T - 1;
  return kNone;
}

// One warp's chunk [t0, t0 + 32 R) of row xr -> yr. kEdge: the chunk
// reaches within 6 of a row's end (index clamps, the up signal's edge
// clamp, stores bounded by T).
template <int R, bool kVec, bool kEdge, typename E>
__device__ __forceinline__ void chunk(const E* __restrict__ xr, E* __restrict__ yr,
                                      const Taps& tp, float a, float inv, int T, int t0,
                                      int lane) {
  const int tl = t0 + lane * R;

  // xv[k] = x[tl - 3 + k]: the lane's own R, then the halos
  float xv[R + 6];
  if constexpr (kEdge) {
#pragma unroll
    for (int i = 0; i < R; ++i) xv[3 + i] = ld(xr + min(tl + i, T - 1));
  } else if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 v = load4(xr + tl + 4 * i);
      xv[3 + 4 * i] = v.x;
      xv[4 + 4 * i] = v.y;
      xv[5 + 4 * i] = v.z;
      xv[6 + 4 * i] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) xv[3 + i] = ld(xr + tl + i);
  }

  const int ge = extra_pair(lane, t0, T, R, kEdge);
  const bool extra = ge != kNone;
  float xe[7] = {}, ee = 0.f, eo = 0.f;
  if (extra) {
#pragma unroll
    for (int m = 0; m < 7; ++m) xe[m] = ld(xr + (kEdge ? min(max(ge - 3 + m, 0), T - 1) : ge - 3 + m));
    pair(tp, xe, a, inv, ee, eo);
  }

  // input halo: x[tl-3..tl-1] from lane - 1 (lane 0: its pair t0-1 read
  // x[t0-4..t0+2]), x[tl+R..tl+R+2] from lane + 1 (lane 31: its pair t1
  // read x[t1-3..t1+3])
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float l = __shfl_up_sync(kAll, xv[R + k], 1);
    const float r = __shfl_down_sync(kAll, xv[3 + k], 1);
    xv[k] = lane == 0 ? xe[1 + k] : l;
    xv[R + 3 + k] = lane == 31 ? xe[3 + k] : r;
  }

  // pe[k], po[k]: pair tl - 3 + k
  float pe[R + 6], po[R + 6];
#pragma unroll
  for (int i = 0; i < R; ++i) pair(tp, xv + i, a, inv, pe[3 + i], po[3 + i]);

  if constexpr (kEdge) {
    // up[m < 0] := up[0], up[m > 2T-1] := up[2T-1]
    const float up0 = __shfl_sync(kAll, ee, 3);
    const float upT = __shfl_sync(kAll, eo, 28);
    if (extra && ge < 0) ee = eo = up0;
    if (ge > T - 1) ee = eo = upT;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (tl + i > T - 1) pe[3 + i] = po[3 + i] = upT;
  }

  // pair halo: pairs tl-1, tl-2, tl-3 from lane - 1 (lane 0: lanes 0, 1,
  // 2), pairs tl+R, tl+R+1, tl+R+2 from lane + 1 (lane 31: lanes 31, 30,
  // 29); only the phases the down FIR reads
  {
    const float le1 = __shfl_up_sync(kAll, pe[R + 2], 1);
    const float lo1 = __shfl_up_sync(kAll, po[R + 2], 1);
    const float le2 = __shfl_up_sync(kAll, pe[R + 1], 1);
    const float lo2 = __shfl_up_sync(kAll, po[R + 1], 1);
    const float lo3 = __shfl_up_sync(kAll, po[R], 1);
    const float we2 = __shfl_sync(kAll, ee, 1);
    const float wo2 = __shfl_sync(kAll, eo, 1);
    const float wo3 = __shfl_sync(kAll, eo, 2);
    const float re0 = __shfl_down_sync(kAll, pe[3], 1);
    const float ro0 = __shfl_down_sync(kAll, po[3], 1);
    const float re1 = __shfl_down_sync(kAll, pe[4], 1);
    const float ro1 = __shfl_down_sync(kAll, po[4], 1);
    const float re2 = __shfl_down_sync(kAll, pe[5], 1);
    const float ve1 = __shfl_sync(kAll, ee, 30);
    const float vo1 = __shfl_sync(kAll, eo, 30);
    const float ve2 = __shfl_sync(kAll, ee, 29);
    const bool first = lane == 0, last = lane == 31;
    pe[2] = first ? ee : le1;
    po[2] = first ? eo : lo1;
    pe[1] = first ? we2 : le2;
    po[1] = first ? wo2 : lo2;
    po[0] = first ? wo3 : lo3;
    pe[R + 3] = last ? ee : re0;
    po[R + 3] = last ? eo : ro0;
    pe[R + 4] = last ? ve1 : re1;
    po[R + 4] = last ? vo1 : ro1;
    pe[R + 5] = last ? ve2 : re2;
  }

  // out[t] = sum_j down[j] up[2t + j - 5]: odd phase of pair t - 3 + j/2
  // for even j, even phase of pair t - 2 + (j-1)/2 for odd j
  float y[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float acc = tp.down[0] * po[i];
#pragma unroll
    for (int j = 1; j < 12; ++j)
      acc = acc + tp.down[j] * ((j & 1) ? pe[i + (j + 1) / 2] : po[i + j / 2]);
    y[i] = acc;
  }

  if constexpr (kEdge) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (tl + i < T) st(yr + tl + i, y[i]);
  } else if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
      store4(yr + tl + 4 * i, y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) st(yr + tl + i, y[i]);
  }
}

// Warp w takes chunk w % chunks of row w / chunks (row = b * C + c).
template <bool kVec, typename E, typename P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
snake_kernel(const E* __restrict__ x, const P* __restrict__ alpha,
             const P* __restrict__ beta, const Taps tp, E* __restrict__ out, int C,
             int T, int chunks, int warps, int logscale) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= warps) return;
  const int lane = threadIdx.x & 31;
  const int row = w / chunks;
  const int t0 = (w - row * chunks) * (32 * kR);
  const int c = row % C;
  float a = ld(alpha + c), bt = ld(beta + c);
  if (logscale) {
    a = expf(a);
    bt = expf(bt);
  }
  const float inv = 1.f / (bt + 1e-9f);
  const E* xr = x + (size_t)row * T;
  E* yr = out + (size_t)row * T;
  if (t0 >= 6 && t0 + 32 * kR + 6 <= T)
    chunk<kR, kVec, false>(xr, yr, tp, a, inv, T, t0, lane);
  else
    chunk<kR, false, true>(xr, yr, tp, a, inv, T, t0, lane);
}

// The launch of element type E, alpha and beta of type P; a plan that
// does not fit the shape or the pointers returns cudaErrorInvalidValue
// without a launch.
template <typename E, typename P>
int launch(const void* x, const void* alpha, const void* beta, const float* taps, void* out,
           int B, int C, int T, int logscale, int R, int chunks, int blocks, int vec,
           void* stream) {
  const long long warps = (long long)B * C * chunks;
  // vector loads and stores of 4 elements: 16 bytes of float32
  const uintptr_t align = 4 * sizeof(E);
  const bool aligned = T % 4 == 0 && reinterpret_cast<uintptr_t>(x) % align == 0 &&
                       reinterpret_cast<uintptr_t>(out) % align == 0;
  if (B < 1 || C < 1 || T < 1 || R != kR || chunks != (T + 32 * kR - 1) / (32 * kR) ||
      warps > 0x7fffffffll || blocks != (warps + kWarps - 1) / kWarps || (vec && !aligned))
    return (int)cudaErrorInvalidValue;
  Taps tp;
  memcpy(&tp, taps, sizeof(tp));
  const E* xe = static_cast<const E*>(x);
  const P* ap = static_cast<const P*>(alpha);
  const P* bp = static_cast<const P*>(beta);
  E* oe = static_cast<E*>(out);
  const int n = (int)warps;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec)
    snake_kernel<true, E, P><<<blocks, kThreads, 0, s>>>(xe, ap, bp, tp, oe, C, T, chunks, n,
                                                         logscale);
  else
    snake_kernel<false, E, P><<<blocks, kThreads, 0, s>>>(xe, ap, bp, tp, oe, C, T, chunks, n,
                                                          logscale);
  return (int)cudaGetLastError();
}

// ---- K2-bf16: the FIRs on the tensor cores ---------------------------------

constexpr int kBWarps = 4;  // warps a block: ops/snake.py SNAKE_BF16_WARPS
constexpr int kBThreads = 32 * kBWarps;
constexpr int kBMinBlocks = 4;  // blocks an SM: ops/snake.py SNAKE_BF16_BLOCKS
constexpr int kStages = 4;      // x boxes a warp has in flight
constexpr int kBox = 64;        // time positions a box: ops/snake.py SNAKE_BF16_BOX
constexpr int kBoxBytes = 16 * kBox * 2;
// a warp's ring of x boxes and its two output boxes
constexpr int kWarpBytes = (kStages + 2) * kBoxBytes;
constexpr int kBSmem = kBWarps * kWarpBytes + 1024;  // + the 1024-byte alignment

// The banded tap matrices (16 x 8, k x n, bfloat16) as B fragments, from
// ops/snake.py `band_fragments`: f[m][lane] holds rows 2c, 2c + 1 (x) and
// 2c + 8, 2c + 9 (y) of column g of matrix m for lane (g, c) = (lane / 4,
// lane % 4), the lower row in the low 16 bits. Matrices (`band_taps`): the
// up FIR's even and odd phase over a window of 16 inputs, then the down FIR
// over a pair block left and right of an output block, each as hi and lo
// (tap = hi + lo).
struct Band {
  uint2 f[8][32];
};
enum { kEvenHi, kEvenLo, kOddHi, kOddLo, kLeftHi, kLeftLo, kRightHi, kRightLo };

// d += a.b over one m16n8k16 bfloat16 tile, float32 sums
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// lo in the low 16 bits, hi in the high, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// u0, u1 = hi + lo in bfloat16 pairs, to 2^-17 of each
__device__ __forceinline__ void split2(float u0, float u1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(u0, u1);
  lo = pack_bf16(u0 - __uint_as_float(hi << 16), u1 - __uint_as_float(hi & 0xffff0000u));
}

// SnakeBeta by sin^2 v = (1 - cos 2v) / 2: u + h - h cos(2 alpha u) with
// a2 = 2 alpha and h = 1 / (2 (beta + 1e-9)); the cosine on the SFU. (Its
// constant h is not moved into the down FIR's sum: with a small beta the
// terms would be ~h and cancel to a small output.)
__device__ __forceinline__ float snake_cos(float u, float a2, float h) {
  return fmaf(-h, __cosf(a2 * u), u + h);
}

// The bits of x[row][t], x[row][t + 1] (low, high), 0 past the rows or
// outside [0, T)
__device__ __forceinline__ uint32_t ld_pair(const uint16_t* __restrict__ x, int R, int T,
                                            int row, int t) {
  if (row >= R) return 0;
  const uint16_t* p = x + (size_t)row * T;
  const uint32_t a = t >= 0 && t < T ? __ldg(p + t) : 0u;
  const uint32_t b = t + 1 >= 0 && t + 1 < T ? __ldg(p + t + 1) : 0u;
  return a | b << 16;
}

// Chunk k (x[8k .. 8k+7]) of rows r0 + g and r0 + g + 8 from global
// memory, as ldmatrix gives it from a box: lane (g, c) holds elements 2c,
// 2c + 1
__device__ __forceinline__ void load_chunk(const uint16_t* __restrict__ x, int R, int T, int r0,
                                           int k, int lane, uint32_t (&v)[2]) {
  const int g = lane >> 2, t = 8 * k + 2 * (lane & 3);
  v[0] = ld_pair(x, R, T, r0 + g, t);
  v[1] = ld_pair(x, R, T, r0 + g + 8, t);
}

// Replicate padding on the right, for a chunk k that reaches T-1 (8k + 8
// >= T; warp-uniform): its elements at T and past become x[T-1] (xT, both
// halves; taken from the chunk that holds T-1, which comes before any
// chunk wholly past it).
__device__ __forceinline__ void pad_right(uint32_t (&v)[2], uint32_t (&xT)[2], int k, int T,
                                          int lane) {
  const int e = T - 1 - 8 * k;  // T-1's element in the chunk, if >= 0
  if (e >= 0) {
    const int src = (lane & ~3) | (e >> 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t w = __shfl_sync(kAll, v[i], src);
      xT[i] = ((e & 1) ? w >> 16 : w & 0xffffu) * 0x10001u;
    }
  }
  const int t = 8 * k + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (t >= T)
      v[i] = xT[i];
    else if (t + 1 >= T)
      v[i] = (v[i] & 0xffffu) | (xT[i] & 0xffff0000u);
  }
}

// The up FIR of a pair block (pairs 8q-4 .. 8q+3; C fragments, lane (g, c)
// holding pairs 8q-4+2c, +1 of rows g (0, 1) and g + 8 (2, 3): ce the even
// samples, co the odd) from the window x[8q-8 .. 8q+7] in win: chunk q-1
// in win[0..1] and q in win[2..3], or swapped (kSwap), which takes the B
// fragments with their halves swapped (B rows k and k + 8: bs, kept in
// registers of their own, as an mma reads its B from a register pair).
template <bool kSwap>
__device__ __forceinline__ void up_fir(const uint32_t (&bf)[8][2], const uint32_t (&bs)[4][2],
                                       const uint32_t (&win)[4], float (&ce)[4],
                                       float (&co)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ce[i] = co[i] = 0.f;
  mma16(ce, win, kSwap ? bs[kEvenLo] : bf[kEvenLo]);
  mma16(co, win, kSwap ? bs[kOddLo] : bf[kOddLo]);
  mma16(ce, win, kSwap ? bs[kEvenHi] : bf[kEvenHi]);
  mma16(co, win, kSwap ? bs[kOddHi] : bf[kOddHi]);
}

// The pair block's samples snaked and split hi + lo into the A fragments of
// the down FIR (k: the 8 even samples, then the 8 odd). kEdge: the block
// may hold pair 0 or T-1, and gets the up signal's edge clamp: up[m < 0]
// := up[0], up[m > 2T-1] := up[2T-1] (uT, taken from the block that holds
// pair T-1 and kept for blocks wholly past it).
template <bool kEdge>
__device__ __forceinline__ void snake_split(float (&ce)[4], float (&co)[4], const float (&a2)[2],
                                            const float (&h)[2], int q, int T, int lane,
                                            float (&uT)[2], uint32_t (&ph)[4],
                                            uint32_t (&pl)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ce[i] = snake_cos(ce[i], a2[i >> 1], h[i >> 1]);
    co[i] = snake_cos(co[i], a2[i >> 1], h[i >> 1]);
  }
  if constexpr (kEdge) {
    const bool left = q == 0, right = 8 * q + 4 >= T;  // holds pair 0; reaches pair T-1
    if (left || right) {
      float l[2] = {0.f, 0.f};
      if (left) {  // up[0]: the even sample of pair 0, column 4
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = __shfl_sync(kAll, ce[2 * i], (lane & ~3) | 2);
      }
      const int nT = T + 3 - 8 * q;  // pair T-1's column, if >= 0
      if (right && nT >= 0) {        // up[2T-1]: the odd sample of pair T-1
        const int src = (lane & ~3) | (nT >> 1);
        uT[0] = __shfl_sync(kAll, (nT & 1) ? co[1] : co[0], src);
        uT[1] = __shfl_sync(kAll, (nT & 1) ? co[3] : co[2], src);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 8 * q - 4 + 2 * (lane & 3) + e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (left && p < 0) ce[2 * i + e] = co[2 * i + e] = l[i];
          if (right && p > T - 1) ce[2 * i + e] = co[2 * i + e] = uT[i];
        }
      }
    }
  }
  split2(ce[0], ce[1], ph[0], pl[0]);
  split2(ce[2], ce[3], ph[1], pl[1]);
  split2(co[0], co[1], ph[2], pl[2]);
  split2(co[2], co[3], ph[3], pl[3]);
}

// acc += P.D over a pair block's 16 samples a row, P = ph + pl, D = dh +
// dl; the small products first, pl.dl left out
__device__ __forceinline__ void down(float (&acc)[4], const uint32_t (&ph)[4],
                                     const uint32_t (&pl)[4], const uint32_t (&dh)[2],
                                     const uint32_t (&dl)[2]) {
  mma16(acc, pl, dh);
  mma16(acc, ph, dl);
  mma16(acc, ph, dh);
}

__device__ __forceinline__ void ldm2(uint32_t addr, uint32_t& v0, uint32_t& v1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(v0), "=r"(v1)
               : "r"(addr));
}

// One launch over x (R, T), R = B * C rows of bfloat16 bits, into out.
// Warp w takes items w, w + W, ... (W the grid's warps); item i is row tile
// i / segs (rows 16 (i / segs) ..., 16 a tile) and time segment i % segs
// (outputs L (i % segs) .. + L, L a multiple of kBox), walked in output
// blocks of 8. Step j of a segment starting at s0 = 8 k0 computes pair
// block q = k0 + j + 1 from the window of chunks q-1 (kept from the last
// step) and q (the new one, written over the older chunk's registers, so
// the window's halves alternate), then output block b = k0 + j from pair
// blocks b (the last step's, its share already in acc) and b + 1. Steps go
// in groups of 8, one output box each; a group whose chunks stay short of
// T-1 is one straight line of code with the next step's up FIR issued
// before this step's snake, so tensor, SFU and FMA work overlap. kTma: the
// segment's chunks come from 2-D TMA boxes of 64 x 16 (the 128-byte
// swizzle) into a ring of kStages a warp, each landing on its mbarrier; a
// box is waited for before its first chunk is read and released when its
// last one has been, and lane 0 then asks for the next box of the warp's
// items into its stage. The chunk before a segment and the one after its
// last box are read from global memory (load_chunk). Outputs go through
// two swizzled output boxes a warp to TMA stores, which leave out what
// lies past T or the rows. Without kTma (T % 8 != 0 or unaligned pointers)
// every chunk is read from global memory and every output stored as it
// comes.
template <bool kTma, typename P>
__global__ void __launch_bounds__(kBThreads, kBMinBlocks)
snake_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap omap, const __grid_constant__ Band band,
                  const uint16_t* __restrict__ x, const P* __restrict__ alpha,
                  const P* __restrict__ beta, uint16_t* __restrict__ out, int R, int C, int T,
                  int L, int segs, int items, int logscale) {
  extern __shared__ uint8_t bsmem_raw[];
  __shared__ uint64_t bars[kBWarps * kStages];
  __shared__ uint2 sband[8 * 32];
  // the band's fragments into shared memory, 8 bytes a thread: lanes that
  // read different words of the constant bank take turns, so the block
  // reads each word once and its warps read shared memory
  for (int i = threadIdx.x; i < 8 * 32; i += kBThreads) sband[i] = band.f[i / 32][i % 32];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int W = gridDim.x * kBWarps;
  int item = blockIdx.x * kBWarps + warp;
  if (item >= items) return;

  // B fragments: bf[m][0] rows 2c, 2c + 1 and bf[m][1] rows 2c + 8, 2c + 9
  // of column g of matrix m
  uint32_t bf[8][2], bs[4][2];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const uint2 w = sband[m * 32 + lane];
    bf[m][0] = w.x;
    bf[m][1] = w.y;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    bs[m][0] = bf[m][1];
    bs[m][1] = bf[m][0];
  }

  uint8_t* ws = bsmem_raw + ((1024 - (smem_addr(bsmem_raw) & 1023)) & 1023) + warp * kWarpBytes;
  uint64_t* bar = bars + warp * kStages;
  // ldmatrix: lanes 0-7 give rows 0-7 of a chunk, lanes 8-15 rows 8-15; a
  // chunk's 16 bytes sit at (position ^ row % 8) << 4 in its row
  const int lrow = lane & 15;
  const uint32_t lbase = smem_addr(ws) + lrow * 128, lsw = (lrow & 7) << 4;
  // output boxes: lane (g, c) writes rows g and g + 8 at (s ^ g) << 4 + 4c
  uint8_t* obase = ws + kStages * kBoxBytes + g * 128 + 4 * c4;
  const int osw = g << 4;
  // the next box to ask for: its item's first output and row, its place
  // in the item and the item's boxes; the boxes asked for, waited for and
  // released so far; the output boxes stored so far
  int p_item = item, p_s0 = 0, p_r0 = 0, p_box = 0, p_nbox = 0, p_n = 0, n_wait = 0,
      n_out = 0;
  auto place = [&]() {
    const int tile = p_item / segs;
    p_r0 = 16 * tile;
    p_s0 = (p_item - tile * segs) * L;
    p_nbox = (min(L, T - p_s0) + kBox - 1) / kBox;
  };
  auto ask = [&]() {
    if (p_item >= items) return;
    if (lane == 0) {
      const int st = p_n % kStages;
      mbar_expect_tx(&bar[st], kBoxBytes);
      tma_load_2d(ws + st * kBoxBytes, &xmap, p_s0 + kBox * p_box, p_r0, &bar[st]);
    }
    ++p_n;
    if (++p_box == p_nbox) {
      p_item += W;
      p_box = 0;
      if (p_item < items) place();
    }
  };
  if constexpr (kTma) {
    if (lane == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(&bar[st], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    place();
    for (int i = 0; i < kStages; ++i) ask();
  }

  for (; item < items; item += W) {
    const int tile = item / segs;
    const int r0 = 16 * tile, s0 = (item - tile * segs) * L, k0 = s0 / 8;
    const int n_t = min(L, T - s0), nsteps = (n_t + 7) / 8, nbox = (n_t + kBox - 1) / kBox;
    // boxes of this item: box b sits in stage (base + b) % kStages; wt and
    // rl the next to wait for and to release
    const int base = n_wait;
    int wt = 0, rl = 0;
    auto stage_addr = [&](int b) { return lbase + ((base + b) % kStages) * kBoxBytes; };
    auto wait_box = [&]() {
      const int n = base + wt++;
      mbar_wait(&bar[n % kStages], (n / kStages) & 1);
      ++n_wait;
    };
    auto release = [&]() {
      ++rl;
      ask();
    };
    // the chunks before and after the segment's boxes, asked for now
    uint32_t win[4], hv[2] = {0u, 0u};
    load_chunk(x, R, T, r0, k0 - 1, lane, hv);
    win[0] = hv[0];
    win[1] = hv[1];
    if (kTma && nsteps == 8 * nbox) load_chunk(x, R, T, r0, k0 + 8 * nbox, lane, hv);
    // a2 = 2 alpha, h = 1 / (2 (beta + 1e-9)) of rows g, g + 8
    float a2[2], h[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = min(r0 + g + 8 * i, R - 1) % C;
      float a = ld(alpha + ch), bt = ld(beta + ch);
      if (logscale) {
        a = expf(a);
        bt = expf(bt);
      }
      a2[i] = 2.f * a;
      h[i] = 0.5f / (bt + 1e-9f);
    }
    uint32_t xT[2] = {0u, 0u};
    float uT[2] = {0.f, 0.f};
    // chunk k0 + c of the segment: from the ring where a box holds it (a
    // box entered is waited for, the boxes before it released)
    auto chunk = [&](int c, uint32_t& v0, uint32_t& v1) {
      if (kTma && c < 8 * nbox) {
        if (c % 8 == 0) {
          if (wt <= c / 8) wait_box();
          while (rl < c / 8) release();
        }
        ldm2(stage_addr(c / 8) + (((c % 8) << 4) ^ lsw), v0, v1);
      } else if (kTma && c == 8 * nbox) {
        v0 = hv[0];
        v1 = hv[1];
      } else {
        uint32_t v[2];
        load_chunk(x, R, T, r0, k0 + c, lane, v);
        v0 = v[0];
        v1 = v[1];
      }
      if (8 * (k0 + c) + 8 >= T) {
        uint32_t v[2] = {v0, v1};
        pad_right(v, xT, k0 + c, T, lane);
        v0 = v[0];
        v1 = v[1];
      }
    };
    float acc[4];
    uint32_t ph[4], pl[4];
    // output block j's values into output box n_out (s = j % 8 its column),
    // the box stored where `last`
    auto emit = [&](int j, int s, bool last) {
      const uint32_t y0 = pack_bf16(acc[0], acc[1]), y1 = pack_bf16(acc[2], acc[3]);
      if constexpr (kTma) {
        if (s == 0) {  // the store that last read this output box has read it
          if (lane == 0) bulk_wait_read<1>();
          __syncwarp();
        }
        uint8_t* ob = obase + (n_out & 1) * kBoxBytes + (osw ^ (s << 4));
        *reinterpret_cast<uint32_t*>(ob) = y0;
        *reinterpret_cast<uint32_t*>(ob + 8 * 128) = y1;
        if (last) {
          fence_proxy_async();
          __syncwarp();
          if (lane == 0)
            tma_store_2d(&omap, ws + (kStages + (n_out & 1)) * kBoxBytes, s0 + 8 * (j - s), r0);
          ++n_out;
        }
      } else {
        const int t = s0 + 8 * j + 2 * c4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + g + 8 * i;
          const uint32_t y = i ? y1 : y0;
          if (row < R) {
            uint16_t* p = out + (size_t)row * T;
            if (t < T) p[t] = y & 0xffffu;
            if (t + 1 < T) p[t + 1] = y >> 16;
          }
        }
      }
    };
    // output block q - 1 from pair block q (ce, co): finish acc, emit it,
    // start block q
    auto finish = [&](auto edge, float(&ce)[4], float(&co)[4], int q, int j, int s, bool last) {
      snake_split<decltype(edge)::value>(ce, co, a2, h, q, T, lane, uT, ph, pl);
      down(acc, ph, pl, bf[kRightHi], bf[kRightLo]);
      emit(j, s, last);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = 0.f;
      down(acc, ph, pl, bf[kLeftHi], bf[kLeftLo]);
    };

    // pair block k0: the window of chunks k0 - 1 (win[0..1]) and k0
    chunk(0, win[2], win[3]);
    if (s0 == 0) {  // replicate padding on the left: x[-8 .. -1] := x[0]
#pragma unroll
      for (int i = 0; i < 2; ++i)
        win[i] = (__shfl_sync(kAll, win[2 + i], lane & ~3) & 0xffffu) * 0x10001u;
    }
    {
      float ce[4], co[4];
      up_fir<false>(bf, bs, win, ce, co);
      snake_split<true>(ce, co, a2, h, k0, T, lane, uT, ph, pl);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = 0.f;
      down(acc, ph, pl, bf[kLeftHi], bf[kLeftLo]);
    }

    // step j writes its new chunk over the older half: win[0..1] for even
    // j (the window swapped), win[2..3] for odd j
    for (int j = 0; j < nsteps;) {
      if (kTma && j % 8 == 0 && j + 8 <= nsteps && 8 * (k0 + j + 8) + 8 < T) {
        // a whole output box, no edge: chunks 1-7 of box i = j / 8, then
        // chunk 0 of box i + 1 (or the chunk after the segment)
        const int i = j / 8;
        const bool ring = i + 1 < nbox;
        if (ring) wait_box();
        const uint32_t cur = stage_addr(i), nxt = ring ? stage_addr(i + 1) : cur;
        float ce[2][4], co[2][4];
        ldm2(cur + ((1 << 4) ^ lsw), win[0], win[1]);
        up_fir<true>(bf, bs, win, ce[0], co[0]);
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          if (s < 7) {  // the next step's chunk and up FIR
            uint32_t& v0 = win[(s + 1) % 2 ? 2 : 0];
            uint32_t& v1 = win[(s + 1) % 2 ? 3 : 1];
            if (s < 6) {
              ldm2(cur + (((s + 2) << 4) ^ lsw), v0, v1);
            } else {
              uint32_t t0, t1;
              ldm2(nxt + lsw, t0, t1);
              v0 = ring ? t0 : hv[0];
              v1 = ring ? t1 : hv[1];
            }
            if ((s + 1) % 2)
              up_fir<false>(bf, bs, win, ce[(s + 1) % 2], co[(s + 1) % 2]);
            else
              up_fir<true>(bf, bs, win, ce[(s + 1) % 2], co[(s + 1) % 2]);
          }
          finish(std::false_type(), ce[s % 2], co[s % 2], k0 + j + s + 1, j + s, s, s == 7);
        }
        release();
        j += 8;
      } else {
        float ce[4], co[4];
        if (j % 2) {
          chunk(j + 1, win[2], win[3]);
          up_fir<false>(bf, bs, win, ce, co);
        } else {
          chunk(j + 1, win[0], win[1]);
          up_fir<true>(bf, bs, win, ce, co);
        }
        finish(std::true_type(), ce, co, k0 + j + 1, j, j % 8, j % 8 == 7 || j == nsteps - 1);
        ++j;
      }
    }
    while (kTma && rl < nbox) release();
  }
  if constexpr (kTma) {
    if (lane == 0) bulk_wait_all();
  }
}

// The tensor map of (R, T) bfloat16 rows: boxes of 64 x 16 with the
// 128-byte swizzle; a box's parts past T or the rows come in as zeros and
// are not stored.
int snake_map(CUtensorMap* map, const void* base, int R, int T) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)T, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)T * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, 16};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <bool kTma, typename P>
int launch_bf16_as(const CUtensorMap& xm, const CUtensorMap& om, const Band& band,
                   const void* x, const void* alpha, const void* beta, void* out, int R, int C,
                   int T, int L, int segs, int items, int blocks, int logscale,
                   cudaStream_t s) {
  static int allowed[kMaxDevices] = {};
  if (kTma) {
    const int e = allow_smem(reinterpret_cast<const void*>(snake_bf16_kernel<kTma, P>), allowed,
                             kBSmem);
    if (e != 0) return e;
  }
  snake_bf16_kernel<kTma, P><<<blocks, kBThreads, kTma ? kBSmem : 0, s>>>(
      xm, om, band, static_cast<const uint16_t*>(x), static_cast<const P*>(alpha),
      static_cast<const P*>(beta), static_cast<uint16_t*>(out), R, C, T, L, segs, items,
      logscale);
  return (int)cudaGetLastError();
}

// The bfloat16 launch, alpha and beta of type P; a plan that does not fit
// the shape returns cudaErrorInvalidValue without a launch. TMA where it
// can describe x and out: rows of T % 8 == 0 elements (16-byte strides),
// both pointers 16-byte aligned.
template <typename P>
int launch_bf16(const void* x, const void* alpha, const void* beta, const uint16_t* band,
                void* out, int B, int C, int T, int logscale, int L, int segs, int items,
                int blocks, void* stream) {
  const long long R = (long long)B * C, tiles = (R + 15) / 16;
  if (B < 1 || C < 1 || T < 1 || R > 0x7fffffffll || L < kBox || L % kBox != 0 ||
      segs != (T + L - 1) / L || items != tiles * segs || blocks < 1 ||
      blocks > (items + kBWarps - 1) / kBWarps)
    return (int)cudaErrorInvalidValue;
  Band bd;
  memcpy(&bd, band, sizeof(bd));
  const bool tma = T % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CUtensorMap xm, om;
  memset(&xm, 0, sizeof(xm));
  memset(&om, 0, sizeof(om));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (!tma)
    return launch_bf16_as<false, P>(xm, om, bd, x, alpha, beta, out, (int)R, C, T, L, segs,
                                    items, blocks, logscale, s);
  int e = snake_map(&xm, x, (int)R, T);
  if (e == 0) e = snake_map(&om, out, (int)R, T);
  if (e != 0) return e;
  return launch_bf16_as<true, P>(xm, om, bd, x, alpha, beta, out, (int)R, C, T, L, segs, items,
                                 blocks, logscale, s);
}

}  // namespace

// taps: 24 host floats, `Taps` in order. The plan (R, chunks, blocks, vec)
// comes from ops/snake.py `snake_plan`. x and out float32; alpha and beta
// float32 (C,).
EXPORT int anti_alias_snake(const void* x, const void* alpha, const void* beta,
                            const float* taps, void* out, int B, int C, int T, int logscale,
                            int R, int chunks, int blocks, int vec, void* stream) {
  return launch<float, float>(x, alpha, beta, taps, out, B, C, T, logscale, R, chunks, blocks,
                              vec, stream);
}

// K2-bf16: x and out bfloat16, alpha and beta bfloat16 where ab_bf16, else
// float32. band: `Band` from ops/snake.py `band_taps`; the plan (L, segs,
// items, blocks) from ops/snake.py `snake_bf16_plan`.
EXPORT int anti_alias_snake_bf16(const void* x, const void* alpha, const void* beta,
                                 const uint16_t* band, void* out, int B, int C, int T,
                                 int logscale, int L, int segs, int items, int blocks,
                                 int ab_bf16, void* stream) {
  if (ab_bf16)
    return launch_bf16<__nv_bfloat16>(x, alpha, beta, band, out, B, C, T, logscale, L, segs,
                                      items, blocks, stream);
  return launch_bf16<float>(x, alpha, beta, band, out, B, C, T, logscale, L, segs, items,
                            blocks, stream);
}

// K2-bf16's registers and local (spill) bytes a thread on the current card:
// out[2i], out[2i + 1] for its TMA kernel (i = 0) and its kernel without
// TMA (1), alpha and beta bfloat16; then (2, 3) the same with float32.
EXPORT int anti_alias_snake_bf16_attributes(int* out) {
  const void* kernels[4] = {reinterpret_cast<const void*>(snake_bf16_kernel<true, __nv_bfloat16>),
                            reinterpret_cast<const void*>(snake_bf16_kernel<false, __nv_bfloat16>),
                            reinterpret_cast<const void*>(snake_bf16_kernel<true, float>),
                            reinterpret_cast<const void*>(snake_bf16_kernel<false, float>)};
  for (int i = 0; i < 4; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kernels[i]);
    if (e != cudaSuccess) return (int)e;
    out[2 * i] = a.numRegs;
    out[2 * i + 1] = (int)a.localSizeBytes;
  }
  return 0;
}
