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
// Bound on the H100: bytes. The function reads x once and writes the output
// once: 8 bytes against ~58 FLOPs and two sines an output. The design keeps
// the 2x-rate signal in registers and the instruction stream short enough
// to stay under the byte time:
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
//
// x and the output are float32, or bfloat16 (`anti_alias_snake_bf16`: the
// JAX package's bfloat16 vocoder): a bfloat16 row is read in 8-byte loads
// of 4 elements where T % 4 == 0, every value widened to float32, all the
// arithmetic above in float32 and each output rounded to bfloat16 once, to
// nearest even. alpha and beta are read as float32 or, with a bfloat16 x,
// as the bfloat16 a bfloat16 model stores them (`ab_bf16`), and widened.
//
// Chosen on the card (PERF.md): R = 12, a launch bound of 8 blocks an SM.
// tools/snake_times.py --probe rebuilds an edited copy of this file.

#include <cstring>

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
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// four consecutive outputs: one 16-byte store of float32, one 8-byte of
// bfloat16
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
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
  // vector loads and stores of 4 elements: 16 bytes of float32, 8 of bfloat16
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

// The same with x and out bfloat16, and alpha and beta bfloat16 where
// ab_bf16, else float32.
EXPORT int anti_alias_snake_bf16(const void* x, const void* alpha, const void* beta,
                                 const float* taps, void* out, int B, int C, int T,
                                 int logscale, int R, int chunks, int blocks, int vec,
                                 int ab_bf16, void* stream) {
  if (ab_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, alpha, beta, taps, out, B, C, T, logscale,
                                                R, chunks, blocks, vec, stream);
  return launch<__nv_bfloat16, float>(x, alpha, beta, taps, out, B, C, T, logscale, R, chunks,
                                      blocks, vec, stream);
}
