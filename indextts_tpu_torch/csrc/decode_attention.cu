// K1: ragged single-token decode attention with a masked hole.
//
// Replaces the JAX package's Pallas kernels in indextts_tpu/ops/
// decode_attention.py: `_kernel` / `ragged_decode_attention` (no hole),
// `_kernel_t` / `ragged_decode_attention_t` (transposed cache + hole, the
// one GPT2Attention calls with attn_impl="pallas_ragged") and
// `_kernel_blocked` / `ragged_decode_attention_blocked`. Those layouts exist
// for Mosaic's lane tiles; here the cache keeps its natural (B, H, cap, Dh)
// layout and one kernel covers all three.
//
// out[b,h] = softmax_t(q.k_t * Dh^-1/2) . v_t over keys t < valid[b] outside
// [hole_start[b], hole_end[b]), online softmax accumulated in fp32. K/V are
// float32 or bfloat16; Dh is 64.
//
// K4 is the same kernel over an int8 cache with per-(head, token) f32
// scales (models/gpt2.py `quantize_kv`): it replaces `_kernel_blocked_q8` /
// `ragged_decode_attention_blocked_q8` and `_kernel_grid_q8` (rows 4-5 of
// the kernel table), whose block-major layout is a DMA artifact of the TPU;
// here the int8 cache keeps (B, H, cap, Dh) and its scales (B, H, cap). As
// the TPU kernel does, the key scale folds into the score,
// s = (q.k8) * ksc[t] * Dh^-1/2, and the value scale into the probability,
// acc += (p * vsc[t]) * v8: nothing is dequantized in memory. A key row is
// 64 bytes, which a half-warp reads with 4-byte loads.
//
// Bound on the H100: bytes. A decode step reads each valid K and V row once
// (B=1, H=20, Dh=64, ~1.7k keys: ~17 MB per layer in fp32) and does 4 FLOPs
// per byte, far below the card's ridge. At B=1 one block per (b, h) would
// occupy 20 of 132 SMs, so the design is split-K (flash-decoding): pass 1
// gives each block a 64-key range of one (b, h); a half-warp reads one key
// row with 16-byte loads (fully used 32-byte sectors), four warps keep eight
// rows in flight, and the block reduces its keys to (m, l, acc[64]). Pass 2
// combines the ranges of each (b, h). The split count follows the cache
// capacity (a shape), not valid_len (device data), so the host never syncs;
// ranges past valid_len exit at once.

#include "common.cuh"

namespace {

constexpr int kDh = 64;
constexpr int kThreads = 128;            // 4 warps, 8 half-warps
constexpr int kHalfWarps = kThreads / 16;
constexpr int kPart = kDh + 2;           // m, l, acc[64]

template <typename T, bool kQ8>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ ksc,
             const float* __restrict__ vsc, const int* __restrict__ valid,
             const int* __restrict__ hole_s, const int* __restrict__ hole_e,
             float* __restrict__ part, int H, int cap, int chunk, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, hl = lane & 15;
  const int hw = warp * 2 + half;
  const int vl = min(valid[b], cap);
  const int hs = hole_s[b], he = hole_e[b];
  const int start = split * chunk;
  const int end = min(start + chunk, vl);
  const size_t bh = (size_t)b * H + h;
  const float4 qv = load4(q + bh * kDh + hl * 4);
  const T* kb = k + bh * (size_t)cap * kDh;
  const T* vb = v + bh * (size_t)cap * kDh;
  const float* kscb = kQ8 ? ksc + bh * (size_t)cap : nullptr;
  const float* vscb = kQ8 ? vsc + bh * (size_t)cap : nullptr;

  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // the trip count depends on the warp only, so all 32 lanes shuffle together
  for (int base = start + warp * 2; base < end; base += kHalfWarps) {
    const int t = base + half;
    const bool in = t < end;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) kv = load4(kb + (size_t)t * kDh + hl * 4);
    float s = qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (in && (t < hs || t >= he)) {
      if (kQ8) s *= kscb[t];
      s *= scale;
      const float4 vv = load4(vb + (size_t)t * kDh + hl * 4);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float e = expf(s - m_new);
      const float p = kQ8 ? e * vscb[t] : e;
      l = l * alpha + e;
      acc.x = acc.x * alpha + p * vv.x;
      acc.y = acc.y * alpha + p * vv.y;
      acc.z = acc.z * alpha + p * vv.z;
      acc.w = acc.w * alpha + p * vv.w;
      m = m_new;
    }
  }

  __shared__ float sm_m[kHalfWarps], sm_l[kHalfWarps];
  __shared__ float sm_acc[kHalfWarps][kDh];
  if (hl == 0) {
    sm_m[hw] = m;
    sm_l[hw] = l;
  }
  *reinterpret_cast<float4*>(&sm_acc[hw][hl * 4]) = acc;
  __syncthreads();
  if (tid < kDh) {
    float M = -INFINITY;
    for (int i = 0; i < kHalfWarps; ++i) M = fmaxf(M, sm_m[i]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int i = 0; i < kHalfWarps; ++i) {
        const float w = expf(sm_m[i] - M);
        L += sm_l[i] * w;
        A += sm_acc[i][tid] * w;
      }
    }
    float* dst = part + (bh * n_splits + split) * kPart;
    dst[2 + tid] = A;
    if (tid == 0) {
      dst[0] = M;
      dst[1] = L;
    }
  }
}

__global__ void __launch_bounds__(kDh)
combine_kernel(const float* __restrict__ part, float* __restrict__ out,
               int H, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  const float* src = part + bh * n_splits * kPart;
  float M = -INFINITY;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, src[i * kPart]);
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int i = 0; i < n_splits; ++i) {
      const float w = expf(src[i * kPart] - M);
      L += src[i * kPart + 1] * w;
      A += src[i * kPart + 2 + d] * w;
    }
  }
  out[bh * kDh + d] = A / fmaxf(L, 1e-30f);
}

}  // namespace

EXPORT int ragged_decode_attention(const void* q, const void* k, const void* v,
                                   const void* valid, const void* hole_s,
                                   const void* hole_e, void* part, void* out,
                                   int B, int H, int cap, int chunk,
                                   int n_splits, int bf16, float scale,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(n_splits, H, B);
  if (bf16) {
    split_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), nullptr, nullptr,
        static_cast<const int*>(valid),
        static_cast<const int*>(hole_s), static_cast<const int*>(hole_e),
        static_cast<float*>(part), H, cap, chunk, scale);
  } else {
    split_kernel<float, false><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), nullptr, nullptr,
        static_cast<const int*>(valid),
        static_cast<const int*>(hole_s), static_cast<const int*>(hole_e),
        static_cast<float*>(part), H, cap, chunk, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<dim3(H, B), kDh, 0, s>>>(static_cast<const float*>(part),
                                           static_cast<float*>(out), H,
                                           n_splits);
  return (int)cudaGetLastError();
}

EXPORT int ragged_decode_attention_q8(const void* q, const void* k8,
                                      const void* v8, const void* ksc,
                                      const void* vsc, const void* valid,
                                      const void* hole_s, const void* hole_e,
                                      void* part, void* out, int B, int H,
                                      int cap, int chunk, int n_splits,
                                      float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  split_kernel<int8_t, true><<<dim3(n_splits, H, B), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(valid),
      static_cast<const int*>(hole_s), static_cast<const int*>(hole_e),
      static_cast<float*>(part), H, cap, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<dim3(H, B), kDh, 0, s>>>(static_cast<const float*>(part),
                                           static_cast<float*>(out), H,
                                           n_splits);
  return (int)cudaGetLastError();
}
