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
// (unit stride on the last axis); key_mask (B, T) bytes through its
// strides; stats (B, H, T, 2) contiguous, each row's m and log2 l from K3's
// forward (dit_attention.cu), in base 2; delta (B, H, T) contiguous,
// D = rowsum(dO o O), computed outside as the library computes `di` in XLA.
// Each kernel recomputes p = 2^((s log2(e) - m) - log2 l), then
// dP = dO.V^T and dS = p (dP - D), zero at masked and absent keys:
//   K9:  dV = P^T.dO, dK = Dh^-1/2 dS^T.Q   (a block per 64 keys)
//   K10: dQ = Dh^-1/2 dS.K                  (a block per 64 query rows)
// dQ has its own pass, as in the library, so no sum crosses blocks: each
// output element is summed by one thread in a fixed order, and a second
// call gives the same bits.
//
// Bound on the H100: operations. K9 does 8 T^2 Dh FLOPs per (b, h) (S, dP,
// dV, dK), K10 6 T^2 Dh (S, dP, dQ), against ~16-24 T Dh bytes: at T ~ 900
// some 250 FLOPs per byte. Design: the plain form, in float32 FMA on the
// CUDA cores (67 TFLOP/s); tensor cores (wgmma) and TMA are later work. A
// block of 256 threads holds its own 64 rows (K9: K and V; K10: Q and dO)
// in shared memory and walks the other side in 64-row tiles; a thread
// computes a 4 x 4 patch of each 64 x 64 product, rows ty + 16a and
// columns tx + 16c, so that a warp reads 16 consecutive rows of the
// column side (rows padded to 65 floats: 16 banks apart) and broadcasts
// two rows of the other. P and dS go through shared memory between the
// two products of a tile.

#include "common.cuh"

namespace {

constexpr int kD = 64;        // head width
constexpr int kB = 64;        // rows per tile, either side
constexpr int kThreads = 256;
constexpr int kPitch = kD + 1;  // floats per shared row
constexpr int kTile = kB * kPitch;
constexpr float kNegInf = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// element strides: q, k, v, dO, then the two outputs (K9: dK, dV; K10: dQ,
// unused), over (b, h, t); key_mask's over (b, t) in bytes
struct Layout {
  long long q[3], k[3], v[3], o[3], g0[3], g1[3], m[2];
};

// rows [r0, r0 + 64) of one (b, h) of x into a shared tile, zeros past T;
// a warp reads whole rows of 64 floats
__device__ __forceinline__ void load_tile(float* dst, const float* x, const long long st,
                                          int r0, int T) {
  for (int i = threadIdx.x; i < kB * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    dst[r * kPitch + c] = r0 + r < T ? x[(r0 + r) * st + c] : 0.f;
  }
}

// the 4 x 4 patch acc[a][c] = sum_d A[ty + 16a][d] B[tx + 16c][d]
__device__ __forceinline__ void patch_abt(float (&acc)[4][4], const float* A, const float* B,
                                          int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty + 16 * a) * kPitch + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = B[(tx + 16 * c) * kPitch + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
  }
}

// acc[a][c] += sum_r A[r][ty + 16a] B[r][tx + 16c]  (A^T.B over 64 rows)
__device__ __forceinline__ void patch_atb(float (&acc)[4][4], const float* A, const float* B,
                                          int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < kB; ++r) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[r * kPitch + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = B[r * kPitch + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
  }
}

// acc[a][c] += sum_j A[ty + 16a][j] B[j][tx + 16c]  (A.B over 64 columns)
__device__ __forceinline__ void patch_ab(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll 8
  for (int j = 0; j < kB; ++j) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty + 16 * a) * kPitch + j];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = B[j * kPitch + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
  }
}

// p and dS of one score: s the raw q.k, (m, l2) the row's statistics, key
// the key's state (0 absent, 1 masked, 2 valid), di the row's D
__device__ __forceinline__ void p_ds(float s, float dp, float2 st, float di, int key,
                                     float c2, float& p, float& ds) {
  const float x = key == 2 ? s * c2 : kNegInf;
  p = key ? exp2f((x - st.x) - st.y) : 0.f;
  ds = key == 2 ? p * (dp - di) : 0.f;
}

// K9: a block owns keys [64 blockIdx.x, +64) of (b, h) = (blockIdx.z,
// blockIdx.y) and walks every query tile
__global__ void __launch_bounds__(kThreads)
dit_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
                        const float* __restrict__ dout, const float2* __restrict__ stats,
                        const float* __restrict__ delta, float* __restrict__ dk,
                        float* __restrict__ dv, const Layout L, int T, float scale) {
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;
  float* Os = Qs + kTile;  // dO
  float* Ps = Os + kTile;
  float* Ss = Ps + kTile;  // dS
  float2* st_s = reinterpret_cast<float2*>(Ss + kTile);
  float* di_s = reinterpret_cast<float*>(st_s + kB);
  int* key_s = reinterpret_cast<int*>(di_s + kB);

  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int key0 = blockIdx.x * kB;
  const long long bh = (long long)b * H + h;
  const float c2 = scale * kLog2e;
  const float* qb = q + b * L.q[0] + h * L.q[1];
  const float* ob = dout + b * L.o[0] + h * L.o[1];

  load_tile(Ks, k + b * L.k[0] + h * L.k[1], L.k[2], key0, T);
  load_tile(Vs, v + b * L.v[0] + h * L.v[1], L.v[2], key0, T);
  if (threadIdx.x < kB) {
    const int j = key0 + threadIdx.x;
    key_s[threadIdx.x] = j >= T ? 0 : key_mask[b * L.m[0] + j * L.m[1]] ? 2 : 1;
  }

  float acc_v[4][4], acc_k[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_v[a][c] = acc_k[a][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kB) {
    __syncthreads();  // the previous tile's products are done with Qs, Os, Ps, Ss
    load_tile(Qs, qb, L.q[2], q0, T);
    load_tile(Os, ob, L.o[2], q0, T);
    if (threadIdx.x < kB) {
      const int i = q0 + threadIdx.x;
      st_s[threadIdx.x] = i < T ? stats[bh * T + i] : make_float2(0.f, 0.f);
      di_s[threadIdx.x] = i < T ? delta[bh * T + i] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    patch_abt(s, Qs, Ks, ty, tx);
    patch_abt(dp, Os, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      const bool row = q0 + r < T;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        float p, ds;
        p_ds(s[a][c], dp[a][c], st_s[r], di_s[r], row ? key_s[j] : 0, c2, p, ds);
        Ps[r * kPitch + j] = p;
        Ss[r * kPitch + j] = ds;
      }
    }
    __syncthreads();
    patch_atb(acc_v, Ps, Os, ty, tx);  // dV[j][d] += sum_i P[i][j] dO[i][d]
    patch_atb(acc_k, Ss, Qs, ty, tx);  // dK[j][d] += sum_i dS[i][j] Q[i][d]
  }

  float* dkb = dk + b * L.g0[0] + h * L.g0[1];
  float* dvb = dv + b * L.g1[0] + h * L.g1[1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = key0 + ty + 16 * a;
    if (j >= T) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = tx + 16 * c;
      dkb[j * L.g0[2] + d] = acc_k[a][c] * scale;
      dvb[j * L.g1[2] + d] = acc_v[a][c];
    }
  }
}

// K10: a block owns query rows [64 blockIdx.x, +64) of (b, h) and walks
// every key tile
__global__ void __launch_bounds__(kThreads)
dit_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ key_mask,
                       const float* __restrict__ dout, const float2* __restrict__ stats,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       const Layout L, int T, float scale) {
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Os = Qs + kTile;  // dO
  float* Ks = Os + kTile;
  float* Vs = Ks + kTile;
  float* Ss = Vs + kTile;  // dS
  int* key_s = reinterpret_cast<int*>(Ss + kTile);

  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kB;
  const long long bh = (long long)b * H + h;
  const float c2 = scale * kLog2e;
  const float* kb = k + b * L.k[0] + h * L.k[1];
  const float* vb = v + b * L.v[0] + h * L.v[1];
  const uint8_t* mb = key_mask + b * L.m[0];

  load_tile(Qs, q + b * L.q[0] + h * L.q[1], L.q[2], row0, T);
  load_tile(Os, dout + b * L.o[0] + h * L.o[1], L.o[2], row0, T);
  // this thread's rows' statistics
  float2 st[4];
  float di[4];
  bool row[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = row0 + ty + 16 * a;
    row[a] = i < T;
    st[a] = row[a] ? stats[bh * T + i] : make_float2(0.f, 0.f);
    di[a] = row[a] ? delta[bh * T + i] : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int key0 = 0; key0 < T; key0 += kB) {
    __syncthreads();  // the previous tile's product is done with Ks, Ss
    load_tile(Ks, kb, L.k[2], key0, T);
    load_tile(Vs, vb, L.v[2], key0, T);
    if (threadIdx.x < kB) {
      const int j = key0 + threadIdx.x;
      key_s[threadIdx.x] = j >= T ? 0 : mb[j * L.m[1]] ? 2 : 1;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    patch_abt(s, Qs, Ks, ty, tx);
    patch_abt(dp, Os, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        float p, ds;
        p_ds(s[a][c], dp[a][c], st[a], di[a], row[a] ? key_s[j] : 0, c2, p, ds);
        Ss[(ty + 16 * a) * kPitch + j] = ds;
      }
    }
    __syncthreads();
    patch_ab(acc, Ss, Ks, ty, tx);  // dQ[i][d] += sum_j dS[i][j] K[j][d]
  }

  float* dqb = dq + b * L.g0[0] + h * L.g0[1];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (!row[a]) continue;
    const int i = row0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) dqb[i * L.g0[2] + tx + 16 * c] = acc[a][c] * scale;
  }
}

constexpr int kSmemDkv = 6 * kTile * (int)sizeof(float) + kB * (8 + 4 + 4);
constexpr int kSmemDq = 5 * kTile * (int)sizeof(float) + kB * 4;

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
  const dim3 grid((T + kB - 1) / kB, H, B);
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
  const dim3 grid((T + kB - 1) / kB, H, B);
  dit_attn_bwd_dq_kernel<<<grid, kThreads, kSmemDq, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(key_mask), static_cast<const float*>(dout),
      static_cast<const float2*>(stats), static_cast<const float*>(delta),
      static_cast<float*>(dq), layout(strides), T, scale);
  return (int)cudaGetLastError();
}
