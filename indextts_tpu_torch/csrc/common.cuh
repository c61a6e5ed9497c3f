// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define EXPORT extern "C" __attribute__((visibility("default")))

// four consecutive elements of a row as float
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

// shared-memory barriers and the Hopper bulk copies that complete on them
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the barrier's phase of the given parity (0: its first); a
// copy that has not landed after ~2^34 cycles traps, so the launch fails
// instead of hanging. The loop is PTX's own, so the compiler sees no
// branch that a warp might take apart (wgmma after it stays asynchronous).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity = 0) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 17179869184;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one arrival on the barrier (its count set by mbar_init) where `pred`,
// predicated rather than branched around
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(smem_addr(bar)), "r"((int)pred)
      : "memory");
}

// box {x, y} of the 2-D tensor map into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// shared memory into box {x, y} of the 2-D tensor map (elements past the
// map's bounds are not written), as one bulk group of this thread
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int x,
                                             int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
      "cp.async.bulk.commit_group;" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(smem_addr(src))
      : "memory");
}

// waits until at most N of this thread's bulk groups still read shared
// memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// waits until this thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// orders this thread's shared-memory writes before later bulk copies
// (the async proxy) read them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// box {x, y, z, w} of the 4-D tensor map into shared memory
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int x, int y,
                                            int z, int w, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(w),
      "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so that only the runtime is linked; null if missing
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 16 bytes global -> shared, zero-filled when !full (the source is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}

// ---- 3xTF32 on the tensor cores (K3, K9, K10) ----------------------------

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

// d += a.b in 3xTF32 for N accumulators sharing a, the small products first
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&bh)[N][2],
                                     const unsigned (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ah, bh[n]);
}

__device__ __forceinline__ float elem(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ unsigned elem(const uint4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

constexpr int kMaxDevices = 64;

// allows `kernel` `bytes` of dynamic shared memory on the current device;
// allowed[d]: the bytes device d has allowed the kernel so far (one array
// per kernel, zeroed)
inline int allow_smem(const void* kernel, int* allowed, int bytes) {
  static std::mutex lock;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (bytes > allowed[device]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    allowed[device] = bytes;
  }
  return 0;
}
