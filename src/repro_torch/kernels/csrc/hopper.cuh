// Hopper building blocks for the hand-written kernels: tensor maps and TMA
// tile copies, mbarrier rings, wgmma on warpgroups.
//
// Everything is inline PTX for sm_90a (wgmma exists only on that
// target). The host side reaches the CUDA driver's cuTensorMapEncodeTiled
// through the runtime's driver entry point, so the library links against
// the CUDA runtime alone (no -lcuda).
//
// Shared-memory tiles use the 128-byte swizzle throughout: a tile is one
// or more boxes of [rows][64] 16-bit elements, rows 128 bytes apart, the
// 16-byte chunk c of row r stored at chunk c ^ (r & 7); every box starts
// on a 1024-byte boundary. TMA writes that pattern (CU_TENSOR_MAP_SWIZZLE_
// 128B) and a wgmma descriptor of layout type 1 reads it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (null if the
// driver has none)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 16-bit [n3][n2][n1][n0] row-major tensor (n0 innermost, n0 % 8 == 0,
// base 16-byte aligned) as a tensor map whose box is 64 elements of dim 0
// (128 bytes, 128-byte swizzle) by one of dim 1 by `rows` of dim 2 by one
// of dim 3. Elements past the tensor's edge load as zero and are never
// stored. Returns 0 or a CUDA error code.
inline int encode_4d(CUtensorMap* map, const void* base, bool bf16, int n0,
                     int n1, int n2, int n3, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2,
                              (cuuint64_t)n3};
  const cuuint64_t strides[3] = {(cuuint64_t)n0 * 2, (cuuint64_t)n0 * n1 * 2,
                                 (cuuint64_t)n0 * n1 * n2 * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = fn(map,
                  bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                  4, const_cast<void*>(base), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 4-D tensor of 1- or 2-byte elements with the given byte strides of
// dims 1-3 (dim 0 contiguous; base and strides 16-byte multiples) as a
// tensor map with box `box` (innermost first). `swizzle128`: the box's
// inner extent is 128 bytes, stored with the 128-byte swizzle; else it is
// stored plainly, row after row. Elements past the tensor's edge load as
// zero. `dtype`: 0 bf16, 1 fp16, 2 one-byte codes. Returns 0 or a CUDA
// error code.
inline int encode_strided(CUtensorMap* map, const void* base, int dtype,
                          const long long (&dims)[4],
                          const long long (&strides)[3],
                          const int (&box)[4], bool swizzle128) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t d[4], s[3];
  cuuint32_t b[4];
  const cuuint32_t step[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    if (dims[i] < 1 || box[i] < 1 || box[i] > 256)
      return (int)cudaErrorInvalidValue;
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
  }
  for (int i = 0; i < 3; ++i) {
    if (strides[i] <= 0 || strides[i] % 16) return (int)cudaErrorInvalidValue;
    s[i] = (cuuint64_t)strides[i];
  }
  const CUtensorMapDataType ty = dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                              : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUresult r = fn(map, ty, 4, const_cast<void*>(base), d, s, b, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarrier: `count` arrivals (plus any expected transaction bytes)
// complete a phase; a wait names the parity of the phase it waits out
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits out the phase of parity `parity`. A phase that has not completed
// after 4 s lost an arrival or a transaction (a fault of the kernel): the
// kernel traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = globaltimer_ns();
  while (!mbar_try_wait(a, parity))
    if (globaltimer_ns() - t0 > 4000000000ull) __trap();
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// one box at element coordinates (c0, c1, c2, c3), innermost first, into
// shared memory; completes `bytes` of the barrier's transactions
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// commit the issued TMA stores and wait until shared memory was read
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` over `threads` threads (whole warps): sync waits for
// all of them, arrive counts this warp and goes on
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// K-major (rows of the M or N dimension, K along the 128-byte row): the
// stride offset is 1024 bytes (8 rows), the leading offset unused (1); a
// k16 step adds 32 bytes to the start. MN-major (K along the rows, M or N
// along the 128-byte row): the leading offset is the distance between
// 64-element boxes of the M or N dimension, the stride offset 1024 bytes
// (8 rows of K); a k16 step adds 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] with f32 accumulators (N / 2 a
// thread, in the m16n8 accumulator layout repeated over N / 8 columns
// blocks and 4 warps of 16 rows). ss: A and B K-major in shared memory.
// rs: A in registers (the m16n8k16 A fragment), B MN-major in shared
// memory. `accumulate` 0 overwrites D.
template <int N, typename T> struct Wgmma;

#define RAP_WGMMA_FOR(T, TY)                                                                                               \
template <> struct Wgmma<64, T> {                                                                                          \
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {                    \
    asm volatile(                                                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                                       \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                           \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                                   \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                                                 \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])           \
        : "l"(da), "l"(db), "r"(accumulate));                                                                              \
  }                                                                                                                        \
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {         \
    asm volatile(                                                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                                       \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                                       \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                           \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                                   \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));                                           \
  }                                                                                                                        \
};                                                                                                                         \
template <> struct Wgmma<128, T> {                                                                                         \
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {                    \
    asm volatile(                                                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                                       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                                      \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                           \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                                 \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                                 \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                                   \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                                                                 \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),          \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),          \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])           \
        : "l"(da), "l"(db), "r"(accumulate));                                                                              \
  }                                                                                                                        \
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {         \
    asm volatile(                                                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                                       \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                                      \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                           \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                                 \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                                 \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                                   \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),          \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),          \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])           \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));                                           \
  }                                                                                                                        \
};                                                                                                                         \
template <> struct Wgmma<256, T> {                                                                                         \
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int accumulate) {        \
    asm volatile(                                                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                                                      \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                                                      \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                           \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                                 \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                                 \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                                 \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                                 \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                                 \
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "                     \
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"                   \
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                                                              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                  \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),            \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),          \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),          \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),          \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),          \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),          \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),          \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),          \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),      \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),  \
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])   \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));                                           \
  }                                                                                                                        \
};


RAP_WGMMA_FOR(__nv_bfloat16, "bf16")
RAP_WGMMA_FOR(__half, "f16")
#undef RAP_WGMMA_FOR

// Narrow products for decode's token tiles: D[64 x N] (+)= A[64 x 16]
// B[16 x N], N = 8 or 16, f32 accumulators (N / 2 a thread, the
// layout above), both operands in shared memory through descriptors. B is
// K-major; A is K-major (TA = 0) or MN-major (TA = 1: a transposed A, M
// along the 128-byte rows, as a tile of V read as V^T).
template <int N, typename T> struct WgmmaNarrow;

#define RAP_WGMMA_NARROW(T, TY)                                                                                            \
template <> struct WgmmaNarrow<8, T> {                                                                                     \
  template <int TA>                                                                                                        \
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t da, uint64_t db, int accumulate) {                     \
    asm volatile(                                                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"                                                                        \
        "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " "                                                         \
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 0;\n}\n"                                                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                                                                   \
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA));                                                                     \
  }                                                                                                                        \
};                                                                                                                         \
template <> struct WgmmaNarrow<16, T> {                                                                                    \
  template <int TA>                                                                                                        \
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {                     \
    asm volatile(                                                                                                          \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                                                                       \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "                                                        \
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"                                                  \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                  \
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA));                                                                     \
  }                                                                                                                        \
};

RAP_WGMMA_NARROW(__nv_bfloat16, "bf16")
RAP_WGMMA_NARROW(__half, "f16")
#undef RAP_WGMMA_NARROW

}  // namespace hopper
