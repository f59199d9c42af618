// Paged flash-decode: one query token per row against a global page pool.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode_attention.py::paged_decode_attention, both
// bodies: `_kernel` (model-dtype pages) and `_kernel_quant` (int8 or
// float8_e4m3fn pages with one f32 scale per (page, kv head), fused
// dequant). Row b's token t lives in physical page table[b, t / pt] at slot
// t % pt; row b attends its first lengths[b] tokens with scale 1/sqrt(D)
// and an optional tanh softcap.
//
// Bound on the H100 by memory: each row's K and V bytes are read once
// (4 flops per K/V element pair against ~2 bytes each in bf16, 1 byte each
// for quantized pages). Design: one CTA per (row b, kv head g) serves the
// G query heads sharing that kv head, so each K/V element is fetched from
// device memory once for all G heads. The TPU kernel's sequential page axis
// becomes a loop inside the block over tiles of 64 tokens; the block reads
// table[b, .] and lengths[b] itself in place of scalar prefetch, and stops
// at the row's length (the TPU kernel fetches and masks the padded pages,
// which are exact no-ops). The online softmax state (m, l, acc) stays in
// f32 in shared memory. Within a tile a warp reduces each (head, token) dot
// product over D with coalesced loads, then every thread owns (head, d)
// accumulator entries for the P.V update. That tile loop lives in
// flash_decode.cuh and is shared with the dense decode kernel
// (decode_attention.cu): for the same tokens in order the two agree bitwise.
//
// The two bodies are one template over the page loader. Quantized pages
// read their (page, g) scales once per tile while the tile's offsets are
// built (the TPU kernel's scalar prefetch), and each element is widened as
// float(code) * scale before the same f32 op sequence: with f32 q the
// quantized kernel equals the model-dtype kernel run on page_dequant-ed
// pages bitwise.
#include "flash_decode.cuh"

#include <cuda_fp8.h>

using rap_decode::kThreads;
using rap_decode::kTile;

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);  // exact: every e4m3 value is an f32
}

// One page element widened to f32: the plain cast for model-dtype pages,
// code * scale for quantized ones.
template <bool kQuant, typename P>
__device__ __forceinline__ float load_page(const P* p, long long i, float s) {
  if constexpr (kQuant) return to_f32(p[i]) * s;
  else return to_f32(p[i]);
}

// Token loader of rap_decode::attend: chases row b's page-table row for
// each tile and, for quantized pages, reads the (page, g) scales once per
// tile beside the offsets. Every token up to the row's length is attended.
template <typename P, bool kQuant>
struct PagedLoader {
  const P* kp;
  const P* vp;
  const float* ks;
  const float* vs;
  const int* table_row;   // [max_pages]
  long long tok_stride;   // K * D
  int pt, K, g, D;
  long long* off_s;       // [kTile] element offset of each token's head g
  float* ks_s;            // [kTile] K scale per token (quant)
  float* vs_s;            // [kTile] V scale per token (quant)

  __device__ void tile(int t0, int nt, int tid) {
    for (int j = tid; j < nt; j += kThreads) {
      const int t = t0 + j;
      const long long page = table_row[t / pt];
      off_s[j] = (page * pt + t % pt) * tok_stride + (long long)g * D;
      if constexpr (kQuant) {
        ks_s[j] = ks[page * K + g];
        vs_s[j] = vs[page * K + g];
      }
    }
  }
  __device__ bool valid(int) const { return true; }
  __device__ float k(int j, int d) const {
    return load_page<kQuant>(kp, off_s[j] + d, kQuant ? ks_s[j] : 1.f);
  }
  __device__ float v(int j, int d) const {
    return load_page<kQuant>(vp, off_s[j] + d, kQuant ? vs_s[j] : 1.f);
  }
};

// T: q/out dtype; P: page dtype; kQuant: pages carry [n_pages, K] scales.
template <typename T, typename P, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                    const P* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int K, int D, int pt, int max_pages, float scale,
                    float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / K;
  long long* off_s = reinterpret_cast<long long*>(smem);        // [kTile]
  float* loop_s = reinterpret_cast<float*>(off_s + kTile);
  float* ks_s = loop_s + rap_decode::loop_floats(G, D);          // [kTile]
  float* vs_s = ks_s + kTile;                                    // [kTile]
  const int b = blockIdx.x, g = blockIdx.y;
  PagedLoader<P, kQuant> ld{kp, vp, ks, vs,
                            table + (long long)b * max_pages,
                            (long long)K * D, pt, K, g, D, off_s, ks_s,
                            vs_s};
  // tokens past the table width are never attended (as on the TPU, whose
  // grid covers max_pages pages)
  const int len = min(lengths[b], max_pages * pt);
  const long long head0 = ((long long)b * H + (long long)g * G) * D;
  rap_decode::attend(q + head0, out + head0, G, D, len, scale, softcap, ld,
                     loop_s);
}

static size_t smem_bytes(int G, int D, bool quant) {
  return kTile * sizeof(long long)
      + (size_t)(rap_decode::loop_floats(G, D) + (quant ? 2 * kTile : 0))
        * sizeof(float);
}

template <typename T, typename P, bool kQuant>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* table,
                  const void* lengths, void* out, int B, int H, int K, int D,
                  int pt, int max_pages, float scale, float softcap,
                  cudaStream_t s) {
  const size_t smem = smem_bytes(H / K, D, kQuant);
  auto kern = paged_decode_kernel<T, P, kQuant>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, K), kThreads, smem, s>>>(
      (const T*)q, (const P*)kp, (const P*)vp, (const float*)ks,
      (const float*)vs, (const int*)table, (const int*)lengths, (T*)out, H, K,
      D, pt, max_pages, scale, softcap);
  return (int)cudaGetLastError();
}

// q [B,1,H,D]; k/v pages [n_pages, pt, K, D]; table int32 [B, max_pages];
// lengths int32 [B]; out [B,1,H,D]. All contiguous, one dtype.
extern "C" int rap_paged_decode_attention(const void* q, const void* kp,
                                          const void* vp, const void* table,
                                          const void* lengths, void* out,
                                          int B, int H, int K, int D, int pt,
                                          int max_pages, float scale,
                                          float softcap, int dtype,
                                          void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    return launch<T, T, false>(q, kp, vp, nullptr, nullptr, table, lengths,
                               out, B, H, K, D, pt, max_pages, scale,
                               softcap, s);
  });
  return 0;
}

// As above with int8 (page_dtype 0) or float8_e4m3fn (page_dtype 1) pages
// and f32 scales k/v_scales [n_pages, K]; q and out in `dtype`.
extern "C" int rap_paged_decode_attention_quant(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* lengths, void* out, int B,
    int H, int K, int D, int pt, int max_pages, float scale, float softcap,
    int dtype, int page_dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    switch (page_dtype) {
      case 0:
        return launch<T, int8_t, true>(q, kp, vp, ks, vs, table, lengths,
                                       out, B, H, K, D, pt, max_pages, scale,
                                       softcap, s);
      case 1:
        return launch<T, __nv_fp8_e4m3, true>(q, kp, vp, ks, vs, table,
                                              lengths, out, B, H, K, D, pt,
                                              max_pages, scale, softcap, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return 0;
}
