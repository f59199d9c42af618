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
// for quantized pages). Design: the split-KV loop of flash_decode.cuh, one
// CTA per (row b, kv head g, split of split_tokens), shared with the dense
// decode kernel (decode_attention.cu): the same split boundaries and the
// same tile loop, so for the same tokens in order the two agree bitwise.
// The TPU kernel's sequential page axis becomes the splits and the 64-token
// tiles inside one; the block reads table[b, .] and lengths[b] itself in
// place of scalar prefetch, chases the page table once per tile (each
// token's row offset into the tile's state slot, before its 16-byte
// cp.async copies are issued), and stops at the row's length (the TPU kernel
// fetches and masks the padded pages, which are exact no-ops): a split past
// it writes an empty partial, and tokens past the table width are never
// read.
//
// The two bodies are one template over the page loader. Quantized pages
// read their (page, g) scales once per tile beside the offsets (the TPU
// kernel's scalar prefetch), keep the codes in shared memory, and widen
// each as float(code) * scale before the same f32 op sequence: with f32 q
// the quantized kernel equals the model-dtype kernel run on page_dequant-ed
// pages bitwise.
#include "flash_decode.cuh"

using rap_decode::kThreads;
using rap_decode::kTile;

// Loader of rap_decode::attend over row b's pages of kv head g; every token
// up to the row's length is attended.
template <typename P, bool kQuant>
struct PagedLoader {
  using E = P;
  static constexpr bool kScaled = kQuant;
  const P* kp;
  const P* vp;
  const float* ks;
  const float* vs;
  const int* table_row;   // [max_pages]
  long long tok_stride;   // K * D
  int pt, K, g, D;
  long long* off_s;       // [2][kTile] element offset of each token's head g
  float* ks_s;            // [2][kTile] K scale per token (quant)
  float* vs_s;            // [2][kTile] V scale per token (quant)

  __device__ void state(int st, int t0, int nt, int tid) {
    for (int j = tid; j < nt; j += kThreads) {
      const int t = t0 + j;
      const long long page = table_row[t / pt];
      off_s[st * kTile + j] =
          (page * pt + t % pt) * tok_stride + (long long)g * D;
      if constexpr (kQuant) {
        ks_s[st * kTile + j] = ks[page * K + g];
        vs_s[st * kTile + j] = vs[page * K + g];
      }
    }
  }
  __device__ const P* krow(int st, int, int j) const {
    return kp + off_s[st * kTile + j];
  }
  __device__ const P* vrow(int st, int, int j) const {
    return vp + off_s[st * kTile + j];
  }
  __device__ bool valid(int, int) const { return true; }
  __device__ float kscale(int st, int j) const {
    return kQuant ? ks_s[st * kTile + j] : 1.f;
  }
  __device__ float vscale(int st, int j) const {
    return kQuant ? vs_s[st * kTile + j] : 1.f;
  }
};

// offsets of both slots, then (quant) K and V scales of both slots
constexpr int kState = 2 * kTile * 8 + 4 * kTile * 4;

// T: q/out dtype; P: page dtype; kQuant: pages carry [n_pages, K] scales.
template <typename T, typename P, bool kQuant, int HB>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                    const P* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, int H, int K, int D,
                    int pt, int max_pages, int split_tokens, float scale,
                    float softcap, int stages, int vec,
                    rap_decode::Partials part, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* off_s = reinterpret_cast<long long*>(smem);      // [2][kTile]
  float* ks_s = reinterpret_cast<float*>(off_s + 2 * kTile);  // [2][kTile]
  float* vs_s = ks_s + 2 * kTile;                             // [2][kTile]
  const int G = H / K;
  const int b = blockIdx.x, g = blockIdx.y, sp = blockIdx.z;
  const int bk = b * K + g;
  // tokens past the table width are never attended (as on the TPU, whose
  // grid covers max_pages pages)
  const int len = min(lengths[b], max_pages * pt);
  const int s0 = sp * split_tokens, s1 = min(len, s0 + split_tokens);
  const rap_decode::Sink<T> o = rap_decode::sink(out, part, bk, sp);
  if (s1 > s0) {
    PagedLoader<P, kQuant> ld{kp, vp, ks, vs,
                              table + (long long)b * max_pages,
                              (long long)K * D, pt, K, g, D, off_s, ks_s,
                              vs_s};
    rap_decode::attend<T, HB>(q + (long long)bk * G * D, o, G, D, s0, s1,
                              scale, softcap, ld, stages, vec != 0,
                              smem + rap_decode::align16(kState));
  } else {
    rap_decode::write_empty(o, G, D);
  }
}

template <typename T, typename P, bool kQuant, int HB>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* table,
                  const void* lengths, void* out, void* part, int B, int H,
                  int K, int D, int pt, int max_pages,
                  int split_tokens, int nsplit, float scale, float softcap,
                  cudaStream_t s) {
  const int G = H / K;
  const int stages = rap_decode::stages_for(G, D, sizeof(P), kState);
  const size_t smem = rap_decode::smem_bytes(G, D, sizeof(P), kState, stages);
  const int vec = rap_decode::vec_rows<P>(D, kp, vp);
  return rap_decode::launch_split<T>(
      paged_decode_kernel<T, P, kQuant, HB>, smem, B, K, G, D, nsplit,
      (float*)part, (T*)out, nullptr, s, (const T*)q, (const P*)kp, (const P*)vp,
      (const float*)ks, (const float*)vs, (const int*)table,
      (const int*)lengths, H, K, D, pt, max_pages, split_tokens, scale,
      softcap, stages, vec);
}

// The group width HB of the loop: 4 query heads a work item where G allows.
template <typename T, typename P, bool kQuant>
static int launch_hb(const void* q, const void* kp, const void* vp,
                     const void* ks, const void* vs, const void* table,
                     const void* lengths, void* out, void* part, int B,
                     int H, int K, int D, int pt, int max_pages,
                     int split_tokens, int nsplit,
                     float scale, float softcap, cudaStream_t s) {
  if (B == 0) return 0;
  if (split_tokens <= 0 || split_tokens % kTile ||
      (long long)nsplit * split_tokens < (long long)max_pages * pt)
    return (int)cudaErrorInvalidValue;
  if ((H / K) % 4 == 0)
    return launch<T, P, kQuant, 4>(q, kp, vp, ks, vs, table, lengths, out,
                                   part, B, H, K, D, pt, max_pages,
                                   split_tokens, nsplit, scale, softcap, s);
  return launch<T, P, kQuant, 1>(q, kp, vp, ks, vs, table, lengths, out,
                                 part, B, H, K, D, pt, max_pages,
                                 split_tokens, nsplit, scale, softcap, s);
}

// q [B,1,H,D]; k/v pages [n_pages, pt, K, D]; table int32 [B, max_pages];
// lengths int32 [B]; out [B,1,H,D]. All contiguous, one dtype. Each row's
// max_pages * pt token slots are cut into nsplit splits of split_tokens (a
// multiple of 64); part as for rap_decode_attention.
extern "C" int rap_paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* table,
    const void* lengths, void* out, void* part, int B, int H,
    int K, int D, int pt, int max_pages, int split_tokens, int nsplit,
    float scale, float softcap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    return launch_hb<T, T, false>(q, kp, vp, nullptr, nullptr, table,
                                  lengths, out, part, B, H, K, D, pt,
                                  max_pages, split_tokens, nsplit, scale,
                                  softcap, s);
  });
  return 0;
}

// As above with int8 (page_dtype 0) or float8_e4m3fn (page_dtype 1) pages
// and f32 scales k/v_scales [n_pages, K]; q and out in `dtype`.
extern "C" int rap_paged_decode_attention_quant(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* lengths, void* out,
    void* part, int B, int H, int K, int D, int pt,
    int max_pages, int split_tokens, int nsplit, float scale, float softcap,
    int dtype, int page_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    switch (page_dtype) {
      case 0:
        return launch_hb<T, int8_t, true>(
            q, kp, vp, ks, vs, table, lengths, out, part, B, H, K,
            D, pt, max_pages, split_tokens, nsplit, scale, softcap, s);
      case 1:
        return launch_hb<T, __nv_fp8_e4m3, true>(
            q, kp, vp, ks, vs, table, lengths, out, part, B, H, K,
            D, pt, max_pages, split_tokens, nsplit, scale, softcap, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return 0;
}
