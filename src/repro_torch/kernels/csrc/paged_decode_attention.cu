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
// Two bodies, as the wrapper's static plan names them
// (kernels/decode_attention.py::plan): bf16 / fp16 q runs the tensor-core
// body of flash_decode.cuh (TMA boxes of R = gcd(pt, 64) tokens at each
// page's coordinate in a tensor map over the pool [n_pages, pt, K, D],
// one box per page run of a tile and none past the row's length; wgmma
// with the tile as M; codes widened in shared memory, the K scale on the
// score and the V scale on the probability), f32 q the FMA body.
//
// The quantized and model-dtype pages are one template over the page
// loader. Quantized pages
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

// Source of the tensor-core body: a tile's tokens in boxes of `rows` tokens
// (a divisor of pt and of 64), each inside one page, at (column, g, slot in
// the page, page) of the pool's tensor map; bf16 / fp16 pages in 64-column
// swizzled boxes, codes in one plain box of D bytes a token with the
// (page, g) scales beside them.
template <typename P, bool kQuant>
struct PagedSource {
  static constexpr bool kCodes = kQuant;
  using C = P;
  const int* table_row;   // [max_pages]
  const float* ks;        // [n_pages, K] (quant)
  const float* vs;
  int pt, K, g, D, nbx;   // nbx: 64-column boxes of a row (T pages)
  int rows;

  __device__ void produce(const CUtensorMap* tk, const CUtensorMap* tv,
                          uint64_t* full, unsigned char* kd,
                          unsigned char* vd, uint8_t*, float* scl, int t0,
                          int nt, int lane) const {
    // lane i loads box i (its page from the table), then its scales; each
    // lane arrives after its own writes, lane 0 with the boxes' bytes (a
    // transaction count may run below zero until then: the phase waits on
    // the arrivals too)
    const int nbox = (nt + rows - 1) / rows;   // <= kMaxBoxes
    if (lane < nbox) {
      const int t = t0 + lane * rows;
      const int page = table_row[t / pt], slot = t % pt;
      if constexpr (kQuant) {
        hopper::tma_load_4d(kd + lane * rows * D, tk, full, 0, g, slot, page);
        hopper::tma_load_4d(vd + lane * rows * D, tv, full, 0, g, slot, page);
        scl[lane] = ks[(long long)page * K + g];
        scl[rap_decode::tc::kMaxBoxes + lane] = vs[(long long)page * K + g];
      } else {
        for (int x = 0; x < nbx; ++x) {
          hopper::tma_load_4d(kd + x * 8192 + lane * rows * 128, tk, full,
                              x * 64, g, slot, page);
          hopper::tma_load_4d(vd + x * 8192 + lane * rows * 128, tv, full,
                              x * 64, g, slot, page);
        }
      }
    }
    if (lane == 0)
      hopper::mbar_expect_tx(full, kQuant ? 2 * nbox * rows * D
                                          : 2 * nbox * nbx * rows * 128);
    else
      hopper::mbar_arrive(full);
  }
  __device__ bool valid(const uint8_t*, int j, int nt) const { return j < nt; }
};

// T: q/out dtype; P: page dtype; kQuant: pages carry [n_pages, K] scales.
template <typename T, typename P, bool kQuant, int HB>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                    const P* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, int H, int K, int D,
                    int pt, int max_pages, int split_tokens, float scale,
                    float softcap, int vec, rap_decode::Partials part,
                    T* __restrict__ out) {
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
                              scale, softcap, ld, vec != 0,
                              smem + rap_decode::align16(kState));
  } else {
    rap_decode::write_empty(o, G, D);
  }
}

template <typename T, typename P, bool kQuant, int DT, int N>
__global__ void __launch_bounds__(rap_decode::tc::kThreads)
paged_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const T* __restrict__ q, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ table,
                const int* __restrict__ lengths, int H, int K, int D, int pt,
                int max_pages, int split_tokens, float scale, float softcap,
                int stages, rap_decode::Partials part, T* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int G = H / K;
  const int b = blockIdx.x, g = blockIdx.y, sp = blockIdx.z;
  const int bk = b * K + g;
  const int len = min(lengths[b], max_pages * pt);
  const int s0 = sp * split_tokens, s1 = min(len, s0 + split_tokens);
  const rap_decode::Sink<T> o = rap_decode::sink(out, part, bk, sp);
  if (s1 > s0) {
    int rows = 64;
    while (pt % rows) rows >>= 1;   // gcd(pt, 64): pt % 8 == 0 here
    const PagedSource<P, kQuant> src{table + (long long)b * max_pages,
                                     ks, vs, pt, K, g, D, DT / 64, rows};
    rap_decode::tc::attend<T, DT, N>(&tm_k, &tm_v, q + (long long)bk * G * D,
                                     o, G, D, s0, s1, scale, softcap, stages,
                                     src, smem);
  } else if (threadIdx.x < kThreads) {
    rap_decode::write_empty(o, G, D);
  }
}

// A tensor-core launch's arguments. The tensor-core instantiations are
// compiled apart, one object for each head-width tile D_T
// (kernels/build.py compiles this file once more for each with
// -DRAP_TC_DT=64, 128 or 256; the object without it holds the FMA body and
// the entry points), so that nvcc builds them side by side.
struct PagedTcCall {
  const void *q, *kp, *vp, *ks, *vs, *table, *lengths;
  void *out, *part;
  int B, H, K, D, pt, max_pages, n_pages, split_tokens, nsplit;
  float scale, softcap;
  int stages;
  cudaStream_t s;
};

// the tensor-core body at D_T = DT for n = 8 or 16 heads (any other n:
// refused); defined in the object of RAP_TC_DT = DT
template <typename T, typename P, bool kQuant, int DT>
int paged_tc_width(const PagedTcCall& c, int n);

#ifdef RAP_TC_DT

template <typename T, typename P, bool kQuant, int DT, int N>
static int launch_tc(const PagedTcCall& c) {
  const int G = c.H / c.K;
  int rows = 64;
  while (c.pt % rows) rows >>= 1;
  const int dt = kQuant ? 2 : std::is_same<P, __nv_bfloat16>::value ? 0 : 1;
  const long long es = kQuant ? 1 : 2;
  CUtensorMap tk, tv;
  const long long dims[4] = {c.D, c.K, c.pt, c.n_pages};
  const long long bytes[3] = {c.D * es, (long long)c.K * c.D * es,
                              (long long)c.pt * c.K * c.D * es};
  const int box[4] = {kQuant ? c.D : 64, 1, rows, 1};
  int e = hopper::encode_strided(&tk, c.kp, dt, dims, bytes, box, !kQuant);
  if (e == 0)
    e = hopper::encode_strided(&tv, c.vp, dt, dims, bytes, box, !kQuant);
  if (e != 0) return e;
  auto kern = paged_tc_kernel<T, P, kQuant, DT, N>;
  const size_t smem =
      rap_decode::tc::layout(DT, N, c.stages, kQuant, c.D).total;
  return rap_decode::launch_split<T>(
      kern, rap_decode::tc::kThreads, smem, c.B, c.K, G, c.D, c.nsplit,
      (float*)c.part, (T*)c.out, nullptr, c.s, tk, tv, (const T*)c.q,
      (const float*)c.ks, (const float*)c.vs, (const int*)c.table,
      (const int*)c.lengths, c.H, c.K, c.D, c.pt, c.max_pages,
      c.split_tokens, c.scale, c.softcap, c.stages);
}

template <typename T, typename P, bool kQuant, int DT>
int paged_tc_width(const PagedTcCall& c, int n) {
  if (n == 8) return launch_tc<T, P, kQuant, DT, 8>(c);
  if (n == 16) return launch_tc<T, P, kQuant, DT, 16>(c);
  return (int)cudaErrorInvalidValue;
}

#define RAP_PAGED_TC_OF(T)                                                  \
  template int paged_tc_width<T, T, false, RAP_TC_DT>(const PagedTcCall&,   \
                                                      int);                 \
  template int paged_tc_width<T, int8_t, true, RAP_TC_DT>(                  \
      const PagedTcCall&, int);                                             \
  template int paged_tc_width<T, __nv_fp8_e4m3, true, RAP_TC_DT>(           \
      const PagedTcCall&, int);
RAP_PAGED_TC_OF(__nv_bfloat16)
RAP_PAGED_TC_OF(__half)
#undef RAP_PAGED_TC_OF

#else

template <typename T, typename P, bool kQuant, int HB>
static int launch_fma(const void* q, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* table,
                      const void* lengths, void* out, void* part, int B,
                      int H, int K, int D, int pt, int max_pages,
                      int split_tokens, int nsplit, float scale,
                      float softcap, cudaStream_t s) {
  const int G = H / K;
  const size_t smem = rap_decode::smem_bytes(G, D, sizeof(P), kState);
  const int vec = rap_decode::vec_rows<P>(D, kp, vp, (long long)K * D);
  return rap_decode::launch_split<T>(
      paged_decode_kernel<T, P, kQuant, HB>, kThreads, smem, B, K, G, D,
      nsplit, (float*)part, (T*)out, nullptr, s, (const T*)q, (const P*)kp,
      (const P*)vp, (const float*)ks, (const float*)vs, (const int*)table,
      (const int*)lengths, H, K, D, pt, max_pages, split_tokens, scale,
      softcap, vec);
}

// The body the plan names: 0 the FMA body (stages 1; HB = 4 query heads a
// work item where G allows), 1 the tensor-core body (T bf16/fp16; D % 8 ==
// 0, and D % 16 == 0 for codes; pt % 8 == 0; G <= 16; 16-byte aligned
// bases; D_T = D rounded up to 64, 128 or 256, N = G rounded up to 8 or
// 16). Anything else is refused, never sent to another body.
template <typename T, typename P, bool kQuant>
static int launch_body(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* table,
                       const void* lengths, void* out, void* part, int B,
                       int H, int K, int D, int pt, int max_pages,
                       int n_pages, int split_tokens, int nsplit,
                       float scale, float softcap, int body, int stages,
                       cudaStream_t s) {
  if (B == 0) return 0;
  if (split_tokens <= 0 || split_tokens % kTile ||
      (long long)nsplit * split_tokens < (long long)max_pages * pt)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  if (body == 1) {
    if constexpr (std::is_same<T, float>::value) {
      return (int)cudaErrorInvalidValue;
    } else {
      const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                             reinterpret_cast<uintptr_t>(kp) |
                             reinterpret_cast<uintptr_t>(vp);
      if (D % (kQuant ? 16 : 8) || D > 256 || G > 16 || pt % 8 ||
          (ptrs & 15) || stages < 1 || n_pages < 1)
        return (int)cudaErrorInvalidValue;
      const PagedTcCall c{q, kp, vp, ks, vs, table, lengths, out, part,
                          B, H, K, D, pt, max_pages, n_pages, split_tokens,
                          nsplit, scale, softcap, stages, s};
      const int n = G <= 8 ? 8 : 16;
      if (D <= 64) return paged_tc_width<T, P, kQuant, 64>(c, n);
      if (D <= 128) return paged_tc_width<T, P, kQuant, 128>(c, n);
      return paged_tc_width<T, P, kQuant, 256>(c, n);
    }
  }
  if (body != 0 || stages != 1) return (int)cudaErrorInvalidValue;
  if (G % 4 == 0)
    return launch_fma<T, P, kQuant, 4>(q, kp, vp, ks, vs, table, lengths,
                                       out, part, B, H, K, D, pt, max_pages,
                                       split_tokens, nsplit, scale, softcap,
                                       s);
  return launch_fma<T, P, kQuant, 1>(q, kp, vp, ks, vs, table, lengths, out,
                                     part, B, H, K, D, pt, max_pages,
                                     split_tokens, nsplit, scale, softcap, s);
}

// q [B,1,H,D]; k/v pages [n_pages, pt, K, D]; table int32 [B, max_pages];
// lengths int32 [B]; out [B,1,H,D]. All contiguous, one dtype. Each row's
// max_pages * pt token slots are cut into nsplit splits of split_tokens (a
// multiple of 64); part as for rap_decode_attention; body and stages as
// kernels/decode_attention.py::plan names them.
extern "C" int rap_paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* table,
    const void* lengths, void* out, void* part, int B, int H,
    int K, int D, int pt, int max_pages, int n_pages, int split_tokens,
    int nsplit, float scale, float softcap, int dtype, int body, int stages,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    return launch_body<T, T, false>(q, kp, vp, nullptr, nullptr, table,
                                    lengths, out, part, B, H, K, D, pt,
                                    max_pages, n_pages, split_tokens, nsplit,
                                    scale, softcap, body, stages, s);
  });
  return 0;
}

// As above with int8 (page_dtype 0) or float8_e4m3fn (page_dtype 1) pages
// and f32 scales k/v_scales [n_pages, K]; q and out in `dtype`.
extern "C" int rap_paged_decode_attention_quant(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* lengths, void* out,
    void* part, int B, int H, int K, int D, int pt, int max_pages,
    int n_pages, int split_tokens, int nsplit, float scale, float softcap,
    int dtype, int page_dtype, int body, int stages, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    switch (page_dtype) {
      case 0:
        return launch_body<T, int8_t, true>(
            q, kp, vp, ks, vs, table, lengths, out, part, B, H, K, D, pt,
            max_pages, n_pages, split_tokens, nsplit, scale, softcap, body,
            stages, s);
      case 1:
        return launch_body<T, __nv_fp8_e4m3, true>(
            q, kp, vp, ks, vs, table, lengths, out, part, B, H, K, D, pt,
            max_pages, n_pages, split_tokens, nsplit, scale, softcap, body,
            stages, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return 0;
}

#endif  // RAP_TC_DT
