// Flash-decode: one query token per row against a contiguous KV cache.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention. q [B,1,H,D];
// k, v [B,S,K,D]; valid [S] (one mask for every row, JAX's signature: read
// with row stride 0) or [B,S] (one mask per row: the slot cache, where each
// row sits at its own position); scale 1/sqrt(D) and an optional tanh
// softcap. Query head h reads kv head h / (H / K).
//
// Bound on the H100 by memory (4 flops per K/V element pair against 2 bytes
// each in bf16). Design: the split-KV loop of flash_decode.cuh, one CTA per
// (row b, kv head g, split of split_tokens), each K/V element fetched once
// for the G query heads of kv head g; the TPU kernel's sequential kv-block
// axis becomes the splits and, inside one, the loop over 64-token tiles.
// Two bodies, as the wrapper's static plan names them
// (kernels/decode_attention.py::plan): bf16 / fp16 the tensor-core body
// (TMA ring from a producer warp, wgmma with the tile as M), f32 the FMA
// body. K and V come with their batch, sequence and head strides (element
// units, each row of D contiguous), so a sequence block or a batch slice
// of a cache is read in place.
//
// A CTA reads only its own split's mask bytes and walks up to the last
// valid one, so the unwritten tail of a slot cache is not read (the
// tensor-core body's 16-token boxes may reach 15 tokens past it: their V
// rows are zeroed and their probabilities are 0) and a split past the
// row's end writes an empty partial; masked tokens inside (a ring buffer's
// stale slots) get probability exactly 0. With f32 q and a
// prefix mask valid[b, t] = t < len[b] this kernel equals the paged kernel
// bitwise on pages holding the same tokens in order.
#include "flash_decode.cuh"

using rap_decode::kThreads;
using rap_decode::kTile;

// Loader of the FMA body over row b's cache of kv head g: token t's element
// d lives at base[t * seq_stride + d]; state is the tile's mask bytes.
template <typename T>
struct DenseLoader {
  using E = T;
  static constexpr bool kScaled = false;
  const T* kb;            // &k[b, 0, g, 0]
  const T* vb;            // &v[b, 0, g, 0]
  const uint8_t* mask;    // valid row b
  long long tok_stride;   // the sequence stride
  uint8_t* vld_s;         // [2][kTile] valid flags of a tile

  __device__ void state(int st, int t0, int nt, int tid) {
    for (int j = tid; j < nt; j += kThreads)
      vld_s[st * kTile + j] = mask[t0 + j];
  }
  __device__ const T* krow(int, int t0, int j) const {
    return kb + (long long)(t0 + j) * tok_stride;
  }
  __device__ const T* vrow(int, int t0, int j) const {
    return vb + (long long)(t0 + j) * tok_stride;
  }
  __device__ bool valid(int st, int j) const {
    return vld_s[st * kTile + j] != 0;
  }
  __device__ float kscale(int, int) const { return 1.f; }
  __device__ float vscale(int, int) const { return 1.f; }
};

// Source of the tensor-core body: boxes of 16 tokens x 64 columns of the
// cache's tensor map (dims D, K, S, B), the tile's mask bytes beside them.
struct DenseSource {
  static constexpr bool kCodes = false;
  using C = int8_t;     // no codes
  const uint8_t* mask;  // valid row b
  int b, g, nbx;        // nbx: 64-column boxes of a row
  int rows;             // unused (no scales)

  __device__ void produce(const CUtensorMap* tk, const CUtensorMap* tv,
                          uint64_t* full, unsigned char* kd,
                          unsigned char* vd, uint8_t* vld, float*, int t0,
                          int nt, int lane) const {
    // the boxes first, then the flags; each lane arrives after its own
    // writes, lane 0 with the boxes' bytes (a transaction count may run
    // below zero until then: the phase waits on the arrivals too)
    const int nbox = (nt + 15) / 16;
    if (lane < nbox * nbx) {
      const int i = lane % nbox, x = lane / nbox;
      hopper::tma_load_4d(kd + x * 8192 + i * 2048, tk, full, x * 64, g,
                          t0 + 16 * i, b);
      hopper::tma_load_4d(vd + x * 8192 + i * 2048, tv, full, x * 64, g,
                          t0 + 16 * i, b);
    }
    for (int j = lane; j < kTile; j += 32) vld[j] = j < nt ? mask[t0 + j] : 0;
    if (lane == 0)
      hopper::mbar_expect_tx(full, 2 * nbox * nbx * 2048);
    else
      hopper::mbar_arrive(full);
  }
  __device__ bool valid(const uint8_t* vld, int j, int) const {
    return vld[j] != 0;
  }
};

constexpr int kState = 2 * kTile + 16;   // flags of both slots, hi

// one past the last valid token of [s0, s1) in mask row vr, by every thread
__device__ __forceinline__ int last_valid(const uint8_t* vr, int s0, int s1,
                                          int* hi_s) {
  int hi = 0;
  for (int t = s0 + threadIdx.x; t < s1; t += blockDim.x)
    if (vr[t]) hi = t + 1;
  if (threadIdx.x == 0) *hi_s = 0;
  __syncthreads();
  if (hi > 0) atomicMax(hi_s, hi);
  __syncthreads();
  return *hi_s;
}

template <typename T, typename O, int HB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              long long valid_stride, int H, int K, int D, int S,
              long long sb, long long ss, long long sh, int split_tokens,
              float scale, float softcap, int vec, rap_decode::Partials pt,
              O* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* vld_s = smem;                                    // [2][kTile]
  int* hi_s = reinterpret_cast<int*>(smem + 2 * kTile);     // [1]
  const int G = H / K;
  const int b = blockIdx.x, g = blockIdx.y, sp = blockIdx.z;
  const int bk = b * K + g;
  const uint8_t* vr = valid + (long long)b * valid_stride;
  const int s0 = sp * split_tokens, s1 = min(S, s0 + split_tokens);
  // one past the split's last valid token: the walk stops there
  const int hi = last_valid(vr, s0, s1, hi_s);
  const rap_decode::Sink<O> o = rap_decode::sink(out, pt, bk, sp);
  if (hi > s0) {
    const long long kv0 = (long long)b * sb + (long long)g * sh;
    DenseLoader<T> ld{k + kv0, v + kv0, vr, ss, vld_s};
    rap_decode::attend<T, HB>(q + (long long)bk * G * D, o, G, D, s0, hi,
                              scale, softcap, ld, vec != 0,
                              smem + rap_decode::align16(kState));
  } else {
    rap_decode::write_empty(o, G, D);
  }
}

template <typename T, typename O, int DT, int N>
__global__ void __launch_bounds__(rap_decode::tc::kThreads)
decode_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const T* __restrict__ q, const uint8_t* __restrict__ valid,
                 long long valid_stride, int H, int K, int D, int S,
                 int split_tokens, float scale, float softcap, int stages,
                 rap_decode::Partials pt, O* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int hi_s;
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int G = H / K;
  const int b = blockIdx.x, g = blockIdx.y, sp = blockIdx.z;
  const int bk = b * K + g;
  const uint8_t* vr = valid + (long long)b * valid_stride;
  const int s0 = sp * split_tokens, s1 = min(S, s0 + split_tokens);
  const int hi = last_valid(vr, s0, s1, &hi_s);
  const rap_decode::Sink<O> o = rap_decode::sink(out, pt, bk, sp);
  if (hi > s0) {
    const DenseSource src{vr, b, g, DT / 64, 16};
    rap_decode::tc::attend<T, DT, N>(&tm_k, &tm_v, q + (long long)bk * G * D,
                                     o, G, D, s0, hi, scale, softcap, stages,
                                     src, smem);
  } else if (threadIdx.x < kThreads) {
    rap_decode::write_empty(o, G, D);
  }
}

// strides in elements; k and v share them
struct Strides {
  long long b, s, h;
};

// A tensor-core launch's arguments. The tensor-core instantiations are
// compiled apart, one object for each head-width tile D_T
// (kernels/build.py compiles this file once more for each with
// -DRAP_TC_DT=64, 128 or 256; the object without it holds the FMA body and
// the entry point), so that nvcc builds them side by side.
struct DenseTcCall {
  const void *q, *k, *v, *valid;
  long long valid_stride;
  void *out, *part, *lse;
  int B, H, K, D, S;
  Strides st;
  int split_tokens, nsplit;
  float scale, softcap;
  int stages;
  cudaStream_t s;
};

// the tensor-core body at D_T = DT for n = 8 or 16 heads (any other n:
// refused); defined in the object of RAP_TC_DT = DT
template <typename T, typename O, int DT>
int dense_tc_width(const DenseTcCall& c, int n);

#ifdef RAP_TC_DT

template <typename T, typename O, int DT, int N>
static int launch_tc(const DenseTcCall& c) {
  const int G = c.H / c.K;
  constexpr int dt = std::is_same<T, __nv_bfloat16>::value ? 0 : 1;
  CUtensorMap tk, tv;
  const long long dims[4] = {c.D, c.K, c.S > 0 ? c.S : 1, c.B};
  const long long bytes[3] = {c.st.h * 2, c.st.s * 2, c.st.b * 2};
  const int box[4] = {64, 1, 16, 1};
  int e = hopper::encode_strided(&tk, c.k, dt, dims, bytes, box, true);
  if (e == 0)
    e = hopper::encode_strided(&tv, c.v, dt, dims, bytes, box, true);
  if (e != 0) return e;
  auto kern = decode_tc_kernel<T, O, DT, N>;
  const size_t smem =
      rap_decode::tc::layout(DT, N, c.stages, false, c.D).total;
  return rap_decode::launch_split<O>(
      kern, rap_decode::tc::kThreads, smem, c.B, c.K, G, c.D, c.nsplit,
      (float*)c.part, (O*)c.out, (float*)c.lse, c.s, tk, tv, (const T*)c.q,
      (const uint8_t*)c.valid, c.valid_stride, c.H, c.K, c.D, c.S,
      c.split_tokens, c.scale, c.softcap, c.stages);
}

template <typename T, typename O, int DT>
int dense_tc_width(const DenseTcCall& c, int n) {
  if (n == 8) return launch_tc<T, O, DT, 8>(c);
  if (n == 16) return launch_tc<T, O, DT, 16>(c);
  return (int)cudaErrorInvalidValue;
}

template int dense_tc_width<__nv_bfloat16, __nv_bfloat16, RAP_TC_DT>(
    const DenseTcCall&, int);
template int dense_tc_width<__nv_bfloat16, float, RAP_TC_DT>(
    const DenseTcCall&, int);
template int dense_tc_width<__half, __half, RAP_TC_DT>(const DenseTcCall&,
                                                       int);
template int dense_tc_width<__half, float, RAP_TC_DT>(const DenseTcCall&,
                                                      int);

#else

template <typename T, typename O, int HB>
static int launch_fma(const void* q, const void* k, const void* v,
                      const void* valid, long long valid_stride, void* out,
                      void* part, void* lse, int B, int H, int K, int D,
                      int S, Strides st, int split_tokens, int nsplit,
                      float scale, float softcap, cudaStream_t s) {
  const int G = H / K;
  const size_t smem = rap_decode::smem_bytes(G, D, sizeof(T), kState);
  const int vec = rap_decode::vec_rows<T>(D, k, v, st.b | st.s | st.h);
  return rap_decode::launch_split<O>(
      decode_kernel<T, O, HB>, kThreads, smem, B, K, G, D, nsplit,
      (float*)part, (O*)out, (float*)lse, s, (const T*)q, (const T*)k,
      (const T*)v, (const uint8_t*)valid, valid_stride, H, K, D, S, st.b,
      st.s, st.h, split_tokens, scale, softcap, vec);
}

// the tensor-core instantiation of a head width and group: D_T = D rounded
// up to 64, 128 or 256 columns, N = G rounded up to 8 or 16 heads
template <typename T, typename O>
static int launch_tc_planned(const DenseTcCall& c) {
  const int G = c.H / c.K;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(c.q) |
                         reinterpret_cast<uintptr_t>(c.k) |
                         reinterpret_cast<uintptr_t>(c.v);
  if (c.D % 8 || c.D > 256 || G > 16 || (ptrs & 15) || c.stages < 1 ||
      ((c.st.b | c.st.s | c.st.h) * 2) % 16)
    return (int)cudaErrorInvalidValue;
  const int n = G <= 8 ? 8 : 16;
  if (c.D <= 64) return dense_tc_width<T, O, 64>(c, n);
  if (c.D <= 128) return dense_tc_width<T, O, 128>(c, n);
  return dense_tc_width<T, O, 256>(c, n);
}

template <typename T, typename O>
static int launch_body(const void* q, const void* k, const void* v,
                       const void* valid, long long valid_stride, void* out,
                       void* part, void* lse, int B, int H, int K, int D,
                       int S, Strides st, int split_tokens, int nsplit,
                       float scale, float softcap, int body, int stages,
                       cudaStream_t s) {
  const int G = H / K;
  if (body == 1) {
    if constexpr (std::is_same<T, float>::value) {
      return (int)cudaErrorInvalidValue;   // f32 has no tensor-core body
    } else {
      const DenseTcCall c{q, k, v, valid, valid_stride, out, part, lse,
                          B, H, K, D, S, st, split_tokens, nsplit, scale,
                          softcap, stages, s};
      return launch_tc_planned<T, O>(c);
    }
  }
  if (body != 0 || stages != 1) return (int)cudaErrorInvalidValue;
  return G % 4 == 0
      ? launch_fma<T, O, 4>(q, k, v, valid, valid_stride, out, part, lse, B,
                            H, K, D, S, st, split_tokens, nsplit, scale,
                            softcap, s)
      : launch_fma<T, O, 1>(q, k, v, valid, valid_stride, out, part, lse, B,
                            H, K, D, S, st, split_tokens, nsplit, scale,
                            softcap, s);
}

// q [B,1,H,D] contiguous; k/v [B,S,K,D] at element strides sb, ss, sh
// (each row of D contiguous; k and v alike); valid uint8 (bool) rows of S
// at stride valid_stride (0: one row for all); out [B,1,H,D] contiguous.
// q, k, v and out in one dtype. Row tokens are cut into nsplit splits of
// split_tokens (a multiple of 64); with nsplit > 1, part holds the f32
// partials (B*K*nsplit*G*(D+2) floats). lse: f32 [B, H], each row and
// head's log-sum-exp (-inf where no token is valid), or null for none.
// out_f32: out is f32 (unrounded) whatever q's dtype. body: 0 the FMA body
// (stages 1), 1 the tensor-core body (bf16/fp16, D % 8 == 0, G <= 16,
// 16-byte aligned bases and strides; `stages` ring stages), as
// kernels/decode_attention.py::plan names them; anything else is refused,
// never sent to another body.
extern "C" int rap_decode_attention(const void* q, const void* k,
                                    const void* v, const void* valid,
                                    long long valid_stride, void* out,
                                    void* part, void* lse, int out_f32,
                                    int B, int H, int K, int D, int S,
                                    long long sb, long long ss, long long sh,
                                    int split_tokens, int nsplit,
                                    float scale, float softcap, int dtype,
                                    int body, int stages, void* stream) {
  if (B == 0) return 0;
  if (split_tokens <= 0 || split_tokens % kTile ||
      (long long)nsplit * split_tokens < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Strides st{sb, ss, sh};
  RAP_DISPATCH(dtype, T, {
    if (out_f32)
      return launch_body<T, float>(q, k, v, valid, valid_stride, out, part,
                                   lse, B, H, K, D, S, st, split_tokens,
                                   nsplit, scale, softcap, body, stages, s);
    return launch_body<T, T>(q, k, v, valid, valid_stride, out, part, lse, B,
                             H, K, D, S, st, split_tokens, nsplit, scale,
                             softcap, body, stages, s);
  });
  return 0;
}

#endif  // RAP_TC_DT
