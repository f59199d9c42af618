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
// A CTA reads only its own split's mask bytes and walks up to the last
// valid one, so the unwritten tail of a slot cache is never read and a
// split past the row's end writes an empty partial; masked tokens inside (a
// ring buffer's stale slots) get probability exactly 0. With f32 q and a
// prefix mask valid[b, t] = t < len[b] this kernel equals the paged kernel
// bitwise on pages holding the same tokens in order.
#include "flash_decode.cuh"

using rap_decode::kThreads;
using rap_decode::kTile;

// Loader of rap_decode::attend over row b's contiguous cache of kv head g:
// token t's element d lives at base[t * K * D + d]; state is the tile's
// mask bytes.
template <typename T>
struct DenseLoader {
  using E = T;
  static constexpr bool kScaled = false;
  const T* kb;            // &k[b, 0, g, 0]
  const T* vb;            // &v[b, 0, g, 0]
  const uint8_t* mask;    // valid row b
  long long tok_stride;   // K * D
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

constexpr int kState = 2 * kTile + 16;   // flags of both slots, hi

template <typename T, typename O, int HB>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              long long valid_stride, int H, int K, int D, int S,
              int split_tokens, float scale, float softcap, int stages,
              int vec, rap_decode::Partials pt, O* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* vld_s = smem;                                    // [2][kTile]
  int* hi_s = reinterpret_cast<int*>(smem + 2 * kTile);     // [1]
  const int G = H / K;
  const int b = blockIdx.x, g = blockIdx.y, sp = blockIdx.z;
  const int bk = b * K + g;
  const uint8_t* vr = valid + (long long)b * valid_stride;
  const int s0 = sp * split_tokens, s1 = min(S, s0 + split_tokens);
  // one past the split's last valid token: the walk stops there
  int hi = 0;
  for (int t = s0 + threadIdx.x; t < s1; t += kThreads)
    if (vr[t]) hi = t + 1;
  if (threadIdx.x == 0) *hi_s = 0;
  __syncthreads();
  if (hi > 0) atomicMax(hi_s, hi);
  __syncthreads();
  hi = *hi_s;
  const rap_decode::Sink<O> o = rap_decode::sink(out, pt, bk, sp);
  if (hi > s0) {
    const long long tok_stride = (long long)K * D;
    const long long kv0 = (long long)b * S * tok_stride + (long long)g * D;
    DenseLoader<T> ld{k + kv0, v + kv0, vr, tok_stride, vld_s};
    rap_decode::attend<T, HB>(q + (long long)bk * G * D, o, G, D, s0, hi,
                              scale, softcap, ld, stages, vec != 0,
                              smem + rap_decode::align16(kState));
  } else {
    rap_decode::write_empty(o, G, D);
  }
}

template <typename T, typename O, int HB>
static int launch(const void* q, const void* k, const void* v,
                  const void* valid, long long valid_stride, void* out,
                  void* part, void* lse, int B, int H, int K, int D, int S,
                  int split_tokens, int nsplit, float scale, float softcap,
                  cudaStream_t s) {
  const int G = H / K;
  const int stages = rap_decode::stages_for(G, D, sizeof(T), kState);
  const size_t smem = rap_decode::smem_bytes(G, D, sizeof(T), kState, stages);
  const int vec = rap_decode::vec_rows<T>(D, k, v);
  return rap_decode::launch_split<O>(
      decode_kernel<T, O, HB>, smem, B, K, G, D, nsplit, (float*)part,
      (O*)out, (float*)lse, s, (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)valid,
      valid_stride, H, K, D, S, split_tokens, scale, softcap, stages, vec);
}

// q [B,1,H,D]; k/v [B,S,K,D]; valid uint8 (bool) rows of S at stride
// valid_stride (0: one row for all); out [B,1,H,D]. All contiguous, q, k,
// v and out in one dtype. Row tokens are cut into nsplit splits of
// split_tokens (a multiple of 64); with nsplit > 1, part holds the f32
// partials (B*K*nsplit*G*(D+2) floats). lse: f32 [B, H], each row and
// head's log-sum-exp (-inf where no token is valid), or null for none.
// out_f32: out is f32 (unrounded) whatever q's dtype.
extern "C" int rap_decode_attention(const void* q, const void* k,
                                    const void* v, const void* valid,
                                    long long valid_stride, void* out,
                                    void* part, void* lse, int out_f32,
                                    int B, int H, int K, int D, int S,
                                    int split_tokens, int nsplit,
                                    float scale, float softcap, int dtype,
                                    void* stream) {
  if (B == 0) return 0;
  if (split_tokens <= 0 || split_tokens % kTile ||
      (long long)nsplit * split_tokens < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = H / K;
  RAP_DISPATCH(dtype, T, {
    if (out_f32)
      return G % 4 == 0
          ? launch<T, float, 4>(q, k, v, valid, valid_stride, out, part, lse,
                                B, H, K, D, S, split_tokens, nsplit, scale,
                                softcap, s)
          : launch<T, float, 1>(q, k, v, valid, valid_stride, out, part, lse,
                                B, H, K, D, S, split_tokens, nsplit, scale,
                                softcap, s);
    return G % 4 == 0
        ? launch<T, T, 4>(q, k, v, valid, valid_stride, out, part, lse, B,
                          H, K, D, S, split_tokens, nsplit, scale, softcap, s)
        : launch<T, T, 1>(q, k, v, valid, valid_stride, out, part, lse, B,
                          H, K, D, S, split_tokens, nsplit, scale, softcap,
                          s);
  });
  return 0;
}
