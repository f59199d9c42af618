// Flash-decode: one query token per row against a contiguous KV cache.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention. q [B,1,H,D];
// k, v [B,S,K,D]; valid [S] (one mask for every row, JAX's signature: read
// with row stride 0) or [B,S] (one mask per row: the slot cache, where each
// row sits at its own position); scale 1/sqrt(D) and an optional tanh
// softcap. Query head h reads kv head h / (H / K).
//
// Bound on the H100 by memory: the attended tokens' K and V are read once
// (4 flops per K/V element pair against 2 bytes each in bf16). Design: one
// CTA per (row b, kv head g) serves the G query heads sharing that kv head,
// so each K/V element is fetched once for all G heads; the TPU kernel's
// sequential kv-block axis becomes the loop over 64-token tiles of
// flash_decode.cuh (the same loop as the paged kernel). The block first
// finds the row's last valid token and stops there, so the unwritten tail of
// a slot cache is never read; masked tokens inside (a ring buffer's stale
// slots) get probability exactly 0. Each tile's token offsets go to shared
// memory once, as the paged kernel's do, so the two inner loops run the same
// instructions. With f32 q and a prefix mask valid[b, t] = t < len[b] this
// kernel equals the paged kernel bitwise on pages holding the same tokens
// in order.
#include "flash_decode.cuh"

#include <stdint.h>

using rap_decode::kThreads;
using rap_decode::kTile;

// Token loader of rap_decode::attend over row b's contiguous cache of kv
// head g: token t's element d lives at base[t * K * D + d].
template <typename T>
struct DenseLoader {
  const T* kb;            // &k[b, 0, g, 0]
  const T* vb;            // &v[b, 0, g, 0]
  const uint8_t* vrow;    // valid row b
  long long tok_stride;   // K * D
  long long* off_s;       // [kTile] element offset of each token
  uint8_t* vld_s;         // [kTile] valid flags of the tile

  __device__ void tile(int t0, int nt, int tid) {
    for (int j = tid; j < nt; j += kThreads) {
      off_s[j] = (long long)(t0 + j) * tok_stride;
      vld_s[j] = vrow[t0 + j];
    }
  }
  __device__ bool valid(int j) const { return vld_s[j] != 0; }
  __device__ float k(int j, int d) const { return to_f32(kb[off_s[j] + d]); }
  __device__ float v(int j, int d) const { return to_f32(vb[off_s[j] + d]); }
};

// shared memory before the loop's f32 words: hi (16 B), offsets, flags
constexpr int kHead = 16 + kTile * 8 + kTile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const uint8_t* __restrict__ valid,
              long long valid_stride, T* __restrict__ out, int H, int K,
              int D, int S, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hi_s = reinterpret_cast<int*>(smem);                 // [1]
  long long* off_s = reinterpret_cast<long long*>(smem + 16);  // [kTile]
  uint8_t* vld_s = smem + 16 + kTile * 8;                   // [kTile]
  float* loop_s = reinterpret_cast<float*>(smem + kHead);
  const int G = H / K;
  const int b = blockIdx.x, g = blockIdx.y;
  const uint8_t* vrow = valid + (long long)b * valid_stride;
  // one past the row's last valid token: the walk stops there
  int hi = 0;
  for (int t = threadIdx.x; t < S; t += kThreads)
    if (vrow[t]) hi = t + 1;
  if (threadIdx.x == 0) *hi_s = 0;
  __syncthreads();
  if (hi > 0) atomicMax(hi_s, hi);
  __syncthreads();
  hi = *hi_s;
  const long long tok_stride = (long long)K * D;
  const long long kv0 = (long long)b * S * tok_stride + (long long)g * D;
  DenseLoader<T> ld{k + kv0, v + kv0, vrow, tok_stride, off_s, vld_s};
  const long long head0 = ((long long)b * H + (long long)g * G) * D;
  rap_decode::attend(q + head0, out + head0, G, D, hi, scale, softcap, ld,
                     loop_s);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* valid, long long valid_stride, void* out, int B,
                  int H, int K, int D, int S, float scale, float softcap,
                  cudaStream_t s) {
  const size_t smem =
      kHead + (size_t)rap_decode::loop_floats(H / K, D) * sizeof(float);
  auto kern = decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, K), kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)valid,
      valid_stride, (T*)out, H, K, D, S, scale, softcap);
  return (int)cudaGetLastError();
}

// q [B,1,H,D]; k/v [B,S,K,D]; valid uint8 (bool) rows of S at stride
// valid_stride (0: one row for all); out [B,1,H,D]. All contiguous, q, k,
// v and out in one dtype.
extern "C" int rap_decode_attention(const void* q, const void* k,
                                    const void* v, const void* valid,
                                    long long valid_stride, void* out, int B,
                                    int H, int K, int D, int S, float scale,
                                    float softcap, int dtype, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    return launch<T>(q, k, v, valid, valid_stride, out, B, H, K, D, S, scale,
                     softcap, s);
  });
  return 0;
}
