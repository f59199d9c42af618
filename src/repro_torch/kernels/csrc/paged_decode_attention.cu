// Paged flash-decode: one query token per row against a global page pool.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode_attention.py::paged_decode_attention (its
// model-dtype body `_kernel`). Row b's token t lives in physical page
// table[b, t / pt] at slot t % pt; row b attends its first lengths[b]
// tokens with scale 1/sqrt(D) and an optional tanh softcap.
//
// Bound on the H100 by memory: each row's K and V bytes are read once
// (4 flops per K/V element pair against ~2 bytes each in bf16). Design: one
// CTA per (row b, kv head g) serves the G query heads sharing that kv head,
// so each K/V element is fetched from device memory once for all G heads.
// The TPU kernel's sequential page axis becomes a loop inside the block over
// tiles of 64 tokens; the block reads table[b, .] and lengths[b] itself in
// place of scalar prefetch, and stops at the row's length (the TPU kernel
// fetches and masks the padded pages, which are exact no-ops). The online
// softmax state (m, l, acc) stays in f32 in shared memory. Within a tile a
// warp reduces each (head, token) dot product over D with coalesced loads,
// then every thread owns (head, d) accumulator entries for the P.V update.
#include "common.cuh"

constexpr int kTile = 64;     // tokens per tile
constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int K, int D, int pt, int max_pages, float scale,
                    float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / K;
  long long* off_s = reinterpret_cast<long long*>(smem);        // [kTile]
  float* q_s = reinterpret_cast<float*>(off_s + kTile);          // [G*D]
  float* acc = q_s + G * D;                                      // [G*D]
  float* s_s = acc + G * D;                                      // [G*kTile]
  float* m_s = s_s + G * kTile;                                  // [G]
  float* l_s = m_s + G;                                          // [G]
  float* a_s = l_s + G;                                          // [G]

  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const T* qb = q + ((long long)b * H + (long long)g * G) * D;   // q [B,1,H,D]
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = RAP_NEG_INF;
    l_s[tid] = 0.f;
  }
  // tokens past the table width are never attended (as on the TPU, whose
  // grid covers max_pages pages)
  const int len = min(lengths[b], max_pages * pt);
  const long long tok_stride = (long long)K * D;

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int nt = min(kTile, len - t0);
    __syncthreads();  // previous tile fully consumed
    for (int j = tid; j < nt; j += kThreads) {
      const int t = t0 + j;
      const long long page = table[(long long)b * max_pages + t / pt];
      off_s[j] = (page * pt + t % pt) * tok_stride + (long long)g * D;
    }
    __syncthreads();
    // scores s[h, j] = scale * q_h . k_j (one warp per (h, j) pair)
    for (int p = warp; p < G * nt; p += nwarps) {
      const int h = p / nt, j = p - h * nt;
      const T* kr = kp + off_s[j];
      const float* qh = q_s + h * D;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qh[d] * to_f32(kr[d]);
      dot = warp_sum(dot);
      if (lane == 0) {
        float s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s_s[h * kTile + j] = s;
      }
    }
    __syncthreads();
    // online softmax update, one warp per head
    for (int h = warp; h < G; h += nwarps) {
      float mx = RAP_NEG_INF;
      for (int j = lane; j < nt; j += 32) mx = fmaxf(mx, s_s[h * kTile + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nt; j += 32) {
        const float pj = expf(s_s[h * kTile + j] - m_new);
        s_s[h * kTile + j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[h] = alpha;
        l_s[h] = alpha * l_s[h] + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();
    // acc[h, d] = alpha_h * acc[h, d] + sum_j p[h, j] * v[j, d]
    for (int i = tid; i < G * D; i += kThreads) {
      const int h = i / D, d = i - h * D;
      const float* ph = s_s + h * kTile;
      float a = acc[i] * a_s[h];
      for (int j = 0; j < nt; ++j) a += ph[j] * to_f32(vp[off_s[j] + d]);
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + ((long long)b * H + (long long)g * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D;
    ob[i] = from_f32<T>(acc[i] / fmaxf(l_s[h], 1e-30f));
  }
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
  const int G = H / K;
  const size_t smem = kTile * sizeof(long long)
      + (size_t)(2 * G * D + G * kTile + 3 * G) * sizeof(float);
  dim3 grid(B, K);
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    auto kern = paged_decode_kernel<T>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<grid, kThreads, smem, s>>>(
        (const T*)q, (const T*)kp, (const T*)vp, (const int*)table,
        (const int*)lengths, (T*)out, H, K, D, pt, max_pages, scale, softcap);
  });
  return (int)cudaGetLastError();
}
