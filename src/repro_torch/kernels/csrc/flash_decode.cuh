// The flash-decode tile loop shared by the dense and the paged decode
// kernels: one CTA holds the G query heads of one (row, kv head) and walks
// the row's tokens in tiles of kTile, keeping the online-softmax state
// (m, l, acc) in f32 in shared memory.
//
// Both kernels call rap_decode::attend with their own token loader, so for
// the same tokens in the same order they run the identical f32 op sequence:
// the dense kernel equals the paged kernel bitwise (the port's twin of the
// JAX contract "paged kernel == dense decode kernel at page_tokens ==
// block_k"). A loader provides
//
//   __device__ void  tile(int t0, int nt, int tid);  // per-token state of
//                        // tokens [t0, t0 + nt) into shared memory, filled
//                        // by the block's threads (barriers around it)
//   __device__ bool  valid(int j) const;             // token t0 + j attended
//   __device__ float k(int j, int d) const;          // K[t0 + j, d] as f32
//   __device__ float v(int j, int d) const;          // V[t0 + j, d] as f32
//
// A masked token's K is not read: its score is the finite RAP_NEG_INF and
// its probability exactly 0 (the TPU kernel's p = where(mask, exp(s -
// m_new), 0)), so a tile whose tokens are all masked leaves (m, l, acc)
// unchanged even while m is still RAP_NEG_INF. Its V is read and weighted
// by that 0, as the TPU kernel's p @ v does, which keeps the P.V loop free
// of a branch per token.
#pragma once

#include "common.cuh"

namespace rap_decode {

constexpr int kTile = 64;     // tokens per tile
constexpr int kThreads = 128;

// f32 words of shared memory the loop needs for G heads of width D
__host__ __device__ constexpr int loop_floats(int G, int D) {
  return 2 * G * D + G * kTile + 3 * G;
}

// q_b / out_b: the G heads of this (row, kv head), [G, D] contiguous; n:
// tokens to walk (the loader masks inside them); sm: loop_floats(G, D)
// words of shared memory.
template <typename T, class Loader>
__device__ __forceinline__ void attend(const T* __restrict__ q_b,
                                       T* __restrict__ out_b, int G, int D,
                                       int n, float scale, float softcap,
                                       Loader& ld, float* sm) {
  float* q_s = sm;                     // [G*D]
  float* acc = q_s + G * D;            // [G*D]
  float* s_s = acc + G * D;            // [G*kTile] scores, then p
  float* m_s = s_s + G * kTile;        // [G]
  float* l_s = m_s + G;                // [G]
  float* a_s = l_s + G;                // [G] rescale of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q_b[i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = RAP_NEG_INF;
    l_s[tid] = 0.f;
  }
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int nt = min(kTile, n - t0);
    __syncthreads();  // previous tile fully consumed
    ld.tile(t0, nt, tid);
    __syncthreads();
    // scores s[h, j] = scale * q_h . k_j (one warp per (h, j) pair)
    for (int p = warp; p < G * nt; p += nwarps) {
      const int h = p / nt, j = p - h * nt;
      float s = RAP_NEG_INF;
      if (ld.valid(j)) {  // uniform across the warp
        const float* qh = q_s + h * D;
        float dot = 0.f;
        for (int d = lane; d < D; d += 32) dot += qh[d] * ld.k(j, d);
        dot = warp_sum(dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      if (lane == 0) s_s[h * kTile + j] = s;
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
        const float pj = ld.valid(j) ? expf(s_s[h * kTile + j] - m_new) : 0.f;
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
      for (int j = 0; j < nt; ++j) a += ph[j] * ld.v(j, d);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D;
    out_b[i] = from_f32<T>(acc[i] / fmaxf(l_s[h], 1e-30f));
  }
}

}  // namespace rap_decode
