// The split-KV flash-decode loop shared by the dense and the paged decode
// kernels, and the fixed-order combine of its partial results.
//
// Bound on the H100 by memory: a decode step reads each attended token's K
// and V once and does 4 flops per K/V element pair. One CTA per (row, kv
// head) leaves most SMs idle at small batch and lets the longest row set the
// time, so each row's tokens are cut into splits of `split_tokens` (a whole
// number of 64-token tiles, the same places in both kernels) and one CTA
// runs per (row b, kv head g, split). It serves the G query heads sharing
// kv head g from each K/V fetch, walks its split in 64-token tiles staged in
// shared memory by 16-byte cp.async (a two-stage ring: the next tile lands
// while this one is used; an element loader where a row is not 16-byte
// chunks), and keeps the online-softmax state (m, l, acc) in f32. Scores
// and P.V read the tiles from shared memory: a token's dot product is
// spread over a few lanes in 8-element chunks (vector loads) and an xor
// tree, and each thread accumulates P.V for up to 4 heads of one or two
// columns, so a K or V element read from shared memory serves 4 heads.
//
// With one split the CTA writes the output itself. Otherwise it writes its
// partial (m, l, acc) in f32 to scratch and `combine_kernel` gives
//   m* = max_i m_i,
//   out = sum_i e^(m_i - m*) acc_i / max(sum_i e^(m_i - m*) l_i, 1e-30)
// taking the splits in index order (no float atomics: two launches on the
// same inputs give the same bits). A split with no attended token writes
// m = RAP_NEG_INF, l = 0, acc = 0 and gets weight 0; a row with no valid
// token still gives 0.
//
// A caller that combines several such results itself (a cache cut into
// sequence blocks across ranks) passes an f32 `lse` [B, H]: each row and
// head also gets its log-sum-exp, lse = m* + log(sum_i e^(m_i - m*) l_i)
// (m + log(l) with one split), in the scaled, softcapped score units, and
// -inf where no token was attended; such a caller may also take the output
// in f32 (the sink's element type O), unrounded, as the splits' partials
// are. The output's arithmetic is the same with or without either.
//
// Both kernels call rap_decode::attend with their own loader over the same
// split boundaries, so for the same tokens they run the identical f32 op
// sequence: the dense kernel equals the paged kernel bitwise (the port's
// twin of the JAX contract "paged kernel == dense decode kernel at
// page_tokens == block_k"), and the quantized loader, which widens each
// code as float(code) * scale, equals the model-dtype loader on
// dequantized pages. A loader provides
//
//   using E;                          // element type of K/V in memory
//   static constexpr bool kScaled;    // multiply each element by a scale
//   void state(int st, int t0, int nt, int tid);  // per-token state of
//                    // tokens [t0, t0 + nt) into state slot st (0 or 1)
//   const E* krow(int st, int t0, int j) const;   // K row of token t0 + j
//   const E* vrow(int st, int t0, int j) const;
//   bool valid(int st, int j) const;              // token t0 + j attended
//   float kscale(int st, int j) const, vscale(int st, int j) const;
//
// A masked token's score is the finite RAP_NEG_INF and its probability
// exactly 0 (the TPU kernel's p = where(mask, exp(s - m_new), 0)), so it
// never sets the row max; its V is weighted by that 0, as the TPU kernel's
// p @ v does.
#pragma once

#include <stdint.h>

#include <cuda_fp8.h>

#include "common.cuh"

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);  // exact: every e4m3 value is an f32
}

namespace rap_decode {

constexpr int kTile = 64;     // tokens per tile; splits are whole tiles
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a one-byte code (the low byte of b) as to_f32 widens it
template <typename C> __device__ __forceinline__ float code_f32(unsigned b);
template <> __device__ __forceinline__ float code_f32<int8_t>(unsigned b) {
  return to_f32((int8_t)(b & 0xffu));
}
template <>
__device__ __forceinline__ float code_f32<__nv_fp8_e4m3>(unsigned b) {
  __nv_fp8_e4m3 c;
  c.__x = (__nv_fp8_storage_t)(b & 0xffu);
  return to_f32(c);
}

// N = 1, 2 or 8 consecutive elements of shared memory as f32 (one load),
// each widened as to_f32 does
template <typename E>
__device__ __forceinline__ void load_n(const E* p, float (&x)[1]) {
  x[0] = to_f32(*p);
}
__device__ __forceinline__ void load_n(const float* p, float (&x)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  x[0] = a.x;
  x[1] = a.y;
}
// the two 16-bit elements of a 32-bit word (low first) as f32
template <typename E> __device__ __forceinline__ float2 word_f32(unsigned w);
template <>
__device__ __forceinline__ float2 word_f32<__nv_bfloat16>(unsigned w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
template <> __device__ __forceinline__ float2 word_f32<__half>(unsigned w) {
  return make_float2(__half2float(__ushort_as_half(w & 0xffffu)),
                     __half2float(__ushort_as_half(w >> 16)));
}
template <typename E>   // bf16, fp16
__device__ __forceinline__ void load_n16(const E* p, float (&x)[2]) {
  const float2 a = word_f32<E>(*reinterpret_cast<const unsigned*>(p));
  x[0] = a.x;
  x[1] = a.y;
}
__device__ __forceinline__ void load_n(const __nv_bfloat16* p,
                                       float (&x)[2]) {
  load_n16(p, x);
}
__device__ __forceinline__ void load_n(const __half* p, float (&x)[2]) {
  load_n16(p, x);
}
template <typename C>   // one-byte codes: int8_t, __nv_fp8_e4m3
__device__ __forceinline__ void load_n(const C* p, float (&x)[2]) {
  const unsigned r = *reinterpret_cast<const uint16_t*>(p);
  x[0] = code_f32<C>(r);
  x[1] = code_f32<C>(r >> 8);
}
__device__ __forceinline__ void load_n(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
template <typename E>   // bf16, fp16
__device__ __forceinline__ void load_n16(const E* p, float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const float2 a = word_f32<E>(r.x), b = word_f32<E>(r.y),
               c = word_f32<E>(r.z), d = word_f32<E>(r.w);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  x[4] = c.x; x[5] = c.y; x[6] = d.x; x[7] = d.y;
}
__device__ __forceinline__ void load_n(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  load_n16(p, x);
}
__device__ __forceinline__ void load_n(const __half* p, float (&x)[8]) {
  load_n16(p, x);
}
template <typename C>
__device__ __forceinline__ void load_n(const C* p, float (&x)[8]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = code_f32<C>(r.x >> (8 * i));
    x[4 + i] = code_f32<C>(r.y >> (8 * i));
  }
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared memory of one CTA: the loader's state (state_bytes, both slots),
// `stages` K/V tile buffers of E, then the f32 words of the loop.
__host__ __device__ constexpr size_t kv_stage_bytes(int D, int esize) {
  return (size_t)2 * kTile * D * esize;
}
__host__ __device__ constexpr size_t loop_bytes(int G, int D) {
  return align16((size_t)(2 * G * D + G * kTile + 3 * G) * sizeof(float));
}
inline size_t smem_bytes(int G, int D, int esize, int state_bytes,
                         int stages) {
  return align16(state_bytes) + stages * kv_stage_bytes(D, esize) +
         loop_bytes(G, D);
}

// Two stages where they fit the opt-in limit of a block, else one (f32 at
// D = 256); the caller's launch refuses what one stage cannot hold.
inline int stages_for(int G, int D, int esize, int state_bytes) {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return smem_bytes(G, D, esize, state_bytes, 2) <= (size_t)optin ? 2 : 1;
}

// 16-byte chunks when a K/V row is whole chunks and the bases are aligned
template <typename E>
inline bool vec_rows(int D, const void* a, const void* b) {
  return (D * sizeof(E)) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// Tile [t0, t0 + nt) of K and V into ks / vs ([kTile, D] each), from the
// loader's state slot st: 16-byte cp.async, or element copies.
template <class Ld>
__device__ __forceinline__ void copy_tile(const Ld& ld, int st, int t0,
                                          int nt, typename Ld::E* ks,
                                          typename Ld::E* vs, int D, bool vec,
                                          int tid) {
  using E = typename Ld::E;
  if (vec) {
    constexpr int per = 16 / sizeof(E);
    const int cpt = D / per;
    for (int c = tid; c < nt * cpt; c += kThreads) {
      const int j = c / cpt, x = (c - j * cpt) * per;
      cp_async16(ks + j * D + x, ld.krow(st, t0, j) + x);
      cp_async16(vs + j * D + x, ld.vrow(st, t0, j) + x);
    }
  } else {
    for (int i = tid; i < nt * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      ks[i] = ld.krow(st, t0, j)[d];
      vs[i] = ld.vrow(st, t0, j)[d];
    }
  }
}

// Where a CTA's result goes: the output rows of its G heads (one split), or
// its partial acc [G, D] and (m, l) [G, 2] in scratch.
template <typename T>
struct Sink {
  T* out;          // [G, D] or nullptr
  float* acc;      // [G, D]
  float* ml;       // [G, 2]
  float* lse;      // [G] beside out, or nullptr
};

// log-sum-exp of a head whose scores have max m and sum of e^(s - m) l
__device__ __forceinline__ float head_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : -INFINITY;
}

// A split with no attended token.
template <typename T>
__device__ __forceinline__ void write_empty(const Sink<T>& o, int G, int D) {
  if (o.out) {
    for (int i = threadIdx.x; i < G * D; i += kThreads)
      o.out[i] = from_f32<T>(0.f);
    if (o.lse)
      for (int h = threadIdx.x; h < G; h += kThreads) o.lse[h] = -INFINITY;
  } else {
    for (int i = threadIdx.x; i < G * D; i += kThreads) o.acc[i] = 0.f;
    for (int h = threadIdx.x; h < G; h += kThreads) {
      o.ml[2 * h] = RAP_NEG_INF;
      o.ml[2 * h + 1] = 0.f;
    }
  }
}

// Scores s[h, j] = scale * q_h . k_j of a tile (HB heads a work item;
// RAP_NEG_INF for a masked token). A row is D / CH chunks of CH elements;
// chunk c is summed, in order, by lane c % lpt of the token's lpt lanes,
// then an xor tree over those lanes; a warp takes 32 / lpt tokens at once.
// The order depends on D alone, so every loader sums alike.
template <int CH, int HB, class Ld>
__device__ __forceinline__ void scores(const Ld& ld, int st,
                                       const typename Ld::E* ks,
                                       const float* q_s, float* s_s, int ngrp,
                                       int D, int nt, float scale,
                                       float softcap) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = D / CH;
  const int lpt = CH == 1 ? 32 : C >= 4 ? 4 : C >= 2 ? 2 : 1;
  const int sub = lane / lpt, sl = lane % lpt, items = ngrp * nt;
  for (int base = warp * (32 / lpt); base < items;
       base += kWarps * (32 / lpt)) {
    const int p = min(base + sub, items - 1);
    const int hg = p / nt, j = p - hg * nt;
    const float ksc = ld.kscale(st, j);
    float dot[HB];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) dot[hh] = 0.f;
    for (int c = sl; c < C; c += lpt) {
      float kv[CH];
      load_n(ks + j * D + CH * c, kv);
      if constexpr (Ld::kScaled) {
#pragma unroll
        for (int e = 0; e < CH; ++e) kv[e] *= ksc;
      }
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        float qv[CH];
        load_n(q_s + (hg * HB + hh) * D + CH * c, qv);
#pragma unroll
        for (int e = 0; e < CH; ++e) dot[hh] += qv[e] * kv[e];
      }
    }
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
      for (int o = lpt / 2; o > 0; o >>= 1)
        dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], o);
    if (sl == 0 && base + sub < items) {
      const bool ok = ld.valid(st, j);
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        float s = dot[hh] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        s_s[(hg * HB + hh) * kTile + j] = ok ? s : RAP_NEG_INF;
      }
    }
  }
}

// acc[h, d] = alpha_h * acc[h, d] + sum_j p[h, j] * v[j, d], j in order,
// one thread per (HB heads, CW adjacent columns): each V element read
// from shared memory serves HB heads.
template <int CW, int HB, class Ld>
__device__ __forceinline__ void pv(const Ld& ld, int st,
                                  const typename Ld::E* vs, const float* s_s,
                                  const float* a_s, float* acc, int ngrp,
                                  int D, int nt) {
  for (int i = threadIdx.x; i < ngrp * D / CW; i += kThreads) {
    const int hg = i / (D / CW), d = CW * i - hg * D;
    const float* ph = s_s + hg * HB * kTile;
    float a[HB][CW];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int w = 0; w < CW; ++w)
        a[hh][w] = acc[(hg * HB + hh) * D + d + w] * a_s[hg * HB + hh];
    int j = 0;
    for (; j + 4 <= nt; j += 4) {
      float vv[4][CW];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load_n(vs + (j + u) * D + d, vv[u]);
        if constexpr (Ld::kScaled) {
#pragma unroll
          for (int w = 0; w < CW; ++w) vv[u][w] *= ld.vscale(st, j + u);
        }
      }
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ph + hh * kTile + j);
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          a[hh][w] += p4.x * vv[0][w];
          a[hh][w] += p4.y * vv[1][w];
          a[hh][w] += p4.z * vv[2][w];
          a[hh][w] += p4.w * vv[3][w];
        }
      }
    }
    for (; j < nt; ++j) {
      float vv[CW];
      load_n(vs + j * D + d, vv);
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        if constexpr (Ld::kScaled) vv[w] *= ld.vscale(st, j);
#pragma unroll
        for (int hh = 0; hh < HB; ++hh)
          a[hh][w] += ph[hh * kTile + j] * vv[w];
      }
    }
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int w = 0; w < CW; ++w) acc[(hg * HB + hh) * D + d + w] = a[hh][w];
  }
}

// Tokens [t_begin, t_end) of one (row, kv head) for its G heads (q_b [G, D]
// contiguous), HB heads a work item, into a sink of element type O (T, or
// f32). smem: the layout of smem_bytes.
template <typename T, int HB, class Ld, typename O>
__device__ void attend(const T* __restrict__ q_b, const Sink<O>& o, int G,
                       int D, int t_begin, int t_end, float scale,
                       float softcap, Ld& ld, int stages, bool vec,
                       unsigned char* kv_smem) {
  using E = typename Ld::E;
  const size_t stage = kv_stage_bytes(D, sizeof(E));
  // K of slot st's tile at kbuf(st), its V kTile * D elements on
  auto kbuf = [&](int st) {
    return reinterpret_cast<E*>(kv_smem + (stages == 2 ? st : 0) * stage);
  };
  float* s_s = reinterpret_cast<float*>(kv_smem + stages * stage);
                                       // [G*kTile] scores, then p
  float* q_s = s_s + G * kTile;        // [G*D]
  float* acc = q_s + G * D;            // [G*D]
  float* m_s = acc + G * D;            // [G]
  float* l_s = m_s + G;                // [G]
  float* a_s = l_s + G;                // [G] rescale of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngrp = G / HB;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q_b[i]);
    acc[i] = 0.f;
  }
  for (int h = tid; h < G; h += kThreads) {
    m_s[h] = RAP_NEG_INF;
    l_s[h] = 0.f;
  }
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  ld.state(0, t_begin, min(kTile, t_end - t_begin), tid);
  __syncthreads();
  copy_tile(ld, 0, t_begin, min(kTile, t_end - t_begin), kbuf(0),
            kbuf(0) + kTile * D, D, vec, tid);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, t0 = t_begin + it * kTile;
    const int nt = min(kTile, t_end - t0);
    const int t1 = t0 + kTile;
    const int nt1 = it + 1 < n_tiles ? min(kTile, t_end - t1) : 0;
    if (nt1) ld.state(st ^ 1, t1, nt1, tid);  // slot last used by tile it-1
    cp_async_wait_all();
    __syncthreads();  // tile it landed; the next tile's state is written
    if (nt1 && stages == 2) {  // the next tile loads while this one is used
      copy_tile(ld, st ^ 1, t1, nt1, kbuf(st ^ 1), kbuf(st ^ 1) + kTile * D,
                D, vec, tid);
      cp_async_commit();
    }
    const E* ks = kbuf(st);
    const E* vs = ks + kTile * D;
    if (D % 8 == 0)   // 8-element chunks (vector loads) on 4 lanes a token
      scores<8, HB>(ld, st, ks, q_s, s_s, ngrp, D, nt, scale, softcap);
    else              // one element a lane, a warp a token
      scores<1, HB>(ld, st, ks, q_s, s_s, ngrp, D, nt, scale, softcap);
    __syncthreads();
    // online softmax update, one warp per head
    for (int h = warp; h < G; h += kWarps) {
      float mx = RAP_NEG_INF;
      for (int j = lane; j < nt; j += 32) mx = fmaxf(mx, s_s[h * kTile + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nt; j += 32) {
        const float pj =
            ld.valid(st, j) ? expf(s_s[h * kTile + j] - m_new) : 0.f;
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
    // column pairs where they still give every thread work
    if (D % 2 == 0 && ngrp * D >= 2 * kThreads)
      pv<2, HB>(ld, st, vs, s_s, a_s, acc, ngrp, D, nt);
    else
      pv<1, HB>(ld, st, vs, s_s, a_s, acc, ngrp, D, nt);
    __syncthreads();  // tile it consumed: its buffers and state slot are free
    if (nt1 && stages == 1) {
      copy_tile(ld, st ^ 1, t1, nt1, kbuf(0), kbuf(0) + kTile * D, D, vec,
                tid);
      cp_async_commit();
    }
  }
  if (o.out) {
    for (int i = tid; i < G * D; i += kThreads)
      o.out[i] = from_f32<O>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
    if (o.lse)
      for (int h = tid; h < G; h += kThreads)
        o.lse[h] = head_lse(m_s[h], l_s[h]);
  } else {
    for (int i = tid; i < G * D; i += kThreads) o.acc[i] = acc[i];
    for (int h = tid; h < G; h += kThreads) {
      o.ml[2 * h] = m_s[h];
      o.ml[2 * h + 1] = l_s[h];
    }
  }
}

// Scratch of n_bk (row, kv head) pairs x nsplit splits: every acc [G, D]
// first, then every (m, l) [G, 2]; `lse` ([n_bk, G]) or nullptr.
struct Partials {
  float* base;
  int n_bk, nsplit, G, D;
  float* lse;
  __host__ __device__ float* acc(int bk, int sp) const {
    return base + ((size_t)bk * nsplit + sp) * G * D;
  }
  __host__ __device__ float* ml(int bk, int sp) const {
    return base + (size_t)n_bk * nsplit * G * D +
           ((size_t)bk * nsplit + sp) * G * 2;
  }
};

template <typename T>
__device__ __forceinline__ Sink<T> sink(T* out, const Partials& pt, int bk,
                                        int sp) {
  const long long head0 = (long long)bk * pt.G * pt.D;
  if (pt.nsplit == 1)
    return {out + head0, nullptr, nullptr,
            pt.lse ? pt.lse + (long long)bk * pt.G : nullptr};
  return {nullptr, pt.acc(bk, sp), pt.ml(bk, sp), nullptr};
}

// The fixed-order combine: one CTA per ((row, kv head), head h), a thread
// per d. w_i = e^(m_i - m*) for a split that attended a token, 0 for an
// empty one (whose acc is 0); numerator and denominator summed over the
// splits in index order; the head's lse from the same m* and denominator.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(Partials pt, T* __restrict__ out) {
  extern __shared__ float w_s[];           // [nsplit] weights, [nsplit] l
  const int bk = blockIdx.x, h = blockIdx.y, D = pt.D, n = pt.nsplit;
  float* l_s = w_s + n;
  float m_star = RAP_NEG_INF;   // thread 0's is the head's
  if (threadIdx.x < 32) {
    for (int sp = threadIdx.x; sp < n; sp += 32)
      m_star = fmaxf(m_star, pt.ml(bk, sp)[2 * h]);
    m_star = warp_max(m_star);
    for (int sp = threadIdx.x; sp < n; sp += 32) {
      const float* ml = pt.ml(bk, sp) + 2 * h;
      l_s[sp] = ml[1];
      w_s[sp] = ml[1] > 0.f ? expf(ml[0] - m_star) : 0.f;
    }
  }
  __syncthreads();
  float den = 0.f;
  for (int sp = 0; sp < n; ++sp) den += w_s[sp] * l_s[sp];
  if (pt.lse && threadIdx.x == 0)
    pt.lse[(long long)bk * pt.G + h] = head_lse(m_star, den);
  den = fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float num = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n; ++sp) num += w_s[sp] * pt.acc(bk, sp)[h * D + d];
    out[((long long)bk * pt.G + h) * D + d] = from_f32<T>(num / den);
  }
}

// Launch `kern` on grid (B, K, nsplit), then, with more than one split, the
// combine. Refuses (returns the error, cleared) what does not fit a block.
// `lse` ([B, K·G] f32) or nullptr.
template <typename T, typename Kern, typename... Args>
inline int launch_split(Kern kern, size_t smem, int B, int K, int G, int D,
                        int nsplit, float* part, T* out, float* lse,
                        cudaStream_t s, Args... args) {
  if (nsplit < 1 || nsplit > 4096 || K > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)e;
    }
  }
  const Partials pt{part, B * K, nsplit, G, D, lse};
  kern<<<dim3(B, K, nsplit), kThreads, smem, s>>>(args..., pt, out);
  if (nsplit > 1)
    combine_kernel<T><<<dim3(B * K, G), kThreads,
                        2 * nsplit * sizeof(float), s>>>(pt, out);
  return (int)cudaGetLastError();
}

}  // namespace rap_decode
