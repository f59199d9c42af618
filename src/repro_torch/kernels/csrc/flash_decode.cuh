// The split-KV flash-decode loop shared by the dense and the paged decode
// kernels, and the fixed-order combine of its partial results.
//
// Bound on the H100 by memory: a decode step reads each attended token's K
// and V once and does 4 flops per K/V element pair. One CTA per (row, kv
// head) leaves most SMs idle at small batch and lets the longest row set the
// time, so each row's tokens are cut into splits of `split_tokens` (a whole
// number of 64-token tiles, the same places in both kernels) and one CTA
// runs per (row b, kv head g, split). It serves the G query heads sharing
// kv head g from each K/V fetch, walks its split in 64-token tiles and
// keeps the online-softmax state (m, l, acc) in f32. Two bodies walk it:
// the tensor-core body (namespace tc below: TMA ring, wgmma) for bf16 /
// fp16 q, and the FMA body here, for f32 q and whatever the wrapper's plan
// (kernels/decode_attention.py::plan) sends it. The FMA body stages each
// tile in shared memory by 16-byte cp.async (one stage, loaded while the
// last tile's buffers are free: a second stage timed no faster; an
// element loader where a row is not 16-byte chunks). Scores and P.V read
// the tiles from shared memory: a token's dot product is spread over a few
// lanes in 8-element chunks (vector loads) and an xor tree, and each
// thread accumulates P.V for up to 4 heads of one or two columns, so a K
// or V element read from shared memory serves 4 heads.
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
// Both kernels call the same body with their own loader over the same
// split boundaries, so for the same tokens they run the identical op
// sequence: the dense kernel equals the paged kernel bitwise on either body
// (the port's twin of the JAX contract "paged kernel == dense decode
// kernel at page_tokens == block_k"), and on the FMA body the quantized
// loader, which widens each code as float(code) * scale, equals the
// model-dtype loader on dequantized pages. An FMA loader provides
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

#include <type_traits>

#include <cuda_fp8.h>

#include "common.cuh"
#include "hopper.cuh"

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

// Shared memory of one CTA of the FMA body: the loader's state
// (state_bytes, both slots), one K/V tile buffer of E, then the f32 words of
// the loop.
__host__ __device__ constexpr size_t kv_stage_bytes(int D, int esize) {
  return (size_t)2 * kTile * D * esize;
}
__host__ __device__ constexpr size_t loop_bytes(int G, int D) {
  return align16((size_t)(2 * G * D + G * kTile + 3 * G) * sizeof(float));
}
inline size_t smem_bytes(int G, int D, int esize, int state_bytes) {
  return align16(state_bytes) + kv_stage_bytes(D, esize) + loop_bytes(G, D);
}

// 16-byte chunks when a K/V row is whole chunks and every row starts on a
// 16-byte boundary (the bases and the element strides between rows)
template <typename E>
inline bool vec_rows(int D, const void* a, const void* b,
                     long long row_strides) {
  return (D * sizeof(E)) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0 &&
         (row_strides * (long long)sizeof(E)) % 16 == 0;
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
                       float softcap, Ld& ld, bool vec,
                       unsigned char* kv_smem) {
  using E = typename Ld::E;
  E* const ks = reinterpret_cast<E*>(kv_smem);   // [kTile*D] K, then V
  E* const vs = ks + kTile * D;
  float* s_s = reinterpret_cast<float*>(kv_smem + kv_stage_bytes(D, sizeof(E)));
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
  copy_tile(ld, 0, t_begin, min(kTile, t_end - t_begin), ks, vs, D, vec,
            tid);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, t0 = t_begin + it * kTile;
    const int nt = min(kTile, t_end - t0);
    const int t1 = t0 + kTile;
    const int nt1 = it + 1 < n_tiles ? min(kTile, t_end - t1) : 0;
    if (nt1) ld.state(st ^ 1, t1, nt1, tid);  // slot last used by tile it-1
    cp_async_wait_all();
    __syncthreads();  // tile it landed; the next tile's state is written
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
    if (nt1) {        // one stage: the next tile loads into the same buffers
      copy_tile(ld, st ^ 1, t1, nt1, ks, vs, D, vec, tid);
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

// Launch `kern` on grid (B, K, nsplit) with `threads` a block, then, with
// more than one split, the combine. Refuses (returns the error, cleared)
// what does not fit a block. `lse` ([B, K·G] f32) or nullptr.
template <typename T, typename Kern, typename... Args>
inline int launch_split(Kern kern, int threads, size_t smem, int B, int K,
                        int G, int D, int nsplit, float* part, T* out,
                        float* lse, cudaStream_t s, Args... args) {
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
  kern<<<dim3(B, K, nsplit), threads, smem, s>>>(args..., pt, out);
  if (nsplit > 1)
    combine_kernel<T><<<dim3(B * K, G), kThreads,
                        2 * nsplit * sizeof(float), s>>>(pt, out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ the tensor-core body
//
// bf16 / fp16 q (and pages, or int8 / e4m3 codes widened in shared memory)
// on Hopper's own instructions: one consumer warpgroup and one producer
// warp a CTA. The producer walks the split's 64-token tiles and loads K
// and V of each by TMA into a ring of `stages` stages (a full and an empty
// mbarrier each): boxes of 16 tokens from a tensor map over the dense cache
// with its own strides, or one box per page run (R = gcd(page_tokens, 64)
// tokens) at the page's coordinate from the table, never past the split's
// last attended token. The consumers swap the product's operands so that
// the 64-token tile is wgmma's M: S^T [64 x N] = K_tile . Q^T (m64nNk16,
// N = G rounded up to a multiple of 8, Q loaded once), the online softmax
// on S^T in f32 registers (a head's max over the tile crosses the four
// warps through shared memory), then O^T [D x N] += V^T . P^T with V read
// MN-major (a transposed A, one m64 product per 64 columns of D) and P^T
// written to shared memory in T as two parts, P rounded to T and the
// remainder P - T(P) rounded to T, each its own product: P keeps about 16
// bits (the FMA body keeps it in f32; one T rounding put the f32 output of
// return_lse 2e-4 from the plain version at recurrentgemma-9b's G = 16, D
// = 256, over its 1e-4). acc stays in registers (D / 64 x N / 2
// floats a thread); two named barriers a tile. The output's split
// boundaries, sinks and combine are the FMA body's, so dense and paged
// agree bitwise on the same tokens here too. Codes: the consumers widen a
// tile's codes into T tiles (exact: int8 and e4m3 values are bf16 / fp16
// values), multiply each score by its token's K scale after Q.K^T and each
// probability by its V scale before it is rounded to T.
namespace tc {

constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;   // and a producer warp
constexpr int kMaxBoxes = 8;                // token boxes a tile (>= 8 rows)
constexpr int kBar = 1;                     // the consumers' named barrier

// The CTA's shared memory, from a 1024-byte boundary (the 128-byte swizzle's
// atom), mirrored by kernels/decode_attention.py::plan: `stages` K and V
// tiles (T: [D_T / 64 boxes][64 rows][64]; codes: [64][D] plainly), the
// widened T tiles of K and V (codes), Q [D_T / 64][N][64], P [N][64] in T
// and its remainder [N][64] in T, the warps' per-head maxima or sums [4][N]
// f32, each stage's valid flags [64] and scales [2][kMaxBoxes] f32, the
// full and empty barriers.
struct Layout {
  size_t tile, conv, q, p, red, valid, scales, bars, total;
};
__host__ __device__ inline Layout layout(int DT, int N, int stages,
                                         bool codes, int D) {
  Layout L;
  L.tile = codes ? (size_t)64 * D : (size_t)64 * DT * 2;
  L.conv = (size_t)stages * 2 * L.tile;
  L.q = L.conv + (codes ? (size_t)2 * 64 * DT * 2 : 0);
  L.p = L.q + (size_t)N * DT * 2;
  L.red = L.p + (size_t)2 * N * 128;
  L.valid = L.red + (size_t)4 * N * 4;
  L.scales = L.valid + (size_t)stages * 64;
  L.bars = L.scales + (size_t)stages * 2 * kMaxBoxes * 4;
  L.total = L.bars + (size_t)stages * 16 + 1024;   // + alignment slack
  return L;
}

// two f32 rounded to T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// byte offset of 16-byte chunk c (columns 8c..8c+7) of row r in a swizzled
// tile of `rows`-row boxes of 64 columns
__device__ __forceinline__ uint32_t sw_off(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// A tile of codes [64][D] widened into a swizzled T tile [D_T/64][64][64];
// rows from `rows` on and columns past D are written as zero.
template <typename C, typename T, int DT>
__device__ __forceinline__ void widen(const unsigned char* codes, T* tile,
                                      int D, int rows, int wtid) {
  unsigned char* out = reinterpret_cast<unsigned char*>(tile);
  for (int i = wtid; i < 64 * DT / 8; i += kConsumers) {
    const int r = i / (DT / 8), c = i - r * (DT / 8);
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && 8 * c < D) {
      const uint2 b = *reinterpret_cast<const uint2*>(codes + r * D + 8 * c);
      w.x = pack2<T>(code_f32<C>(b.x), code_f32<C>(b.x >> 8));
      w.y = pack2<T>(code_f32<C>(b.x >> 16), code_f32<C>(b.x >> 24));
      w.z = pack2<T>(code_f32<C>(b.y), code_f32<C>(b.y >> 8));
      w.w = pack2<T>(code_f32<C>(b.y >> 16), code_f32<C>(b.y >> 24));
    }
    *reinterpret_cast<uint4*>(out + sw_off(r, c, 64)) = w;
  }
}

// rows [from, 64) of a swizzled T tile as zero
template <int DT>
__device__ __forceinline__ void zero_rows(unsigned char* tile, int from,
                                          int wtid) {
  const int per_box = (64 - from) * 8;   // 16-byte chunks
  for (int i = wtid; i < (DT / 64) * per_box; i += kConsumers) {
    const int x = i / per_box, k = i - x * per_box;
    *reinterpret_cast<uint4*>(tile + x * 8192 + (from + k / 8) * 128 +
                              (k % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Tokens [t_begin, t_end) of one (row, kv head) for its G heads (q_b [G, D]
// contiguous, 16-byte aligned, D % 8 == 0), into a sink of element type O.
// Called by all kThreads threads; `smem` is 1024-byte aligned, laid out as
// layout(DT, N, stages, Src::kCodes, D). A source provides
//
//   static constexpr bool kCodes;  using C;   // one-byte codes, their type
//   void produce(tm_k, tm_v, full, k_dst, v_dst, valid[64], scales[2][8],
//                t0, nt, lane) const;  // by all 32 producer lanes: the
//                // tile's TMA boxes and state, 32 arrivals (lane 0's
//                // with the boxes' bytes)
//   bool valid(const uint8_t* valid, int j, int nt) const;
//   int rows;                          // tokens a box (the scales' index)
template <typename T, int DT, int N, class Src, typename O>
__device__ __forceinline__ void attend(
    const CUtensorMap* tm_k, const CUtensorMap* tm_v, const T* __restrict__ q_b,
    const Sink<O>& o, int G, int D, int t_begin, int t_end, float scale,
    float softcap, int stages, const Src& src, unsigned char* smem) {
  constexpr int NB = DT / 64;    // 64-column boxes of a row
  constexpr int NC = N / 8;      // n8 blocks of the accumulators
  const Layout L = layout(DT, N, stages, Src::kCodes, D);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  float* red = reinterpret_cast<float*>(smem + L.red);         // [4][N]
  uint8_t* vld = smem + L.valid;                               // [stages][64]
  float* scl = reinterpret_cast<float*>(smem + L.scales);      // [stages][16]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + s, 32);        // every producer lane
      hopper::mbar_init(empty + s, 4);        // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // warp-uniform as far as the compiler can see, so no branch on it makes
  // a wgmma path divergent
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid & 31;
  if (warp == 4) {
    // ---------------------------------------------- producer (one warp)
    if (lane == 0) {
      hopper::tma_prefetch(tm_k);
      hopper::tma_prefetch(tm_v);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % stages;
      const int t0 = t_begin + it * kTile;
      hopper::mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
      unsigned char* kd = smem + (size_t)s * 2 * L.tile;
      src.produce(tm_k, tm_v, full + s, kd, kd + L.tile, vld + s * 64,
                  scl + s * 2 * kMaxBoxes, t0, min(kTile, t_end - t0), lane);
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  const int gq = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + gq, r1 = r0 + 8;   // this thread's tokens
  // Q [NB][N][64], rows past G and columns past D zero
  for (int i = tid; i < N * DT / 8; i += kConsumers) {
    const int h = i / (DT / 8), c = i - h * (DT / 8);
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (h < G && 8 * c < D)
      w = *reinterpret_cast<const uint4*>(q_b + (long long)h * D + 8 * c);
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(Qs) +
                              sw_off(h, c, N)) = w;
  }
  hopper::fence_proxy_async();
  hopper::named_sync(kBar, kConsumers);
  const uint32_t q_addr = hopper::smem_u32(Qs);
  const uint32_t p_addr = hopper::smem_u32(Ps);
  T* kc = reinterpret_cast<T*>(smem + L.conv);   // widened codes (kCodes)
  T* vc = kc + 64 * DT;

  float acc[NB][N / 2];   // O^T: rows d = 64x + r0 (+8), heads 8j + 2t4 (+1)
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[x][i] = 0.f;
  float m[NC][2], l[NC][2];   // heads 8j + 2t4 + c; l: this thread's rows
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m[j][c] = RAP_NEG_INF;
      l[j][c] = 0.f;
    }

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % stages;
    const int nt = min(kTile, t_end - (t_begin + it * kTile));
    unsigned char* kst = smem + (size_t)s * 2 * L.tile;
    unsigned char* vst = kst + L.tile;
    const uint8_t* vl = vld + s * 64;
    const float* sc_s = scl + s * 2 * kMaxBoxes;
    hopper::mbar_wait(full + s, (it / stages) & 1);
    // V rows past the tile's last token may hold anything (a stale stage,
    // the cache's unwritten tail): they are weighted by p = 0, so they
    // must be finite
    const T* kt;
    const T* vt;
    if constexpr (Src::kCodes) {
      widen<typename Src::C, T, DT>(kst, kc, D, kTile, tid);
      widen<typename Src::C, T, DT>(vst, vc, D, nt, tid);
      kt = kc;
      vt = vc;
    } else {
      kt = reinterpret_cast<const T*>(kst);
      vt = reinterpret_cast<const T*>(vst);
      if (nt < kTile) zero_rows<DT>(vst, nt, tid);
    }
    if (Src::kCodes || nt < kTile) {
      hopper::fence_proxy_async();
      hopper::named_sync(kBar, kConsumers);
    }
    // S^T = K_tile . Q^T, both K-major
    float sc[N / 2];
    {
      const uint32_t k_addr = hopper::smem_u32(kt);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(
            k_addr + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = hopper::desc_sw128(
            q_addr + (kk / 4) * N * 128 + (kk % 4) * 32, 16, 1024);
        hopper::WgmmaNarrow<N, T>::template ss<0>(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
    }
    // scores (scaled, softcapped, RAP_NEG_INF where masked) and each
    // head's max over the thread's two tokens, then over the warp
    const bool ok0 = src.valid(vl, r0, nt), ok1 = src.valid(vl, r1, nt);
    float ks0 = 1.f, ks1 = 1.f, vs0 = 1.f, vs1 = 1.f;
    if constexpr (Src::kCodes) {
      ks0 = sc_s[r0 / src.rows];
      ks1 = sc_s[r1 / src.rows];
      vs0 = sc_s[kMaxBoxes + r0 / src.rows];
      vs1 = sc_s[kMaxBoxes + r1 / src.rows];
    }
    float cm[NC][2];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if constexpr (Src::kCodes) x *= e < 2 ? ks0 : ks1;
        x *= scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        sc[4 * j + e] = (e < 2 ? ok0 : ok1) ? x : RAP_NEG_INF;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = fmaxf(sc[4 * j + c], sc[4 * j + 2 + c]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
        cm[j][c] = x;
      }
    }
    if (gq == 0)
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          red[warp * N + 8 * j + 2 * t4 + c] = cm[j][c];
    hopper::named_sync(kBar, kConsumers);
    // the tile's max over the four warps, the new max, the rescale; p
    // (exactly 0 where masked) into P^T's rows of heads, in T
    unsigned char* pb = reinterpret_cast<unsigned char*>(Ps);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int h = 8 * j + 2 * t4 + c;
        const float mx = fmaxf(fmaxf(red[h], red[N + h]),
                               fmaxf(red[2 * N + h], red[3 * N + h]));
        const float m_new = fmaxf(m[j][c], mx);
        const float alpha = expf(m[j][c] - m_new);
        m[j][c] = m_new;
        const float p0 = ok0 ? expf(sc[4 * j + c] - m_new) : 0.f;
        const float p1 = ok1 ? expf(sc[4 * j + 2 + c] - m_new) : 0.f;
        l[j][c] = alpha * l[j][c] + (p0 + p1);
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          acc[x][4 * j + c] *= alpha;
          acc[x][4 * j + 2 + c] *= alpha;
        }
        // a token past the tile's last box has no scale loaded: its 0 stays
        const float w0 = Src::kCodes && ok0 ? p0 * vs0 : p0;
        const float w1 = Src::kCodes && ok1 ? p1 * vs1 : p1;
        const T hi0 = from_f32<T>(w0), hi1 = from_f32<T>(w1);
        unsigned char* e0 =
            pb + h * 128 + (((r0 >> 3) ^ (h & 7)) << 4) + (r0 & 7) * 2;
        unsigned char* e1 =
            pb + h * 128 + (((r1 >> 3) ^ (h & 7)) << 4) + (r1 & 7) * 2;
        *reinterpret_cast<T*>(e0) = hi0;
        *reinterpret_cast<T*>(e1) = hi1;
        *reinterpret_cast<T*>(e0 + N * 128) = from_f32<T>(w0 - to_f32(hi0));
        *reinterpret_cast<T*>(e1 + N * 128) = from_f32<T>(w1 - to_f32(hi1));
      }
    hopper::fence_proxy_async();
    hopper::named_sync(kBar, kConsumers);
    // O^T += V^T . P^T: V MN-major (a transposed A), P^T K-major, as
    // P's T part and then its remainder's, so that P keeps ~16 bits
    {
      const uint32_t v_addr = hopper::smem_u32(vt);
#pragma unroll
      for (int x = 0; x < NB; ++x) hopper::fence_regs(acc[x]);
      hopper::wgmma_fence();
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint64_t da = hopper::desc_sw128(
              v_addr + x * 8192 + kk * 16 * 128, 8192, 1024);
          const uint64_t db =
              hopper::desc_sw128(p_addr + kk * 32, 16, 1024);
          const uint64_t dl =
              hopper::desc_sw128(p_addr + N * 128 + kk * 32, 16, 1024);
          hopper::WgmmaNarrow<N, T>::template ss<1>(acc[x], da, db, 1);
          hopper::WgmmaNarrow<N, T>::template ss<1>(acc[x], da, dl, 1);
        }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < NB; ++x) hopper::fence_regs(acc[x]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);
  }

  // each head's sum: the thread's rows, the warp's (xor over its 8 row
  // groups), then the four warps' in order
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x = l[j][c];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (gq == 0) red[warp * N + 8 * j + 2 * t4 + c] = x;
    }
  hopper::named_sync(kBar, kConsumers);
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int h = 8 * j + 2 * t4 + c;
      l[j][c] = ((red[h] + red[N + h]) + red[2 * N + h]) + red[3 * N + h];
    }
#pragma unroll
  for (int x = 0; x < NB; ++x)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int j = i / 4, c = i & 1;
      const int h = 8 * j + 2 * t4 + c;
      const int d = 64 * x + r0 + ((i & 2) ? 8 : 0);
      if (h < G && d < D) {
        if (o.out)
          o.out[h * D + d] = from_f32<O>(acc[x][i] / fmaxf(l[j][c], 1e-30f));
        else
          o.acc[h * D + d] = acc[x][i];
      }
    }
  if (warp == 0 && gq == 0)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int h = 8 * j + 2 * t4 + c;
        if (h >= G) continue;
        if (o.out) {
          if (o.lse) o.lse[h] = head_lse(m[j][c], l[j][c]);
        } else {
          o.ml[2 * h] = m[j][c];
          o.ml[2 * h + 1] = l[j][c];
        }
      }
}

}  // namespace tc

}  // namespace rap_decode
