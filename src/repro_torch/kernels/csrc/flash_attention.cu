// Causal flash attention for prefill: q [B,Sq,H,D], k/v [B,Skv,K,D].
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention. Query head h reads
// kv head h / G (G = H / K) by index; KV is never replicated. Optional band
// (`window` > 0: key kpos is kept when qpos - window < kpos <= qpos) and
// tanh softcap, both on the f32 scores; scale 1/sqrt(D); masked keys get
// p = 0 exactly; output acc / max(l, 1e-30) in q's dtype, so a row with no
// unmasked key gives 0.
//
// Bound on the H100: at the serving shapes (prefill B=8, S=256, H=32,
// D=128; GSI scoring B=16, S=64) the causal work is 4*D flops per kept
// (query, key) pair and head, 4.31 GFLOP at the prefill shape (4.4 us at
// 989 TFLOP/s bf16), against 67.1 MB of q, k, v and out (20 us at 3.35
// TB/s): the bytes bound it.
//
// Two bodies, chosen by dtype in rap_flash_attention:
//
// bf16 / fp16: FlashAttention-2 on the warp-level tensor cores. One CTA of
// 4 warps per (64-row q tile, head, batch), each warp owning 16 query
// rows. 64-row tiles rather than 128 on 8 warps: the prefill shape still
// gives 1024 CTAs and the scoring shape 512 over 132 SMs, and at DT = 128
// a 4-warp CTA's registers and 80 KB of shared memory let two CTAs share
// an SM (8 warps of 128 rows would hold one). Templated over the padded
// head width DT in {64, 128, 256}: columns D..DT-1 are zero in shared
// memory, add nothing to q.k and are never stored. The Q tile is loaded
// once; K and V tiles of 64 keys go through a two-stage ring in shared
// memory filled with 16-byte cp.async.cg (rows past Skv zero-filled with
// src-size 0), K and V as separate groups: tile j+1's K loads while tile j
// computes S, its V while tile j computes P.V, and tile j's V may still be
// landing while its S is computed. Where D % 8 != 0 (or a pointer is not
// 16-byte aligned) the same ring is filled by a plain element loader.
// Shared rows are XOR-swizzled in 16-byte chunks (chunk ^ (row & 7)) so
// every ldmatrix is free of bank conflicts. S = Q.K^T runs on mma.sync
// m16n8k16 with f32 accumulation (Q A-fragments held in registers for
// DT <= 128, re-read by ldmatrix for each KV tile at DT = 256, where the
// f32 O accumulator alone takes 128 registers a thread). Scale, softcap
// and masks apply to the f32 scores, the masks only on tiles that
// straddle the diagonal, the band's edge or the ragged KV edge. The
// online softmax keeps m and l in f32 (l sums the f32 p; a row lives in
// one quad, so its max is two shuffles). P is rounded to T in registers
// and fed to O += P.V as the A operand (the accumulator layout of
// m16n8k16 is its A layout), with V read by ldmatrix.trans. Rounding P to
// bf16 before P.V is what the plain version and the JAX reference do; the
// FMA kernel that ran bf16 before this body kept f32 probabilities and
// rounded only the output. KV tiles run from the band's left edge to the
// causal diagonal (tiles above it are never loaded), and the longest
// causal q tiles are handed out first so the last wave is short. Each
// warp writes its normalised rows into its own Q rows of shared memory,
// then out in 16-byte row chunks.
//
// f32: the first port's body, kept as it was: 32x32 shared-memory tiles on
// f32 FMA, one query row per four threads. The f32 models' card-vs-CPU
// reference and the 1e-4 tolerance rest on full-f32 products; TF32 keeps
// about three digits, and no serve runs f32.
//
// A later change would add TMA loads, wgmma on 64-row warpgroups and warp
// specialisation (a producer warp keeping the ring full).
#include "common.cuh"

#include <stdint.h>
#include <type_traits>

// ---------------------------------------------------------------- f32 body

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = 128;   // 4 threads per query row

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int K, int D, float scale, float softcap, int causal,
             int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DP = D + 1;
  float* Qs = reinterpret_cast<float*>(smem);   // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;                    // [kBK][DP]
  float* Vs = Ks + kBK * DP;                    // [kBK][DP]
  float* Ps = Vs + kBK * DP;                    // [kBQ][kBK + 1]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int qi = q0 + r;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D, qq = q0 + rr;
    Qs[rr * DP + d] = qq < Sq
        ? to_f32(q[(((long long)b * Sq + qq) * H + h) * D + d]) : 0.f;
  }

  float acc[DMAX / 4];
#pragma unroll
  for (int i = 0; i < DMAX / 4; ++i) acc[i] = 0.f;
  float m_i = RAP_NEG_INF, l_i = 0.f;

  // kv tiles that can hold an unmasked key for some row of this q tile
  const int k_end = causal ? min(Skv, q0 + kBQ) : Skv;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q loaded / previous tile consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int cc = i / D, d = i - cc * D, kj = k0 + cc;
      const long long off = (((long long)b * Skv + kj) * K + kvh) * D + d;
      Ks[cc * DP + d] = kj < Skv ? to_f32(k[off]) : 0.f;
      Vs[cc * DP + d] = kj < Skv ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[kBK / 4];
    unsigned ok = 0;
    float mx = RAP_NEG_INF;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const int cc = c4 + 4 * j, kj = k0 + cc;
      const float* qr = Qs + r * DP;
      const float* kr = Ks + cc * DP;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      float sv = dot * scale;
      if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
      bool keep = kj < Skv && qi < Sq;
      if (causal) keep = keep && kj <= qi;
      if (window > 0) keep = keep && kj > qi - window;
      s[j] = keep ? sv : RAP_NEG_INF;
      ok |= (unsigned)keep << j;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = ((ok >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      Ps[r * (kBK + 1) + c4 + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = alpha * l_i + psum;
    m_i = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) {
      const int d = c4 + 4 * i;
      if (d < D) {
        float a = acc[i] * alpha;
        const float* pr = Ps + r * (kBK + 1);
        for (int cc = 0; cc < kBK; ++cc) a += pr[cc] * Vs[cc * DP + d];
        acc[i] = a;
      }
    }
  }

  if (qi < Sq) {
    T* o = out + (((long long)b * Sq + qi) * H + h) * D;
    const float inv = 1.0f / fmaxf(l_i, 1e-30f);
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) {
      const int d = c4 + 4 * i;
      if (d < D) o[d] = from_f32<T>(acc[i] * inv);
    }
  }
}

template <typename T, int DMAX>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Skv, int H, int K, int D, float scale,
                  float softcap, int causal, int window, cudaStream_t s) {
  const size_t smem =
      (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1)) * sizeof(float);
  auto kern = flash_kernel<T, DMAX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, s>>>((const T*)q, (const T*)k, (const T*)v,
                                    (T*)out, Sq, Skv, H, K, D, scale, softcap,
                                    causal, window);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------ bf16 / fp16 body
namespace tc {

constexpr int kBQ = 64;        // q rows per CTA: 4 warps x 16
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kBK, "load_tile fills the 64-row tiles of Q, K and V");

// element offset of (row, col) in a [rows][DT] tile whose 16-byte chunks
// are XOR-swizzled by the row's low three bits
template <int DT>
__device__ __forceinline__ int swz(int row, int col) {
  return row * DT + (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), f32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two f32 rounded to T, the first in the low half
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
}

// rows [row0, row0 + 64) of a [*, stride] tensor (row n valid when n <
// nrows, column d when d < D) into a swizzled [64][DT] tile, zero-filled
template <typename T, int DT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int nrows, long long stride, int D,
                                          bool vec, int tid) {
  if (vec) {  // D % 8 == 0 and 16-byte aligned rows: cp.async per chunk
    constexpr int CH = DT / 8;
#pragma unroll
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const bool ok = row0 + r < nrows && c * 8 < D;
      const T* g = ok ? src + (long long)(row0 + r) * stride + c * 8 : src;
      cp_async16(dst + r * DT + ((c ^ (r & 7)) << 3), g, ok);
    }
  } else {
    for (int i = tid; i < kBK * DT; i += kThreads) {
      const int r = i / DT, d = i % DT;
      T x = from_f32<T>(0.f);
      if (row0 + r < nrows && d < D) x = src[(long long)(row0 + r) * stride + d];
      dst[swz<DT>(r, d)] = x;
    }
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int B, int Sq,
                int Skv, int H, int K, int D, float scale, float softcap,
                int causal, int window, int nq, int vec) {
  constexpr bool kHoldQ = DT <= 128;
  constexpr int NT = kBK / 8;    // n-tiles of S per warp
  constexpr int DTILES = DT / 8; // n-tiles of O per warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [kBQ][DT]
  T* Ks = Qs + kBQ * DT;               // [2][kBK][DT]
  T* Vs = Ks + 2 * kBK * DT;           // [2][kBK][DT]

  // the longest causal q tiles first: q tile is the slowest grid index,
  // counted down
  int bid = blockIdx.x;
  const int h = bid % H;
  bid /= H;
  const int b = bid % B;
  const int q0 = (nq - 1 - bid / B) * kBQ;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qstride = (long long)H * D, kvstride = (long long)K * D;
  const T* qb = q + (long long)b * Sq * qstride + (long long)h * D;
  const T* kb = k + (long long)b * Skv * kvstride + (long long)kvh * D;
  const T* vb = v + (long long)b * Skv * kvstride + (long long)kvh * D;

  // kv tiles that can hold an unmasked key for some row of this q tile
  const int k_end = causal ? min(Skv, q0 + kBQ) : Skv;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  // two cp.async groups a tile, K then V, so Q K^T starts while V lands
  load_tile<T, DT>(Qs, qb, q0, Sq, qstride, D, vec, tid);
  if (n_tiles > 0) load_tile<T, DT>(Ks, kb, k_begin, Skv, kvstride, D, vec, tid);
  cp_async_commit();
  if (n_tiles > 0) load_tile<T, DT>(Vs, vb, k_begin, Skv, kvstride, D, vec, tid);
  cp_async_commit();

  float o[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = RAP_NEG_INF, m1 = RAP_NEG_INF;  // rows g and g + 8, log2 units
  float l0 = 0.f, l1 = 0.f;                  // this thread's share of l
  unsigned qf[kHoldQ ? DT / 16 : 1][4];

  const int qw0 = q0 + warp * 16;            // this warp's first row
  const int r0 = qw0 + g, r1 = r0 + 8;
  // ldmatrix row/column of this lane: A (Q) and V^T share one pattern
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const float sl = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBK;
    const int st = it & 1;
    const bool next = it + 1 < n_tiles;
    cp_async_wait<1>();  // K of this tile (and Q); its V may be in flight
    __syncthreads();
    const T* Kt = Ks + st * kBK * DT;
    const T* Vt = Vs + st * kBK * DT;
    // the next tile's K into the other stage, whose last reader (the
    // previous tile's Q K^T) every warp has passed
    if (next)
      load_tile<T, DT>(Ks + (st ^ 1) * kBK * DT, kb, k0 + kBK, Skv, kvstride,
                       D, vec, tid);
    cp_async_commit();
    if constexpr (kHoldQ) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk)
          ldsm_x4(qf[kk], Qs + swz<DT>(warp * 16 + a_row, kk * 16 + a_col));
      }
    }

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      unsigned qa[4];
      if constexpr (kHoldQ) {
        qa[0] = qf[kk][0]; qa[1] = qf[kk][1]; qa[2] = qf[kk][2]; qa[3] = qf[kk][3];
      } else {
        ldsm_x4(qa, Qs + swz<DT>(warp * 16 + a_row, kk * 16 + a_col));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned kf[4];
        ldsm_x4(kf, Kt + swz<DT>(np * 16 + b_row, kk * 16 + b_col));
        mma<T>(s[2 * np], qa, kf[0], kf[1]);
        mma<T>(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // scale and softcap in f32, then to log2 units
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = softcap * tanhf(s[j][e] * scale / softcap) * kLog2e;
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sl;
    }
    // masks only where the tile straddles the ragged edge, the causal
    // diagonal or the band's edge for one of this warp's rows
    unsigned keep = 0xffffffffu;  // bit 4 * j + e
    const bool need_mask = k0 + kBK > Skv || (causal && k0 + kBK - 1 > qw0) ||
                           (window > 0 && k0 <= qw0 + 15 - window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = e < 2 ? r0 : r1;
          bool ok = kj < Skv;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          if (!ok) {
            s[j][e] = RAP_NEG_INF;
            keep &= ~(1u << (4 * j + e));
          }
        }
    }

    // online softmax; a row's 64 scores sit in one quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (keep >> (4 * j + e)) & 1u
                            ? exp2f(s[j][e] - (e < 2 ? m0 : m1)) : 0.f;
        s[j][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    l0 = alpha0 * l0 + ps0;
    l1 = alpha1 * l1 + ps1;
#pragma unroll
    for (int i = 0; i < DTILES; ++i) {
      o[i][0] *= alpha0; o[i][1] *= alpha0;
      o[i][2] *= alpha1; o[i][3] *= alpha1;
    }

    cp_async_wait<1>();  // V of this tile; the next tile's K may be in flight
    __syncthreads();
    // the next tile's V into the other stage, past the previous tile's P V
    if (next)
      load_tile<T, DT>(Vs + (st ^ 1) * kBK * DT, vb, k0 + kBK, Skv, kvstride,
                       D, vec, tid);
    cp_async_commit();

    // O += P V: P rounded to T in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned pa[4];
      pa[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DTILES / 2; ++dp) {
        unsigned vf[4];
        ldsm_x4_t(vf, Vt + swz<DT>(kk * 16 + a_row, dp * 16 + a_col));
        mma<T>(o[2 * dp], pa, vf[0], vf[1]);
        mma<T>(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (n_tiles == 0) __syncthreads();  // every thread's Q copy has landed

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  // the output through this warp's own Q rows (no other warp reads them),
  // then out to global memory in 16-byte row chunks
  const int w0 = warp * 16;
#pragma unroll
  for (int i = 0; i < DTILES; ++i) {
    const int d = i * 8 + 2 * t;
    *reinterpret_cast<unsigned*>(Qs + swz<DT>(w0 + g, d)) =
        pack2<T>(o[i][0] * inv0, o[i][1] * inv0);
    *reinterpret_cast<unsigned*>(Qs + swz<DT>(w0 + g + 8, d)) =
        pack2<T>(o[i][2] * inv1, o[i][3] * inv1);
  }
  __syncwarp();
  constexpr int CH = DT / 8;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int rr = c / CH, ch = c % CH, qi = qw0 + rr;
    if (qi >= Sq || ch * 8 >= D) continue;
    T* dst = out + (((long long)b * Sq + qi) * H + h) * D + ch * 8;
    const T* src = Qs + (w0 + rr) * DT + ((ch ^ (rr & 7)) << 3);
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && ch * 8 + e < D; ++e) dst[e] = src[e];
    }
  }
}

template <typename T, int DT>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Skv, int H, int K, int D, float scale,
                  float softcap, int causal, int window, cudaStream_t s) {
  const size_t smem = (size_t)(kBQ + 4 * kBK) * DT * sizeof(T);
  auto kern = flash_tc_kernel<T, DT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nq = (Sq + kBQ - 1) / kBQ;
  const long long n_blocks = (long long)nq * B * H;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte row chunks need D % 8 == 0 and 16-byte aligned tensors
  const int vec = D % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  kern<<<(unsigned)n_blocks, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, B, Sq, Skv, H, K, D,
      scale, softcap, causal, window, nq, vec);
  return (int)cudaGetLastError();
}

}  // namespace tc

// All tensors contiguous, one dtype; D <= 256. f32 runs the FMA body,
// bf16 and fp16 the tensor-core body.
extern "C" int rap_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int H,
                                   int K, int D, float scale, float softcap,
                                   int causal, int window, int dtype,
                                   void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (D > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RAP_FLASH_BY_WIDTH(NS, T)                                           \
  return D <= 64    ? NS launch<T, 64>(q, k, v, out, B, Sq, Skv, H, K, D,  \
                                       scale, softcap, causal, window, s)  \
         : D <= 128 ? NS launch<T, 128>(q, k, v, out, B, Sq, Skv, H, K, D, \
                                        scale, softcap, causal, window, s) \
                    : NS launch<T, 256>(q, k, v, out, B, Sq, Skv, H, K, D, \
                                        scale, softcap, causal, window, s)
  switch (dtype) {
    case 0: RAP_FLASH_BY_WIDTH(, float);
    case 1: RAP_FLASH_BY_WIDTH(tc::, __nv_bfloat16);
    case 2: RAP_FLASH_BY_WIDTH(tc::, __half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RAP_FLASH_BY_WIDTH
}
