// Causal flash attention for prefill: q [B,Sq,H,D], k/v [B,Skv,K,D].
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention. Query head h reads
// kv head h / G (G = H / K) by index; KV is never replicated. Optional band
// (`window` > 0: key kpos is kept when qpos - window < kpos <= qpos) and
// tanh softcap; scale 1/sqrt(D); output in q's dtype.
//
// Bound on the H100: at prefill lengths the work is 4*Sq*Skv*D flops per
// head against (Sq + 2*Skv)*D elements, i.e. by operations. This first
// version computes with f32 FMA from shared memory (no tensor cores: wgmma
// and TMA come in a later change), so it runs far below the bf16 tensor
// peak. Design: one CTA of 128 threads per (q tile of 32 rows, head h,
// batch b). The TPU kernel's sequential kv grid axis becomes a loop over kv
// tiles of 32 keys, from the band's left edge to the causal diagonal, so
// tiles above the diagonal are never loaded. Four threads own one query row:
// each computes 8 of the tile's 32 scores, the row max and sum are reduced
// over the four lanes with shuffles, and each thread keeps D/4 interleaved
// output columns in registers. Shared-memory rows are padded by one float
// so the eight rows a warp touches fall in distinct banks. The online
// softmax (m, l, acc) and the probabilities stay in f32; ragged Q and KV
// edges are masked, never padded in memory.
#include "common.cuh"

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

// All tensors contiguous, one dtype; D <= 256.
extern "C" int rap_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int H,
                                   int K, int D, float scale, float softcap,
                                   int causal, int window, int dtype,
                                   void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, {
    if (D <= 64)
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, K, D, scale, softcap, causal, window, s);
    if (D <= 128)
      return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, K, D, scale, softcap, causal, window, s);
    if (D <= 256)
      return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, K, D, scale, softcap, causal, window, s);
    return (int)cudaErrorInvalidValue;
  });
  return 0;
}
