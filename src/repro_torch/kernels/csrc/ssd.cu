// Chunked SSD scan of the Mamba-2 mixer: xh [B,T,H,P], log_a [B,T,H],
// Bm/Cm [B,T,N] (one group, shared by every head), all f32 → y [B,T,H,P]
// and the final state [B,H,P,N], f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd. Within a
// chunk of Q tokens y = (C·Bᵀ ⊙ L)·x + (C·stateᵀ) ⊙ exp(a_cum), with
// L[q,s] = exp(a_cum[q] - a_cum[s]) for s <= q; across chunks the [P, N]
// state carries as state·exp(total) + (x ⊙ exp(total - a_cum))ᵀ·B.
//
// Bound on the H100 by operations: per (batch, head, chunk) the four
// products cost 2Q²N + 2Q²P + 2QNP + 2PQN flops against (Q·P + Q + 2Q·N)
// floats read, all in f32 (no f32 tensor-core path), so the FP32 FMA rate
// sets the floor. Design: the TPU kernel keeps a whole 256-token chunk in
// VMEM (its L alone is 256 KB, more than a block's 227 KB), so it is not
// carried over. One CTA per (b, h) walks the chunks in order — the loop
// takes the place of the TPU's sequential grid axis — with the [P, N]
// state in shared memory across chunks. Inside a chunk, warp 0 takes the
// prefix sum of log_a; then 64-row query tiles meet 64-row key tiles up to
// the diagonal only (tiles above it are never loaded). exp(a_cum[q] -
// a_cum[s]) is evaluated only where s <= q: the upper triangle would
// overflow, and a 0/1 mask times inf is NaN. The state update follows the
// chunk's last query tile, so every query of the chunk reads the state the
// chunk started from. Shared-memory rows of B, C and the state are padded
// to N + 1 floats so a warp's 32 rows fall in distinct banks. A ragged last
// chunk is simply shorter (JAX pads with x = 0, log_a = 0, which changes
// neither y nor the state). All sums are in f32, by FMA from shared memory;
// C·Bᵀ is the same for every head and is recomputed per head here (a
// redesign can share it). Occupancy: B·H CTAs — 32 for a batch-1 mamba2
// prefill on 132 SMs.
#include "common.cuh"

constexpr int kQT = 64;        // query rows per tile
constexpr int kKT = 64;        // key rows per tile
constexpr int kMaxQ = 256;     // longest chunk
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ xh, const float* __restrict__ la,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           float* __restrict__ y, float* __restrict__ fin, int T, int H,
           int P, int N, int Q) {
  extern __shared__ __align__(16) float sm[];
  const int NP = N + 1;
  float* acum = sm;                    // [kMaxQ]
  float* Cs = acum + kMaxQ;            // [kQT][NP]
  float* Bs = Cs + kQT * NP;           // [kKT][NP]
  float* Xs = Bs + kKT * NP;           // [kKT][P]
  float* Ss = Xs + kKT * P;            // [kQT][kKT]
  float* Ys = Ss + kQT * kKT;          // [kQT][P]
  float* St = Ys + kQT * P;            // [P][NP]

  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const long long HP = (long long)H * P;
  const float* xb = xh + (long long)b * T * HP + (long long)h * P;
  const float* lb = la + (long long)b * T * H + h;
  const float* Bb = Bm + (long long)b * T * N;
  const float* Cb = Cm + (long long)b * T * N;
  float* yb = y + (long long)b * T * HP + (long long)h * P;

  for (int e = tid; e < P * N; e += kThreads) St[(e / N) * NP + e % N] = 0.f;

  for (int c0 = 0; c0 < T; c0 += Q) {
    const int qn = min(Q, T - c0);
    __syncthreads();                   // the last chunk's readers are done
    for (int i = tid; i < qn; i += kThreads)
      acum[i] = lb[(long long)(c0 + i) * H];
    __syncthreads();
    if (tid < 32) {
      // inclusive prefix sum: each lane sums a run of consecutive entries,
      // then the lanes' totals are scanned with shuffles
      const int per = (qn + 31) / 32;
      const int lo = min(tid * per, qn), hi = min(lo + per, qn);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) { run += acum[i]; acum[i] = run; }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float excl = incl - run;
      for (int i = lo; i < hi; ++i) acum[i] += excl;
    }
    __syncthreads();
    const float total = acum[qn - 1];

    for (int q0 = 0; q0 < qn; q0 += kQT) {
      const int nq = min(kQT, qn - q0);
      for (int e = tid; e < nq * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        Cs[r * NP + n] = Cb[(long long)(c0 + q0 + r) * N + n];
      }
      __syncthreads();
      // the carried state's part: exp(a_cum[q]) * C[q]·state[p]
      for (int e = tid; e < nq * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        const float* c = Cs + r * NP;
        const float* s = St + p * NP;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc += c[n] * s[n];
        Ys[r * P + p] = acc * expf(acum[q0 + r]);
      }
      const int kend = q0 + nq;        // keys up to the tile's last query
      for (int k0 = 0; k0 < kend; k0 += kKT) {
        const int nk = min(kKT, kend - k0);
        __syncthreads();               // the last key tile is consumed
        for (int e = tid; e < nk * N; e += kThreads) {
          const int r = e / N, n = e - r * N;
          Bs[r * NP + n] = Bb[(long long)(c0 + k0 + r) * N + n];
        }
        for (int e = tid; e < nk * P; e += kThreads) {
          const int r = e / P, p = e - r * P;
          Xs[r * P + p] = xb[(long long)(c0 + k0 + r) * HP + p];
        }
        __syncthreads();
        for (int e = tid; e < nq * kKT; e += kThreads) {
          const int r = e / kKT, s = e - r * kKT;
          float v = 0.f;
          if (s < nk && k0 + s <= q0 + r) {      // causal side only
            const float* c = Cs + r * NP;
            const float* bb = Bs + s * NP;
            float dot = 0.f;
            for (int n = 0; n < N; ++n) dot += c[n] * bb[n];
            v = dot * expf(acum[q0 + r] - acum[k0 + s]);
          }
          Ss[r * kKT + s] = v;
        }
        __syncthreads();
        for (int e = tid; e < nq * P; e += kThreads) {
          const int r = e / P, p = e - r * P;
          const float* sr = Ss + r * kKT;
          float acc = 0.f;
          for (int s = 0; s < nk; ++s) acc += sr[s] * Xs[s * P + p];
          Ys[r * P + p] += acc;
        }
      }
      for (int e = tid; e < nq * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        yb[(long long)(c0 + q0 + r) * HP + p] = Ys[r * P + p];
      }
      __syncthreads();                 // Cs is rewritten by the next tile
    }

    // state update, after every query of the chunk has read the old state
    const float dtot = expf(total);
    for (int e = tid; e < P * N; e += kThreads) St[(e / N) * NP + e % N] *= dtot;
    for (int k0 = 0; k0 < qn; k0 += kKT) {
      const int nk = min(kKT, qn - k0);
      __syncthreads();
      for (int e = tid; e < nk * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        Bs[r * NP + n] = Bb[(long long)(c0 + k0 + r) * N + n];
      }
      for (int e = tid; e < nk * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        Xs[r * P + p] = xb[(long long)(c0 + k0 + r) * HP + p]
                        * expf(total - acum[k0 + r]);
      }
      __syncthreads();
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        float acc = 0.f;
        for (int s = 0; s < nk; ++s) acc += Xs[s * P + p] * Bs[s * NP + n];
        St[p * NP + n] += acc;
      }
    }
  }
  __syncthreads();
  float* fb = fin + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) fb[e] = St[(e / N) * NP + e % N];
}

// All tensors contiguous f32. Returns cudaErrorInvalidValue for a chunk
// outside [1, 256], and cudaFuncSetAttribute's error when the shared memory
// below does not fit a block.
extern "C" int rap_ssd(const void* xh, const void* la, const void* Bm,
                       const void* Cm, void* y, void* fin, int B, int T,
                       int H, int P, int N, int Q, void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  if (Q < 1 || Q > kMaxQ) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      (kMaxQ + (size_t)(kQT + kKT) * (N + 1) + (size_t)kKT * P + kQT * kKT +
       (size_t)kQT * P + (size_t)P * (N + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)e;
    }
  }
  ssd_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xh, (const float*)la, (const float*)Bm, (const float*)Cm,
      (float*)y, (float*)fin, T, H, P, N, Q);
  return (int)cudaGetLastError();
}
