// Chunked SSD scan of the Mamba-2 mixer: xh [B,T,H,P], log_a [B,T,H],
// Bm/Cm [B,T,N] (one group, shared by every head), all f32 → y [B,T,H,P]
// and the final state [B,H,P,N], f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd (_kernel).
// Within a chunk of Q tokens y = (C·Bᵀ ⊙ L)·x + (C·stateᵀ) ⊙ exp(a_cum),
// with L[q,s] = exp(a_cum[q] - a_cum[s]) for s <= q; across chunks the
// [P, N] state carries as state·exp(total) + (x ⊙ exp(total - a_cum))ᵀ·B.
//
// Bound on the H100 by operations: at mamba2-370m's prefill shape (B=8,
// T=256, H=32, P=64, N=128, one chunk) the products need 2.22 GFLOP (C·Bᵀ
// once per batch row and chunk, (C·Bᵀ ⊙ L)·x and the chunk's state per
// head; C·stateᵀ only after the first chunk, whose carried state is zero)
// against 44.3 MB of inputs and outputs: 33 us at the card's 67 TFLOP/s of
// f32 FMA, 13 us of bytes at 3.35 TB/s (NVIDIA's data sheet for the SXM
// part at 700 W). The TPU kernel walks the chunks of one (batch, head) in
// order with the state in VMEM; a first port did the same on the GPU (one
// CTA per (batch, head), every product a dot product from shared memory)
// and ran slower than cuBLAS einsums.
//
// Design: the standard GPU decomposition of the chunked scan, every
// product on the tensor cores at f32 accuracy, from one entry point:
//   1. ssd_chunk_kernel, two kinds of CTA in one grid, all in parallel:
//      - per (batch, chunk, query tile, key tile up to the diagonal): one
//        64 x 64 tile of G = C·Bᵀ into a scratch the wrapper allocates.
//        With one group G is the same for every head, so it is computed
//        once per (batch, chunk), not per head. Both tiles are loaded at
//        full depth N, so N is bounded by shared memory: rap_ssd refuses a
//        width whose two tiles do not fit a block.
//      - per (batch, head, chunk, 64 x 64 tile of [P, N]): the chunk's own
//        state (x ⊙ exp(total - a_cum))ᵀ·B, over the chunk's key tiles;
//        with one chunk it is the final state.
//   2. ssd_pass_kernel (more than one chunk only), per (batch, head, block
//      of the state): the sequential, elementwise passing of the state
//      across chunks, with each chunk's decay exp(total) as its state CTAs
//      wrote it. Each chunk's slot of the scratch becomes the state entering
//      that chunk; the last sum is the final state.
//   3. ssd_out_kernel, per (batch, head, chunk, 64-row query tile, 64-wide
//      tile of P), longest query tiles first: y = exp(a_cum) ⊙ (C·sᵀ) over
//      N, skipped on the first chunk, plus (G ⊙ L)·x over the key tiles up
//      to the diagonal. G ⊙ L is formed in f32 registers from the G tile,
//      L = exp2((a_cum[q] - a_cum[s]) · log2 e) taken only where s <= q
//      (the upper triangle would overflow, and 0 · inf is NaN), and only
//      then split as the A operand.
// At the prefill shape that is 1024 output CTAs (512 at the GSI scoring
// shape B=16, T=64; 128 at batch 1), where the first port ran 256, 512 and
// 32 CTAs walking their query tiles one after another.
//
// Products: mma.sync m16n8k8 TF32 with the three-pass split of CUTLASS's
// 3xTF32: each f32 operand a = a_hi + a_lo (a_hi rounded to TF32, a_lo the
// rounded rest), and a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed in the f32
// accumulators: about f32's accuracy, where one TF32 pass keeps about three
// digits. A CTA is 8 warps, 4 x 2 over a 64 x 64 output tile, each warp
// 16 x 32. Operand tiles come in by 16-byte cp.async (zero-filled past the
// edges) into a two-stage ring, so the next tile loads while this one
// multiplies. Each warp reads its fragments' f32 values from shared memory
// and splits them in registers; shared rows are padded so every fragment
// read is free of bank conflicts: a tile read with the warp's 8 row groups
// along its rows has a row stride of 4 mod 32 floats, one read with the 4
// lanes of a group along its rows 8 mod 32. The launch bounds hold a CTA
// to 85 registers a thread, so three fit an SM, as their shared memory
// does. Where P or N is not a multiple of 4, or a pointer is not 16-byte
// aligned, the same tiles are filled by plain loads. What bounds this
// design is the work of forming the fragments (loads, exp2, split), not the
// tensor cores: a later design would split each operand once into shared
// memory and multiply with wgmma.
//
// Determinism: no atomics, every sum in a fixed order; two launches give
// the same bits. The prefix sum of log_a is taken by one function
// (chunk_cumsum) wherever it is used, so each kernel sees the same a_cum.
// A ragged last chunk is simply shorter (JAX pads with x = 0, log_a = 0,
// which changes neither y nor the state).
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows and columns of every tile
constexpr int kMaxQ = 256;      // longest chunk
constexpr int kThreads = 256;   // 8 warps, 4 x 2 over a 64 x 64 tile
constexpr int kSG = kT + 4;     // row stride of a tile read along g (4 mod 32)
constexpr int kST = kT + 8;     // row stride of a tile read along t (8 mod 32)
constexpr int kPassThreads = 256;

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

// rows [0, 64) and columns [0, cols) of a row-major source (ld floats a
// row) into dst (S floats a row); row r is read when r < nr, column j when
// j < nc, zero elsewhere. vec: 16-byte cp.async (nc % 4 == 0, aligned rows)
__device__ __forceinline__ void load_tile(float* dst, int S, const float* src,
                                          long long ld, int nr, int nc,
                                          int cols, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int ch = cols >> 2;
    for (int i = tid; i < kT * ch; i += kThreads) {
      const int r = i / ch, j = (i - r * ch) << 2;
      const bool ok = r < nr && j < nc;
      cp_async16(dst + r * S + j, ok ? src + r * ld + j : src, ok);
    }
  } else {
    for (int i = tid; i < kT * cols; i += kThreads) {
      const int r = i / cols, j = i - r * cols;
      dst[r * S + j] = (r < nr && j < nc) ? src[r * ld + j] : 0.f;
    }
  }
}

// a rounded to TF32, nearest with ties away from zero (cvt.rna's bits):
// half a TF32 ulp added to the magnitude, the 13 low bits cleared; two
// integer operations where the conversion instruction is slower
__device__ __forceinline__ unsigned tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32: the operands of 3xTF32
__device__ __forceinline__ void split(float a, unsigned& hi, unsigned& lo) {
  hi = tf32(a);
  lo = tf32(a - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A[64 x 64] · B[64 x 64] at f32 accuracy (3xTF32); a_at(row, k)
// and b_at(k, col) read the operands' f32 values (zeros past a tile's
// edge, so every step is a whole 64-deep tile, unrolled). Warp w owns rows
// 16·(w >> 1) + [0, 16) and columns 32·(w & 1) + [0, 32): acc[ni][e] is
// row 16·(w >> 1) + g + 8·(e >> 1), column 32·(w & 1) + 8·ni + 2·t +
// (e & 1), with g = lane / 4, t = lane % 4.
template <class FA, class FB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], FA a_at,
                                         FB b_at) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = (warp >> 1) * 16 + g, n0 = (warp & 1) * 32;
#pragma unroll
  for (int k = 0; k < kT; k += 8) {
    unsigned ah[4], al[4], bh[4][2], bl[4][2];
    split(a_at(r, k + t), ah[0], al[0]);
    split(a_at(r + 8, k + t), ah[1], al[1]);
    split(a_at(r, k + t + 4), ah[2], al[2]);
    split(a_at(r + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + ni * 8 + g;
      split(b_at(k + t, c), bh[ni][0], bl[ni][0]);
      split(b_at(k + t + 4, c), bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {  // the small terms first
      mma_tf32(acc[ni], al, bh[ni]);
      mma_tf32(acc[ni], ah, bl[ni]);
      mma_tf32(acc[ni], ah, bh[ni]);
    }
  }
}

// the accumulator tile into dst (ld floats a row): rows < nr, columns < nc
__device__ __forceinline__ void store_tile(float* dst, long long ld,
                                           const float (&acc)[4][4], int nr,
                                           int nc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + 8 * (e >> 1);
      const int c = n0 + ni * 8 + 2 * t + (e & 1);
      if (r < nr && c < nc) dst[r * ld + c] = acc[ni][e];
    }
  }
}

// acum[i] = log_a[0] + ... + log_a[i] over the chunk's rows i < qn of one
// head (la: the chunk's first row at that head, rows H floats apart), zero
// from qn to kMaxQ. Every kernel takes it here, in one order: each lane of
// warp 0 sums a run of consecutive rows, then the runs' totals are scanned
// with shuffles. Called by every thread of the block.
__device__ void chunk_cumsum(const float* la, int H, int qn, float* acum) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kMaxQ; i += blockDim.x)
    acum[i] = i < qn ? la[(long long)i * H] : 0.f;
  __syncthreads();
  if (tid < 32) {
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
}

struct Dims {
  int B, T, H, P, N, Q;
  int nc;      // chunks
  int nqt;     // 64-row tiles of a full chunk
  int qp;      // G's row length: nqt · 64
  int npairs;  // causal (query tile, key tile) pairs of a full chunk
  int npt;     // 64-wide tiles of P
  int nnt;     // 64-wide tiles of N
  int ns;      // row stride of the full-depth tiles of C and B
  int vec;     // 16-byte loads
};

__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_kernel(const float* __restrict__ xh, const float* __restrict__ la,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ G, float* __restrict__ st, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float acc[4][4] = {};
  int bid = blockIdx.x;
  const int nG = d.B * d.nc * d.npairs;
  if (bid < nG) {
    // one causal tile of G = C·Bᵀ of one (batch, chunk), at full depth
    int ki = bid % d.npairs, qi = 0;
    bid /= d.npairs;
    while (ki > qi) { ki -= qi + 1; ++qi; }
    const int c = bid % d.nc, b = bid / d.nc;
    const int c0 = c * d.Q, qn = min(d.Q, d.T - c0);
    const int q0 = qi * kT, k0 = ki * kT;
    if (q0 >= qn) return;                     // a ragged chunk's missing tile
    float* Cs = sm;                           // [64][ns]
    float* Bs = Cs + kT * d.ns;               // [64][ns]
    const int cols = (d.N + kT - 1) & ~(kT - 1);
    const long long row0 = (long long)b * d.T + c0;
    load_tile(Cs, d.ns, Cm + (row0 + q0) * d.N, d.N, qn - q0, d.N, cols,
              d.vec);
    load_tile(Bs, d.ns, Bm + (row0 + k0) * d.N, d.N, qn - k0, d.N, cols,
              d.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int ns = d.ns;
    for (int n0 = 0; n0 < cols; n0 += kT)
      mma_tile(acc, [&](int r, int k) { return Cs[r * ns + n0 + k]; },
               [&](int k, int s) { return Bs[s * ns + n0 + k]; });
    // the whole tile: rows and columns past qn hold zeros
    store_tile(G + (((long long)b * d.nc + c) * d.qp + q0) * d.qp + k0, d.qp,
               acc, kT, kT);
    return;
  }

  // one 64 x 64 tile of the chunk's own state (x ⊙ exp(total - a_cum))ᵀ·B
  bid -= nG;
  const int nt = bid % d.nnt;
  bid /= d.nnt;
  const int pt = bid % d.npt;
  bid /= d.npt;
  const int h = bid % d.H;
  bid /= d.H;
  const int b = bid % d.B, c = bid / d.B;
  const int c0 = c * d.Q, qn = min(d.Q, d.T - c0);
  const int p0 = pt * kT, n0 = nt * kT;
  float* acum = sm;                           // [kMaxQ]
  float* w = acum + kMaxQ;                    // [kMaxQ]: exp(total - a_cum)
  float* ring = w + kMaxQ;                    // [2][x tile, B tile], kST
  const long long row0 = (long long)b * d.T + c0;
  const long long ldx = (long long)d.H * d.P;
  const float* xb = xh + row0 * ldx + (long long)h * d.P + p0;
  const float* bb = Bm + row0 * d.N + n0;
  const int steps = (qn + kT - 1) / kT;
  auto load = [&](int s) {
    float* xs = ring + (s & 1) * 2 * kT * kST;
    const int r0 = s * kT;
    load_tile(xs, kST, xb + r0 * ldx, ldx, qn - r0, d.P - p0, kT, d.vec);
    load_tile(xs + kT * kST, kST, bb + (long long)r0 * d.N, d.N, qn - r0,
              d.N - n0, kT, d.vec);
  };
  load(0);
  cp_async_commit();
  chunk_cumsum(la + row0 * d.H + h, d.H, qn, acum);
  const float total = acum[qn - 1];
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads)
    w[i] = i < qn ? expf(total - acum[i]) : 0.f;
  if (d.nc > 1 && pt == 0 && nt == 0 && threadIdx.x == 0)  // for the pass
    st[(long long)d.B * d.nc * d.H * d.P * d.N + (b * d.nc + c) * d.H + h] =
        expf(total);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                          // tile s (and w) visible
    const float* xs = ring + (s & 1) * 2 * kT * kST;
    const float* bs = xs + kT * kST;
    const float* ws = w + s * kT;
    // A[p][s] = x[s][p] · w[s], B[s][n]
    mma_tile(acc, [&](int r, int k) { return xs[k * kST + r] * ws[k]; },
             [&](int k, int n) { return bs[k * kST + n]; });
    __syncthreads();                          // stage s & 1 is refilled next
  }
  // with one chunk this is the final state [B][H][P][N]
  store_tile(st + ((((long long)b * d.nc + c) * d.H + h) * d.P + p0) * d.N +
                 n0,
             d.N, acc, d.P - p0, d.N - n0);
}

// st: [B][nc][H][P][N] chunk states, then [B][nc][H] decays exp(total)
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(float* __restrict__ st, float* __restrict__ fin, Dims d) {
  const int b = blockIdx.x / d.H, h = blockIdx.x - b * d.H;
  const long long PN = (long long)d.P * d.N;
  const long long e = (long long)blockIdx.y * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  const float* decay = st + (long long)d.B * d.nc * d.H * PN;
  long long bch = (long long)b * d.nc * d.H + h;   // (b, chunk 0, h)
  float run = 0.f, own = st[bch * PN + e];
  for (int c = 0; c < d.nc; ++c, bch += d.H) {
    // chunk c + 1's load and chunk c's decay are issued before the store
    const float next = c + 1 < d.nc ? st[(bch + d.H) * PN + e] : 0.f;
    const float dc = decay[bch];
    st[bch * PN + e] = run;                   // the state entering chunk c
    run = run * dc + own;
    own = next;
  }
  fin[((long long)b * d.H + h) * PN + e] = run;
}

__global__ void __launch_bounds__(kThreads, 3)
ssd_out_kernel(const float* __restrict__ xh, const float* __restrict__ la,
               const float* __restrict__ Cm, const float* __restrict__ G,
               const float* __restrict__ st, float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float sm[];
  int bid = blockIdx.x;
  const int pt = bid % d.npt;
  bid /= d.npt;
  const int h = bid % d.H;
  bid /= d.H;
  const int b = bid % d.B;
  bid /= d.B;
  const int c = bid % d.nc;
  const int qi = d.nqt - 1 - bid / d.nc;      // longest query tiles first
  const int c0 = c * d.Q, qn = min(d.Q, d.T - c0);
  const int q0 = qi * kT, p0 = pt * kT;
  if (q0 >= qn) return;                       // a ragged chunk's missing tile
  float* acum = sm;                           // [kMaxQ]
  float* ring = acum + kMaxQ;                 // [2][A tile kSG, B tile kST]
  constexpr int kStage = kT * kSG + kT * kST;
  const long long row0 = (long long)b * d.T + c0;
  const long long ldx = (long long)d.H * d.P;
  const float* cb = Cm + (row0 + q0) * d.N;
  const float* sb = st + ((((long long)b * d.nc + c) * d.H + h) * d.P + p0) *
                             d.N;
  const float* gb = G + (((long long)b * d.nc + c) * d.qp + q0) * d.qp;
  const float* xb = xh + row0 * ldx + (long long)h * d.P + p0;
  // the carried state's steps over N (none on the first chunk, whose state
  // is zero), then the key tiles up to the diagonal
  const int nsa = c > 0 ? (d.N + kT - 1) / kT : 0;
  const int steps = nsa + qi + 1;
  auto load = [&](int s) {
    float* as = ring + (s & 1) * kStage;
    float* bs = as + kT * kSG;
    if (s < nsa) {                            // C [q][n], state [p][n]
      const int n0 = s * kT;
      load_tile(as, kSG, cb + n0, d.N, qn - q0, d.N - n0, kT, d.vec);
      load_tile(bs, kSG, sb + n0, d.N, d.P - p0, d.N - n0, kT, d.vec);
    } else {                                  // G [q][s], x [s][p]
      const int k0 = (s - nsa) * kT;
      load_tile(as, kSG, gb + k0, d.qp, kT, kT, kT, true);
      load_tile(bs, kST, xb + k0 * ldx, ldx, qn - k0, d.P - p0, kT, d.vec);
    }
  };
  load(0);
  cp_async_commit();
  chunk_cumsum(la + row0 * d.H + h, d.H, qn, acum);
  float acc[4][4] = {};
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                          // tile s visible
    const float* as = ring + (s & 1) * kStage;
    const float* bs = as + kT * kSG;
    if (s < nsa) {
      mma_tile(acc, [&](int r, int k) { return as[r * kSG + k]; },
               [&](int k, int p) { return bs[p * kSG + k]; });
      if (s == nsa - 1) {                     // C·sᵀ ⊙ exp(a_cum[q])
        const int r0 = q0 + (threadIdx.x >> 6) * 16 + ((threadIdx.x & 31) >> 2);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float f = expf(acum[r0 + 8 * hf]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            acc[ni][2 * hf] *= f;
            acc[ni][2 * hf + 1] *= f;
          }
        }
      }
    } else {
      const int k0 = (s - nsa) * kT;
      const float* aq = acum + q0;
      const float* ak = acum + k0;
      const int dq = q0 - k0;                 // key j <= query r: j <= r + dq
      mma_tile(acc, [&](int r, int k) {
                 return k <= r + dq
                            ? as[r * kSG + k] *
                                  exp2f((aq[r] - ak[k]) * 1.4426950408889634f)
                            : 0.f;
               },
               [&](int k, int p) { return bs[k * kST + p]; });
    }
    __syncthreads();                          // stage s & 1 is refilled next
  }
  store_tile(y + (row0 + q0) * ldx + (long long)h * d.P + p0, ldx, acc,
             qn - q0, d.P - p0);
}

template <typename K>
int fit(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) cudaGetLastError();  // clear it for the next launch
  return (int)e;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// All tensors contiguous f32. G: scratch [B][nc][qp][qp] with nc = ceil(T /
// Q), qp = 64·ceil(Q / 64); st: scratch [B][nc][H][P][N] chunk states
// followed by [B][nc][H] decays when nc > 1 (unused with one chunk).
// Returns cudaErrorInvalidValue for a chunk outside [1, 256], and
// cudaFuncSetAttribute's error (cleared) when a
// kernel's shared memory does not fit a block: the full-depth C and B
// tiles of G take 2 · 64 · (N + padding) floats.
extern "C" int rap_ssd(const void* xh, const void* la, const void* Bm,
                       const void* Cm, void* y, void* fin, void* G, void* st,
                       int B, int T, int H, int P, int N, int Q,
                       void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  if (Q < 1 || Q > kMaxQ) return (int)cudaErrorInvalidValue;
  Dims d;
  d.B = B; d.T = T; d.H = H; d.P = P; d.N = N; d.Q = Q;
  d.nc = (T + Q - 1) / Q;
  d.nqt = (Q + kT - 1) / kT;
  d.qp = d.nqt * kT;
  d.npairs = d.nqt * (d.nqt + 1) / 2;
  d.npt = (P + kT - 1) / kT;
  d.nnt = (N + kT - 1) / kT;
  d.ns = ((N + kT - 1) & ~(kT - 1)) + 4;      // 4 mod 32
  d.vec = P % 4 == 0 && N % 4 == 0 && aligned16(xh) && aligned16(Bm) &&
          aligned16(Cm) && (d.nc == 1 || aligned16(st));
  const int g_tiles = 2 * kT * d.ns;
  const int state_ring = 2 * kMaxQ + 4 * kT * kST;
  const size_t smem_chunk =
      sizeof(float) * (size_t)(g_tiles > state_ring ? g_tiles : state_ring);
  const size_t smem_out =
      sizeof(float) * (size_t)(kMaxQ + 2 * kT * (kSG + kST));
  int e = fit(ssd_chunk_kernel, smem_chunk);
  if (e == 0) e = fit(ssd_out_kernel, smem_out);
  if (e != 0) return e;
  cudaStream_t s = (cudaStream_t)stream;
  float* own = d.nc == 1 ? (float*)fin : (float*)st;
  const long long n1 = (long long)B * d.nc * d.npairs +
                       (long long)B * d.nc * H * d.npt * d.nnt;
  ssd_chunk_kernel<<<(unsigned)n1, kThreads, smem_chunk, s>>>(
      (const float*)xh, (const float*)la, (const float*)Bm, (const float*)Cm,
      (float*)G, own, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (d.nc > 1) {
    const long long PN = (long long)P * N;
    dim3 grid((unsigned)(B * H),
              (unsigned)((PN + kPassThreads - 1) / kPassThreads));
    ssd_pass_kernel<<<grid, kPassThreads, 0, s>>>((float*)st, (float*)fin,
                                                  d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n3 = (long long)B * H * d.nc * d.nqt * d.npt;
  ssd_out_kernel<<<(unsigned)n3, kThreads, smem_out, s>>>(
      (const float*)xh, (const float*)la, (const float*)Cm, (const float*)G,
      (const float*)st, (float*)y, d);
  return (int)cudaGetLastError();
}
