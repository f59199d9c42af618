// Flash attention for prefill, scoring and encoders: q [B,Sq,H,D], k/v
// [B,Skv,K,D], causal (top-left aligned: kpos <= qpos) or not.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention. Query head h reads
// kv head h / G (G = H / K) by index; KV is never replicated. Optional band
// (`window` > 0: key kpos is kept when kpos > qpos - window) and tanh
// softcap, both on the f32 scores; the scale comes from the caller
// (1/sqrt(D) of the unpadded D); masked keys get p = 0 exactly; output
// acc / max(l, 1e-30) in q's dtype, so a row with no kept key gives 0. No
// atomics and no split over keys: two launches give the same bits.
//
// Bound on the H100 (4*D operations per kept (query, key) pair and head;
// q, k, v and out each moved once): llama2-7b's prefill (B=8, S=256,
// H=K=32, D=128, causal) 0.0200 ms and GSI scoring (B=16, S=64) 0.0100 ms,
// recurrentgemma-9b's local attention (B=8, S=264, H=16, K=1, D=256)
// 0.0110 ms, all by bytes; whisper-medium's encoder (B=4, 1500 x 1500,
// H=K=16, D=64, non-causal) 0.0373 ms by operations.
//
// Two bodies, chosen by dtype in rap_flash_attention:
//
// bf16 / fp16: FlashAttention-3's shape on Hopper's own instructions (the
// helpers in hopper.cuh). One CTA per (q tile, head, batch): one or two
// consumer warpgroups of 64 query rows each and a producer warp, one
// thread of which issues every load. It loads the CTA's Q tile once and
// K and V tiles into a two-stage ring, by TMA from tensor maps built on
// the host for each call (4-D, innermost first: D, heads, S, B; boxes of
// 64 columns by 64 or BK rows with the 128-byte swizzle: one box at
// D <= 64, two at 128, four at 256; rows past Sq and Skv and columns past
// D arrive as zeros and are masked or never stored). K and V of a stage
// have a full mbarrier each (TMA transaction bytes) and an empty one (one
// arrival per consumer warp after the wgmma that read the stage has been
// waited on). A consumer warpgroup computes S = Q.K^T with wgmma
// m64nBKk16, both operands K-major from swizzled shared memory through
// descriptors; the online softmax runs on the f32 accumulators (a row's
// scores sit in one quad; one FFMA and one ex2 a score; masks only on
// tiles that straddle the ragged edge, the causal diagonal or the band's
// edge); P is rounded to T in registers and is wgmma's register A operand
// for O += P.V, V read MN-major (transposed) from the same swizzled tiles.
// The sections are straight-line so that ptxas can follow every wgmma
// group: tile j's Q.K^T is issued with tile j - 1's P.V, and tile j's
// softmax runs while that P.V computes; two warpgroups take turns at
// issuing (named barriers, FlashAttention-3's ping-pong), so one's
// softmax overlaps the other's products. Every warpgroup runs every KV
// tile of its CTA, the masks zeroing what its rows do not keep (a
// per-warpgroup skip put the wgmma under conditions, and ptxas then
// serialised them). KV tiles run from the band's left edge to the causal
// diagonal (tiles above it are never loaded), and the longest causal q
// tiles are handed out first so the last wave is short. Each warpgroup
// writes its normalised rows into its own Q tile (swizzled as TMA reads
// it) and stores them by TMA.
//
// Registers: ptxas gives a block of 288 threads at most 168 registers a
// thread (what 65536 / 384 allows, as for three warpgroups). setmaxnreg
// cannot raise that here: with a producer warpgroup (384 threads, 24 /
// 240 registers, the warpgroup index made warp-uniform) ptxas 12.9 still
// compiled the consumers within 168 (at D = 256 it spilled 528 bytes and
// serialised wgmma for want of registers), and beside a producer warp the
// consumers' increase would wait on registers that the 168-register pool
// of a 288-thread block does not hold. So the tiles are sized to fit
// instead (the static plan, kernels/flash_attention.py::plan,
// checked here): 128 query rows (two consumer warpgroups) where Sq > 64
// and D <= 128, else 64 rows (one); KV tiles of 128 keys at D <= 64 (O,
// S and P take 32 + 64 + 32 registers) and of 64 above (64 + 32 + 16 at
// D = 128; at D = 256 O alone is 128, and one warpgroup of 160 threads
// gets 212). Shared memory (Q, two stages of K and V, barriers): 74.8 KB
// (D <= 64, one warpgroup) to 164.9 KB (D = 256); two CTAs share an SM
// with one warpgroup at D <= 128, one does otherwise. The body takes
// D % 8 == 0 and 16-byte aligned tensors (TMA's rule); the wrapper pads D
// and copies a misaligned or strided view, so every bf16/fp16 call runs
// here. The tensor maps come from the CUDA driver's cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point (so the library links
// against the runtime alone); one encode takes 91-95 ns, four a call.
//
// Measured (tools/time_flash_kernel.py, A B B A against PR 16's mma.sync
// body in one call; NVIDIA H100 80GB HBM3, 700.00 W; device-only ms, sdpa
// and the share of the bound beside): prefill 0.0437-0.0448 (PR 16
// 0.0540-0.0557; sdpa 0.0361-0.0365; 45-46%), scoring 0.0221-0.0223
// (0.0242-0.0244; 0.0241-0.0244; 45%), recurrentgemma 0.0414-0.0467
// (0.0742-0.0745; 0.0420-0.0426; 24-27%), whisper's encoder 0.1129-0.1144
// (0.2682-0.2783; 0.1109-0.1145; 33%). The prefill stays behind sdpa: one
// 288-thread CTA an SM (the register cap), so each CTA's first loads and
// its epilogue are exposed over four waves, and both warpgroups run the
// diagonal tiles in full; 64-row tiles (two CTAs an SM) timed no better.
// -Xptxas -v: 138 registers at D = 128, 154 at D <= 64, 212 at D = 256;
// no spills, no serialised wgmma.
//
// f32: the first port's body, kept as it was: 32x32 shared-memory tiles on
// f32 FMA, one query row per four threads. The f32 models' card-vs-CPU
// reference and the 1e-4 tolerance rest on full-f32 products; TF32 keeps
// about three digits, and no serve runs f32.
#include "common.cuh"
#include "hopper.cuh"

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
namespace wg {

constexpr float kLog2e = 1.4426950408889634f;

// One instantiation's tiles: kWG consumer warpgroups of 64 query rows, KV
// tiles of BK keys in a ring of kStages, DT the head width padded to a
// whole number of 64-column boxes. Mirrored by
// kernels/flash_attention.py::plan.
template <int DT, int kWG>
struct Tiles {
  static constexpr int BQ = 64 * kWG;
  static constexpr int BK = DT == 64 ? 128 : 64;
  static constexpr int kStages = 2;
  static constexpr int kBoxes = DT / 64;
  // consumer warpgroups and one producer warp
  static constexpr int kThreads = 128 * kWG + 32;
  // two CTAs an SM where shared memory allows (D <= 128, one warpgroup)
  static constexpr int kMinBlocks = (kWG == 1 && DT <= 128) ? 2 : 1;
  // registers a thread: ptxas holds a block of 288 to 168 (as it would a
  // block of three warpgroups), which the tiles fit: O, S and P take 64 +
  // 32 + 16 at D = 128 and 32 + 64 + 32 at D = 64. At D = 256 (one
  // warpgroup, 160 threads) O alone is 128 and the kernel takes 202.
  static constexpr int kQBytes = BQ * DT * 2;
  static constexpr int kKVBytes = BK * DT * 2;  // one stage of K or of V
  static constexpr int kBars = 1 + 4 * kStages;
  // 1024 bytes to align the tiles for the 128-byte swizzle
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars;
};

// named barriers: 1 + w for warpgroup w's epilogue, kSchedBar + w for the
// turn of warpgroup w at the tensor cores (0 is __syncthreads)
constexpr int kSchedBar = 3;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

template <typename T, int DT, int kWG>
__global__ void __launch_bounds__(Tiles<DT, kWG>::kThreads,
                                  Tiles<DT, kWG>::kMinBlocks)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, int B, int Sq,
                   int Skv, int H, int K, float scale, float softcap,
                   int causal, int window, int nq) {
  using C = Tiles<DT, kWG>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::kStages, NB = C::kBoxes;
  constexpr int NT = BK / 8;      // n8 blocks of S a thread holds
  constexpr int DTILES = DT / 8;  // n8 blocks of O
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(smem);               // [kWG][NB][64][64]
  T* Ks = reinterpret_cast<T*>(smem + C::kQBytes);  // [NS][NB][BK][64]
  T* Vs = Ks + NS * BK * DT;                        // [NS][NB][BK][64]
  uint64_t* full_q =
      reinterpret_cast<uint64_t*>(smem + C::kQBytes + 2 * NS * C::kKVBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + NS;
  uint64_t* empty_k = full_v + NS;
  uint64_t* empty_v = empty_k + NS;

  // the longest causal q tiles first: q tile is the slowest grid index,
  // counted down
  int bid = blockIdx.x;
  const int h = bid % H;
  bid /= H;
  const int b = bid % B;
  const int q0 = (nq - 1 - bid / B) * BQ;
  const int kvh = h / (H / K);

  // kv tiles that can hold a kept key for some row of this q tile
  const int k_end = causal ? min(Skv, q0 + BQ) : Skv;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(full_k + s, 1);
      hopper::mbar_init(full_v + s, 1);
      hopper::mbar_init(empty_k + s, 4 * kWG);
      hopper::mbar_init(empty_v + s, 4 * kWG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform as far as the compiler can see (a shuffle from lane 0),
  // so no branch on it makes a wgmma path divergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kWG) {
    // ------------------------------------------ producer (one warp)
    if (tid == kWG * 128 && n_tiles > 0) {
      hopper::tma_prefetch(&tm_q);
      hopper::tma_prefetch(&tm_k);
      hopper::tma_prefetch(&tm_v);
      hopper::mbar_expect_tx(full_q, C::kQBytes);
      for (int w = 0; w < kWG; ++w)
#pragma unroll
        for (int x = 0; x < NB; ++x)
          hopper::tma_load_4d(Qs + (w * NB + x) * 64 * 64, &tm_q, full_q,
                              x * 64, h, q0 + 64 * w, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        const uint32_t ph = (it / NS) & 1;
        const int k0 = k_begin + it * BK;
        hopper::mbar_wait(empty_k + s, ph ^ 1);
        hopper::mbar_expect_tx(full_k + s, C::kKVBytes);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          hopper::tma_load_4d(Ks + (s * NB + x) * BK * 64, &tm_k, full_k + s,
                              x * 64, kvh, k0, b);
        hopper::mbar_wait(empty_v + s, ph ^ 1);
        hopper::mbar_expect_tx(full_v + s, C::kKVBytes);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          hopper::tma_load_4d(Vs + (s * NB + x) * BK * 64, &tm_v, full_v + s,
                              x * 64, kvh, k0, b);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    const int wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qg0 = q0 + 64 * wg;     // this warpgroup's first row
    const int qw0 = qg0 + 16 * warp;  // this warp's first row
    const int r0 = qw0 + g, r1 = r0 + 8;
    // scores enter the exponent as s * f - m * f: raw (f = scale * log2 e)
    // or, with a softcap, already in log2 units (f = 1)
    const float f = softcap > 0.f ? 1.f : scale * kLog2e;
    T* Qw = Qs + wg * NB * 64 * 64;
    const uint32_t q_addr = hopper::smem_u32(Qw);

    float o[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // rows r0 and r1, in s's units
    float l0 = 0.f, l1 = 0.f;              // this thread's share of l
    uint32_t pa[BK / 16][4];  // P of the last tile: its P.V's A operand

    // S = Q K^T of the tile in stage st, both operands K-major
    auto issue_qk = [&](float (&sc)[BK / 2], int st) {
      const uint32_t k_addr = hopper::smem_u32(Ks + st * NB * BK * 64);
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(
            q_addr + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = hopper::desc_sw128(
            k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
        hopper::Wgmma<BK, T>::ss(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
    };
    // O += P V of the tile in stage st, V MN-major: a k16 step is 16 rows
    auto issue_pv = [&](int st) {
      const uint32_t v_addr = hopper::smem_u32(Vs + st * NB * BK * 64);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            hopper::desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024);
        hopper::Wgmma<DT, T>::rs(o, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
    };
    // scores of the tile at k0 to p (in sc), with the rows' new maxima and
    // sums of p; m, l, O and P are left to fold()
    auto softmax = [&](float (&sc)[BK / 2], int k0, float& mx0, float& mx1,
                       float& ps0, float& ps1) {
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          sc[i] = softcap * tanhf(sc[i] * scale / softcap) * kLog2e;
      }
      // masks only where the tile straddles the ragged edge, the causal
      // diagonal or the band's edge for one of this warp's rows
      const bool need_mask = k0 + BK > Skv ||
                             (causal && k0 + BK - 1 > qw0) ||
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
            if (!ok) sc[4 * j + e] = -INFINITY;
          }
      }
      // a row's scores sit in one quad
      mx0 = m0;
      mx1 = m1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row with no kept key yet keeps max -inf: its p are exp2(-inf)
      const float c0 = mx0 == -INFINITY ? 0.f : mx0 * f;
      const float c1 = mx1 == -INFINITY ? 0.f : mx1 * f;
      ps0 = 0.f;
      ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], f, -c0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], f, -c0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], f, -c1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], f, -c1));
        ps0 += sc[4 * j] + sc[4 * j + 1];
        ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
    };
    // m and l to the new maxima, O rescaled by exp2(m_old - m_new) (1
    // while a row has no kept key), and P rounded to T: the accumulator
    // layout of two n8 blocks is the A fragment of one k16 step
    auto fold = [&](const float (&sc)[BK / 2], float mx0, float mx1,
                    float ps0, float ps1) {
      const float alpha0 = mx0 == -INFINITY ? 1.f : ex2((m0 - mx0) * f);
      const float alpha1 = mx1 == -INFINITY ? 1.f : ex2((m1 - mx1) * f);
      m0 = mx0;
      m1 = mx1;
      l0 = alpha0 * l0 + ps0;
      l1 = alpha1 * l1 + ps1;
#pragma unroll
      for (int i = 0; i < DTILES; ++i) {
        o[4 * i] *= alpha0; o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1; o[4 * i + 3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack2<T>(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };

    // Straight-line sections, so that ptxas can follow every wgmma group:
    // tile 0's Q.K^T; then tile j's Q.K^T with tile j - 1's P.V, tile j's
    // softmax running while that P.V (and the other warpgroup's products)
    // keep the tensor cores busy; then the last P.V. With two warpgroups
    // they take turns at issuing (warpgroup 0 first); every warpgroup
    // runs every tile, the masks zeroing what its rows do not keep.
    if (n_tiles > 0) {
      float mx0, mx1, ps0, ps1;
      hopper::mbar_wait(full_q, 0);
      if (kWG == 2 && wg == 1) hopper::named_arrive(kSchedBar, 256);
      {
        float sc[BK / 2];
        hopper::mbar_wait(full_k, 0);
        if (kWG == 2) hopper::named_sync(kSchedBar + wg, 256);
        hopper::wgmma_fence();
        issue_qk(sc, 0);
        if (kWG == 2) hopper::named_arrive(kSchedBar + (wg ^ 1), 256);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        release(empty_k);
        softmax(sc, k_begin, mx0, mx1, ps0, ps1);
        fold(sc, mx0, mx1, ps0, ps1);
      }
      for (int it = 1; it < n_tiles; ++it) {
        const int st = it % NS, sp = (it - 1) % NS;
        float sc[BK / 2];
        hopper::mbar_wait(full_k + st, (it / NS) & 1);
        hopper::mbar_wait(full_v + sp, ((it - 1) / NS) & 1);
        if (kWG == 2) hopper::named_sync(kSchedBar + wg, 256);
        hopper::fence_regs(o);
        hopper::fence_regs(pa);
        hopper::wgmma_fence();
        issue_qk(sc, st);
        issue_pv(sp);
        if (kWG == 2) hopper::named_arrive(kSchedBar + (wg ^ 1), 256);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        release(empty_k + st);
        softmax(sc, k_begin + it * BK, mx0, mx1, ps0, ps1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release(empty_v + sp);
        fold(sc, mx0, mx1, ps0, ps1);
      }
      {
        const int sp = (n_tiles - 1) % NS;
        hopper::mbar_wait(full_v + sp, ((n_tiles - 1) / NS) & 1);
        if (kWG == 2) hopper::named_sync(kSchedBar + wg, 256);
        hopper::fence_regs(o);
        hopper::fence_regs(pa);
        hopper::wgmma_fence();
        issue_pv(sp);
        if (kWG == 2 && wg == 0) hopper::named_arrive(kSchedBar + 1, 256);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release(empty_v + sp);
      }
    }

    if (qg0 < Sq) {  // a warpgroup wholly past Sq stores nothing
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
      // the normalised rows into this warpgroup's Q tile, whose last
      // reader has been waited on, swizzled as TMA reads it; then out
      const int rr = 16 * warp + g;  // rows rr and rr + 8 of the tile
      unsigned char* ob = reinterpret_cast<unsigned char*>(Qw);
#pragma unroll
      for (int i = 0; i < DTILES; ++i) {
        const int x = i / 8, c = i % 8;  // box, 16-byte chunk
        unsigned char* row0 =
            ob + x * 64 * 128 + rr * 128 + ((c ^ (rr & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(row0) =
            pack2<T>(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        *reinterpret_cast<uint32_t*>(row0 + 8 * 128) =
            pack2<T>(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (wtid == 0) {
#pragma unroll
        for (int x = 0; x < NB; ++x)
          hopper::tma_store_4d(&tm_o, Qw + x * 64 * 64, x * 64, h, qg0, b);
        hopper::tma_store_wait();
      }
    }
  }
}

template <typename T, int DT, int kWG>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Skv, int H, int K, int D, float scale,
                  float softcap, int causal, int window, cudaStream_t s) {
  using C = Tiles<DT, kWG>;
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv, to;
  int e = hopper::encode_4d(&tq, q, bf16, D, H, Sq, B, 64);
  if (e == 0) e = hopper::encode_4d(&tk, k, bf16, D, K, Skv, B, C::BK);
  if (e == 0) e = hopper::encode_4d(&tv, v, bf16, D, K, Skv, B, C::BK);
  if (e == 0) e = hopper::encode_4d(&to, out, bf16, D, H, Sq, B, 64);
  if (e != 0) return e;
  auto kern = flash_wgmma_kernel<T, DT, kWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Sq + C::BQ - 1) / C::BQ;
  const long long n_blocks = (long long)nq * B * H;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)n_blocks, C::kThreads, C::kSmem, s>>>(
      tq, tk, tv, to, B, Sq, Skv, H, K, scale, softcap, causal, window, nq);
  return (int)cudaGetLastError();
}

// the instantiation of the wrapper's plan: q_tile 64 or 128 rows, kv_tile
// the one its width and q tile fix (anything else is refused)
template <typename T>
static int launch_planned(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Skv, int H, int K,
                          int D, float scale, float softcap, int causal,
                          int window, int q_tile, int kv_tile,
                          cudaStream_t s) {
  const int dt = D <= 64 ? 64 : D <= 128 ? 128 : 256;
#define RAP_FLASH_PLAN(DT, W)                                               \
  if (dt == DT && q_tile == 64 * W)                                         \
    return kv_tile == Tiles<DT, W>::BK                                      \
               ? launch<T, DT, W>(q, k, v, out, B, Sq, Skv, H, K, D, scale, \
                                  softcap, causal, window, s)               \
               : (int)cudaErrorInvalidValue;
  RAP_FLASH_PLAN(64, 1)
  RAP_FLASH_PLAN(64, 2)
  RAP_FLASH_PLAN(128, 1)
  RAP_FLASH_PLAN(128, 2)
  RAP_FLASH_PLAN(256, 1)
#undef RAP_FLASH_PLAN
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg

// One dtype; D <= 256. f32 runs the FMA body (contiguous tensors; q_tile
// and kv_tile 32), bf16 and fp16 the wgmma body (contiguous, D % 8 == 0,
// 16-byte aligned; q_tile and kv_tile as kernels/flash_attention.py::plan
// gives them). Anything else is refused, never sent to another body.
extern "C" int rap_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Skv, int H,
                                   int K, int D, float scale, float softcap,
                                   int causal, int window, int dtype,
                                   int q_tile, int kv_tile, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (D > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (q_tile != kBQ || kv_tile != kBK) return (int)cudaErrorInvalidValue;
    return D <= 64    ? launch<float, 64>(q, k, v, out, B, Sq, Skv, H, K, D,
                                          scale, softcap, causal, window, s)
           : D <= 128 ? launch<float, 128>(q, k, v, out, B, Sq, Skv, H, K, D,
                                           scale, softcap, causal, window, s)
                      : launch<float, 256>(q, k, v, out, B, Sq, Skv, H, K, D,
                                           scale, softcap, causal, window, s);
  }
  if (dtype != 1 && dtype != 2) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out);
  if (D % 8 != 0 || (ptrs & 15) != 0) return (int)cudaErrorInvalidValue;
  if (Skv == 0)  // no key: every row is 0
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2, s);
  return dtype == 1
             ? wg::launch_planned<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H,
                                                 K, D, scale, softcap, causal,
                                                 window, q_tile, kv_tile, s)
             : wg::launch_planned<__half>(q, k, v, out, B, Sq, Skv, H, K, D,
                                          scale, softcap, causal, window,
                                          q_tile, kv_tile, s);
}
