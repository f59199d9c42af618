// Diagonal linear recurrence of the RG-LRU (Griffin) mixer:
// h[b,t,w] = a[b,t,w] * h[b,t-1,w] + b[b,t,w], h[b,-1,w] = 0; a, b, h f32
// [B,T,W].
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru.py::rglru. Bound
// on the H100 by memory: it reads a and b once and writes h once (12 bytes
// per element) for one FMA per element. Design: one thread per (b, w)
// channel walks T in order with h in a register, so no carry has to join
// blocks and any T and W are taken without padding (the TPU kernel's
// two-level block scan, an in-block associative scan plus a carry, is a
// later redesign). Neighbouring threads hold neighbouring w, so each time
// step's loads and stores are coalesced across the warp. To keep more
// bytes in flight than one dependent step allows, each thread loads kUnroll
// steps of a and b ahead of the FMAs that consume them; at recurrentgemma's
// B·W = 32768 channels that is still few bytes in flight for the card.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ h, long long n_chan, int T, int W) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chan) return;
  const long long bi = c / W, w = c - bi * W;
  const long long base = bi * T * (long long)W + w;
  float hv = 0.f;
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long o = base + (long long)(t + u) * W;
      av[u] = a[o];
      bv[u] = b[o];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = av[u] * hv + bv[u];
      h[base + (long long)(t + u) * W] = hv;
    }
  }
  for (; t < T; ++t) {
    const long long o = base + (long long)t * W;
    hv = a[o] * hv + b[o];
    h[o] = hv;
  }
}

// a, b, h contiguous f32 [B, T, W].
extern "C" int rap_rglru(const void* a, const void* b, void* h, int B, int T,
                         int W, void* stream) {
  const long long n_chan = (long long)B * W;
  if (n_chan == 0 || T == 0) return 0;
  const long long blocks = (n_chan + kThreads - 1) / kThreads;
  rglru_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, n_chan, T, W);
  return (int)cudaGetLastError();
}
