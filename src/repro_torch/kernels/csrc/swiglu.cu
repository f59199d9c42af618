// Fused GLU gate: out[t, f] = act(h[t, f]) * h[t, F + f], act = silu or
// tanh-gelu, computed in f32 and stored in the input dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py::fused_glu.
// Bound on the H100 by memory: it moves 3*T*F elements (gate and up read
// once, the product written once) and does a handful of flops per element;
// at llama2-7b's prefill (h [2048, 22016] bf16) that is 135 MB, 40 us at
// 3.35 TB/s (NVIDIA's data sheet for the SXM part at 700 W). To reach that
// rate the card needs many bytes in flight, which one 2-byte load per
// thread and array (the first port) does not give.
// Design: a flat grid-stride loop over rows x F/V, V = 16 bytes of
// elements (8 bf16/fp16, 4 f32): each step is one 16-byte load from the
// gate half, one from the up half (both halves addressed in the same
// [T, 2F] buffer, no split copy) and one 16-byte store; the next step's
// two loads are issued before this step's arithmetic. The grid is one wave
// of resident blocks, so every SM keeps many loads in flight and none
// waits for a tail. Where F is not a
// multiple of V or a pointer is not 16-byte aligned, an element loop does
// the same arithmetic; llama2-7b (F = 11008) and recurrentgemma-9b
// (F = 12288) take the vector path. Both paths share glu(): expf and tanhf,
// not their fast approximations, so each element has the bits it had
// before the vector path.
#include "common.cuh"

#include <stdint.h>

constexpr int kThreads = 256;

__device__ __forceinline__ float glu(float g, float u, int act) {
  float a;
  if (act == 0) {
    a = g / (1.0f + expf(-g));                         // silu
  } else {
    const float k_beta = 0.7978845608028654f;          // sqrt(2/pi)
    a = 0.5f * g * (1.0f + tanhf(k_beta * (g + 0.044715f * g * g * g)));
  }
  return a * u;
}

// element j of a 16-byte vector held as four words, and its store: widened
// and packed by shifts, so the vector stays in registers
template <typename T>
__device__ __forceinline__ float get(const unsigned (&w)[4], int j);
template <>
__device__ __forceinline__ float get<float>(const unsigned (&w)[4], int j) {
  return __uint_as_float(w[j]);
}
template <>
__device__ __forceinline__ float get<__nv_bfloat16>(const unsigned (&w)[4],
                                                    int j) {
  const unsigned x = w[j >> 1];
  return __uint_as_float((j & 1) ? (x & 0xffff0000u) : (x << 16));
}
template <>
__device__ __forceinline__ float get<__half>(const unsigned (&w)[4], int j) {
  const unsigned x = w[j >> 1];
  return __half2float(
      __ushort_as_half((unsigned short)((j & 1) ? x >> 16 : x & 0xffffu)));
}

template <typename T>
__device__ __forceinline__ void put(unsigned (&w)[4], int j, float v);
template <>
__device__ __forceinline__ void put<float>(unsigned (&w)[4], int j, float v) {
  w[j] = __float_as_uint(v);
}
template <>
__device__ __forceinline__ void put<__nv_bfloat16>(unsigned (&w)[4], int j,
                                                   float v) {
  const unsigned short b = __bfloat16_as_ushort(from_f32<__nv_bfloat16>(v));
  w[j >> 1] |= (unsigned)b << (16 * (j & 1));
}
template <>
__device__ __forceinline__ void put<__half>(unsigned (&w)[4], int j, float v) {
  const unsigned short b = __half_as_ushort(from_f32<__half>(v));
  w[j >> 1] |= (unsigned)b << (16 * (j & 1));
}

template <typename T>
__device__ __forceinline__ void load2(const T* h, long long r, int c, int F,
                                      uint4& gv, uint4& uv) {
  constexpr int V = 16 / sizeof(T);
  const T* gate = h + r * 2LL * F + (long long)c * V;
  gv = *reinterpret_cast<const uint4*>(gate);
  uv = *reinterpret_cast<const uint4*>(gate + F);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
glu_vec_kernel(const T* __restrict__ h, T* __restrict__ out, long long rows,
               int F, int act) {
  constexpr int V = 16 / sizeof(T);
  const int fv = F / V;                                // vectors a row
  const long long n = rows * fv;
  const long long step = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // (row, vector) of i, advanced by step without a division per iteration
  long long r = i / fv;
  int c = (int)(i - r * fv);
  const long long dr = step / fv;
  const int dc = (int)(step - dr * fv);
  uint4 gv, uv;
  if (i < n) load2(h, r, c, F, gv, uv);
  for (; i < n; i += step) {
    long long r2 = r + dr;
    int c2 = c + dc;
    if (c2 >= fv) { c2 -= fv; ++r2; }
    uint4 gn, un;                    // the next step's vectors, in flight
    if (i + step < n) load2(h, r2, c2, F, gn, un);
    const unsigned gw[4] = {gv.x, gv.y, gv.z, gv.w};
    const unsigned uw[4] = {uv.x, uv.y, uv.z, uv.w};
    unsigned ow[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < V; ++j)
      put<T>(ow, j, glu(get<T>(gw, j), get<T>(uw, j), act));
    *reinterpret_cast<uint4*>(out + r * F + (long long)c * V) =
        make_uint4(ow[0], ow[1], ow[2], ow[3]);
    gv = gn;
    uv = un;
    r = r2;
    c = c2;
  }
}

template <typename T>
__global__ void glu_elem_kernel(const T* __restrict__ h, T* __restrict__ out,
                                long long rows, int F, int act) {
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* gate = h + r * 2LL * F;
    const T* up = gate + F;
    T* o = out + r * (long long)F;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < F;
         c += gridDim.x * blockDim.x)
      o[c] = from_f32<T>(glu(to_f32(gate[c]), to_f32(up[c]), act));
  }
}

template <typename T>
static int launch(const void* h, void* out, long long rows, int F, int act,
                  cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (F % V == 0 && ((uintptr_t)h & 15) == 0 && ((uintptr_t)out & 15) == 0) {
    // as many blocks as are resident at once: one wave, no tail
    int dev = 0, sms = 132, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, glu_vec_kernel<T>,
                                                  kThreads, 0);
    const long long n = rows * (F / V);
    const long long need = (n + kThreads - 1) / kThreads;
    const long long most = (long long)per_sm * sms;
    glu_vec_kernel<T><<<(unsigned)(need < most ? need : most), kThreads, 0,
                        s>>>((const T*)h, (T*)out, rows, F, act);
  } else {
    dim3 grid((F + kThreads - 1) / kThreads,
              (unsigned)(rows < 65535 ? rows : 65535));
    glu_elem_kernel<T><<<grid, kThreads, 0, s>>>((const T*)h, (T*)out, rows,
                                                 F, act);
  }
  return (int)cudaGetLastError();
}

// h: [rows, 2F] contiguous; out: [rows, F]; act: 0 silu, 1 tanh-gelu.
extern "C" int rap_fused_glu(const void* h, void* out, long long rows, int F,
                             int act, int dtype, void* stream) {
  if (rows == 0 || F == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T, return launch<T>(h, out, rows, F, act, s));
  return 0;
}
