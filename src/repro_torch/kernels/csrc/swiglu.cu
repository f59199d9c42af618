// Fused GLU gate: out[t, f] = act(h[t, f]) * h[t, F + f], act = silu or
// tanh-gelu, computed in f32 and stored in the input dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/swiglu.py::fused_glu.
// Bound on the H100 by memory: it moves 3*T*F elements (gate and up read
// once, the product written once) and does a handful of flops per element.
// Design: one elementwise pass. blockIdx.y walks rows, the x dimension walks
// columns, so a warp reads 32 consecutive gate and 32 consecutive up
// elements of one row (both halves addressed in the same [T, 2F] buffer, no
// split copy) and writes 32 consecutive outputs. Any T and any F (llama2-7b's
// F = 11008 is no multiple of a power-of-two tile) are handled by the
// bounds checks; no padding is materialised.
#include "common.cuh"

template <typename T>
__global__ void glu_kernel(const T* __restrict__ h, T* __restrict__ out,
                           long long rows, int F, int act) {
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* gate = h + r * 2LL * F;
    const T* up = gate + F;
    T* o = out + r * (long long)F;
    for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < F;
         c += gridDim.x * blockDim.x) {
      float g = to_f32(gate[c]);
      float u = to_f32(up[c]);
      float a;
      if (act == 0) {
        a = g / (1.0f + expf(-g));                       // silu
      } else {
        const float k_beta = 0.7978845608028654f;        // sqrt(2/pi)
        a = 0.5f * g * (1.0f + tanhf(k_beta * (g + 0.044715f * g * g * g)));
      }
      o[c] = from_f32<T>(a * u);
    }
  }
}

// h: [rows, 2F] contiguous; out: [rows, F]; act: 0 silu, 1 tanh-gelu.
extern "C" int rap_fused_glu(const void* h, void* out, long long rows, int F,
                             int act, int dtype, void* stream) {
  if (rows == 0 || F == 0) return 0;
  const int threads = 256;
  int gx = (F + threads - 1) / threads;
  long long gy = rows < 65535 ? rows : 65535;
  dim3 grid(gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  RAP_DISPATCH(dtype, T,
               glu_kernel<T><<<grid, threads, 0, s>>>((const T*)h, (T*)out,
                                                      rows, F, act));
  return (int)cudaGetLastError();
}
