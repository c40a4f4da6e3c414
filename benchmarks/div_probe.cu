// Micro-benchmark of IEEE division's slow path in the WENO-5 reconstruction: each
// thread reconstructs ITER times from five values in registers, the result shifting
// into the stencil (so all-zero inputs give exact zeros in every division), with the
// plain division (NZ = false, as momentum.cu) or through weno5.cuh:div_nz (NZ = true,
// as tracer_adv.cu). A measurement (benchmarks/torch_div_probe.py), not part of the
// port; built with the port's nvcc flags and its csrc/ on the include path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5.cuh"

namespace {

template <typename T, bool NZ>
__global__ void div_probe_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                                 int iters) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T a = x[i], b = x[(i + 1) % n], c = x[(i + 2) % n], d = x[(i + 3) % n],
    e = x[(i + 4) % n];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const T r = weno5_left<NZ>(a, b, c, d, e);
    a = b;
    b = c;
    c = d;
    d = e;
    e = r;
  }
  out[i] = e;
}

template <typename T>
int launch(const void* x, void* out, int64_t n, int iters, int guarded, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (guarded)
    div_probe_kernel<T, true><<<blocks, threads, 0, s>>>((const T*)x, (T*)out, n, iters);
  else
    div_probe_kernel<T, false><<<blocks, threads, 0, s>>>((const T*)x, (T*)out, n, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osg_div_probe_f32(const void* x, void* out, int64_t n, int iters,
                                 int guarded, void* stream) {
  return launch<float>(x, out, n, iters, guarded, stream);
}

extern "C" int osg_div_probe_f64(const void* x, void* out, int64_t n, int iters,
                                 int guarded, void* stream) {
  return launch<double>(x, out, n, iters, guarded, stream);
}
