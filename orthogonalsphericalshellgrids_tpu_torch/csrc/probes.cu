// Speed-of-light probes and ceilings: the kernels that measure what the card can do,
// so that each model kernel's time can be set against a bound measured on the card.
//
// Replaces:
//   baro_sol     benchmarks/roofline.py:baro_substep_sol (_baro_sol_kernel): n_iter
//                iterations of the barotropic substep math on periodic tiles held
//                on chip;
//   weno_probe   benchmarks/weno_sol.py:weno_probe (_weno_sol_kernel): n_iter
//                chained WENO-5 reconstructions on x-periodic rows held on chip;
//   stream       the XLA body of utils/profiling.py:stream_probe_gbps (a saxpy scan,
//                one read and one write per element);
//   fma          the XLA body of benchmarks/weno_sol.py:fma_ceiling (8 independent
//                16-FMA Horner chains per element).
// XLA fuses the last two into one kernel each; PyTorch runs the same expressions as
// several launches, so a ceiling means something here only as one kernel.
//
// What bounds them on the H100: stream is bound by bytes (8 B an element for f32);
// fma by the FMA rate (264 flops an element and iteration); weno_probe by operations
// (70 flops a reconstruction, seven of them IEEE divisions: q0-q2 by 6, the three
// weights and the final one, as in weno5.cuh);
// baro_sol by operations and shared-memory traffic (22 flops, 4 neighbour reads and
// 3 writes per point-substep). The last two read their inputs once and write once,
// so their bytes are negligible against n_iter iterations of work.
//
// Designs:
//   baro_sol: one CTA per periodic tile (Wt, Xt) of a (B, 5, Wt, Xt) batch: B = 1 at
//     the TPU's tile is the TPU kernel's function, whose output is acc[:, 0]; all
//     three accumulators are returned so that none is dead code. Thread (x, ty) owns
//     the PT points (ty + k blockDim.y, x) of column x and keeps their 5 static
//     planes, eta, U, V, GU, GV and accumulators in registers. Only the values read
//     at a neighbour go through shared memory: the fluxes dy_fc U and dx_cf V (read
//     at i+1 and j+1) and eta (read at i-1 and j-1). Two __syncthreads a substep: one
//     before the eta update, one before the U/V update.
//   weno_probe: one block of 3 warps per row of Xe; the row lives in shared memory,
//     double buffered, for all n_iter iterations of one launch, so the x-roll is
//     periodic over the whole row for any W; one __syncthreads an iteration. The
//     buffer carries the 3 + 2 cells the stencil reads across the ends, written
//     beside the cells they copy, so the taps are plain offsets as in the model
//     kernels. A
//     reconstruction is a chain of dependent divisions, so the rate needs many warps
//     on each SM: a row of 1536 f32 takes 12 KB, and 16 rows (48 warps) fit an SM.
//     (On the H100 at 2048 iterations, where the iterate had turned NaN: one warp per
//     row, four rows a block, 76 G reconstructions/s; three warps a row with a wrap
//     per tap 110; this layout 124.) Built without fast math, as the model kernels
//     are: the IEEE division, slow path included, is what it measures.
//   stream: one block per 512 16-byte vectors, two in flight per thread, no grid
//     stride (PyTorch's elementwise shape). On the H100 a grid-stride loop with 8
//     blocks an SM measured 2.75-2.77 TB/s with one or four vectors in flight; this
//     shape 2.91-2.98, beside 2.97 for copy_ of the same bytes.
//   fma: a grid-stride loop; each element stays in a register for its n_iter
//     iterations.

#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5.cuh"

namespace {

constexpr int BARO_PT = 4;        // points a thread owns in baro_sol
constexpr int STREAM_U = 2;       // 16-byte vectors a stream thread has in flight
constexpr int WENO_THREADS = 96;  // threads on one row of weno_probe: 3 warps

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// ---- stream: out = x * 1.000001 + 0.5 ----------------------------------------------

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T>
__global__ void stream_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n) {
  constexpr int V = 16 / sizeof(T);
  const int64_t nv = n / V;
  const Vec<T, V>* xv = reinterpret_cast<const Vec<T, V>*>(x);
  Vec<T, V>* ov = reinterpret_cast<Vec<T, V>*>(out);
  const int64_t base = (int64_t)blockIdx.x * blockDim.x * STREAM_U + threadIdx.x;
  Vec<T, V> a[STREAM_U];
#pragma unroll
  for (int u = 0; u < STREAM_U; ++u) {
    const int64_t j = base + (int64_t)u * blockDim.x;
    if (j < nv) a[u] = xv[j];
  }
#pragma unroll
  for (int u = 0; u < STREAM_U; ++u) {
    const int64_t j = base + (int64_t)u * blockDim.x;
    if (j < nv) {
#pragma unroll
      for (int k = 0; k < V; ++k) a[u].v[k] = a[u].v[k] * T(1.000001) + T(0.5);
      ov[j] = a[u];
    }
  }
  if (blockIdx.x == gridDim.x - 1)  // the elements after the last whole vector
    for (int64_t j = nv * V + threadIdx.x; j < n; j += blockDim.x)
      out[j] = x[j] * T(1.000001) + T(0.5);
}

// ---- fma: the Horner body of weno_sol.py:fma_ceiling, n_iter times ------------------

template <typename T>
__device__ __forceinline__ T fma_body(T c) {
  T a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = c * T(0.9 + 0.01 * k) + T(0.1 * k);
#pragma unroll
  for (int i = 0; i < 15; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = a[k] * c + T(0.01 * (i + k));
  }
  T o = a[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) o = o + a[k];
  return o * T(1e-3);
}

template <typename T>
__global__ void fma_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                           int n_iter) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    T c = x[i];
    for (int it = 0; it < n_iter; ++it) c = fma_body(c);
    out[i] = c;
  }
}

// ---- weno_probe ------------------------------------------------------------------------

// Stores v as cell i of a row buffer with the periodic halo: cell i at 3 + i, and the
// copies that the stencil reads across the ends (cells Xe-3..Xe-1 at 0..2, cells 0..1
// at Xe+3..Xe+4).
template <typename T>
__device__ __forceinline__ void weno_store(T* buf, int i, int Xe, T v) {
  buf[3 + i] = v;
  if (i >= Xe - 3) buf[i - Xe + 3] = v;
  if (i < 2) buf[Xe + 3 + i] = v;
}

template <typename T, bool UPWIND>
__global__ void __launch_bounds__(WENO_THREADS)
    weno_probe_kernel(const T* __restrict__ x, T* __restrict__ out, int Xe, int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + Xe + 5;
  const T* xr = x + (int64_t)blockIdx.x * Xe;
  for (int i = threadIdx.x; i < Xe; i += WENO_THREADS) weno_store(cur, i, Xe, xr[i]);
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
    for (int i = threadIdx.x; i < Xe; i += WENO_THREADS) {
      const T* q = cur + 3 + i;
      const T c = q[0], m1 = q[-1], m2 = q[-2], m3 = q[-3], p1 = q[1];
      T r;
      if (UPWIND) {
        // the taps selected on the sign of the cell, as weno_sol.py:145-156
        const T p2 = q[2];
        const bool pos = c >= T(0);
        r = weno5_left(pos ? m3 : p2, pos ? m2 : p1, pos ? m1 : c, pos ? c : m1,
                       pos ? p1 : m2);
      } else {
        r = weno5_left(m3, m2, m1, c, p1);
      }
      const T sgn = r > T(0) ? T(1) : (r < T(0) ? T(-1) : T(0));
      const T mag = r < T(0) ? -r : r;
      weno_store(nxt, i, Xe, r - T(0.5) * sgn * mag * T(1e-3));
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  T* orow = out + (int64_t)blockIdx.x * Xe;
  for (int i = threadIdx.x; i < Xe; i += WENO_THREADS) orow[i] = cur[3 + i];
}

// ---- baro_sol --------------------------------------------------------------------------

enum { DY_FC, DX_CF, C_AZ, C_U, C_V };
enum { ETA, U_, V_, GU_, GV_ };

template <typename T>
__global__ void baro_sol_kernel(const T* __restrict__ spack, const T* __restrict__ dpack,
                                const T* __restrict__ dtau_p, T* __restrict__ out, int Wt,
                                int Xt, int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = Wt * Xt;
  T* fx_s = reinterpret_cast<T*>(smem_raw);
  T* fy_s = fx_s + P;
  T* eta_s = fy_s + P;
  const int64_t tile = blockIdx.x;
  const T* sp = spack + tile * 5 * P;
  const T* dp = dpack + tile * 5 * P;
  T* op = out + tile * 3 * P;
  const int x = threadIdx.x;
  const int xe = wrap(x + 1, Xt), xw = wrap(x - 1, Xt);

  T s_dy[BARO_PT], s_dx[BARO_PT], s_az[BARO_PT], s_cu[BARO_PT], s_cv[BARO_PT];
  T eta[BARO_PT], U[BARO_PT], V[BARO_PT], GU[BARO_PT], GV[BARO_PT];
  T a0[BARO_PT], a1[BARO_PT], a2[BARO_PT], fx[BARO_PT], fy[BARO_PT];
#pragma unroll
  for (int k = 0; k < BARO_PT; ++k) {
    const int idx = (threadIdx.y + k * blockDim.y) * Xt + x;
    s_dy[k] = sp[DY_FC * P + idx];
    s_dx[k] = sp[DX_CF * P + idx];
    s_az[k] = sp[C_AZ * P + idx];
    s_cu[k] = sp[C_U * P + idx];
    s_cv[k] = sp[C_V * P + idx];
    eta[k] = dp[ETA * P + idx];
    U[k] = dp[U_ * P + idx];
    V[k] = dp[V_ * P + idx];
    GU[k] = dp[GU_ * P + idx];
    GV[k] = dp[GV_ * P + idx];
    a0[k] = a1[k] = a2[k] = T(0);
  }
  const T dtau = *dtau_p;
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int k = 0; k < BARO_PT; ++k) {
      const int idx = (threadIdx.y + k * blockDim.y) * Xt + x;
      fx[k] = s_dy[k] * U[k];
      fy[k] = s_dx[k] * V[k];
      fx_s[idx] = fx[k];
      fy_s[idx] = fy[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BARO_PT; ++k) {
      const int y = threadIdx.y + k * blockDim.y;
      const int idx = y * Xt + x;
      const T div = ((fx_s[y * Xt + xe] - fx[k]) + fy_s[wrap(y + 1, Wt) * Xt + x] - fy[k]) *
                    s_az[k];
      eta[k] = eta[k] - div;
      eta_s[idx] = eta[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BARO_PT; ++k) {
      const int y = threadIdx.y + k * blockDim.y;
      U[k] = U[k] - s_cu[k] * (eta[k] - eta_s[y * Xt + xw]) + GU[k];
      V[k] = V[k] - s_cv[k] * (eta[k] - eta_s[wrap(y - 1, Wt) * Xt + x]) + GV[k];
      a0[k] = a0[k] + dtau * eta[k];
      a1[k] = a1[k] + dtau * U[k];
      a2[k] = a2[k] + dtau * V[k];
    }
    // the next substep writes fx_s and fy_s, which no thread reads after the
    // barrier above, and eta_s only after its first barrier
  }
#pragma unroll
  for (int k = 0; k < BARO_PT; ++k) {
    const int idx = (threadIdx.y + k * blockDim.y) * Xt + x;
    op[idx] = a0[k];
    op[P + idx] = a1[k];
    op[2 * P + idx] = a2[k];
  }
}

template <typename T>
int run_stream(const void* x, void* out, int64_t n, void* stream_p) {
  constexpr int V = 16 / sizeof(T);
  const int threads = 256;
  const int64_t per_block = (int64_t)threads * STREAM_U;
  const int64_t blocks = (n / V + per_block - 1) / per_block;
  stream_kernel<T><<<(unsigned)(blocks > 0 ? blocks : 1), threads, 0,
                     (cudaStream_t)stream_p>>>((const T*)x, (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int run_fma(const void* x, void* out, int64_t n, int n_iter, void* stream_p) {
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < (int64_t)sm_count() * 8 ? want : (int64_t)sm_count() * 8);
  fma_kernel<T><<<blocks > 0 ? blocks : 1, threads, 0, (cudaStream_t)stream_p>>>(
      (const T*)x, (T*)out, n, n_iter);
  return (int)cudaGetLastError();
}

template <typename T>
int run_weno(const void* x, void* out, int W, int Xe, int n_iter, int upwind,
             void* stream_p) {
  const size_t smem = (size_t)2 * (Xe + 5) * sizeof(T);
  cudaStream_t s = (cudaStream_t)stream_p;
  if (upwind) {
    cudaFuncSetAttribute(weno_probe_kernel<T, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    weno_probe_kernel<T, true><<<W, WENO_THREADS, smem, s>>>((const T*)x, (T*)out, Xe,
                                                             n_iter);
  } else {
    cudaFuncSetAttribute(weno_probe_kernel<T, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    weno_probe_kernel<T, false><<<W, WENO_THREADS, smem, s>>>((const T*)x, (T*)out, Xe,
                                                              n_iter);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_baro(const void* spack, const void* dpack, const void* dtau, void* out, int B,
             int Wt, int Xt, int n_iter, void* stream_p) {
  const size_t smem = (size_t)3 * Wt * Xt * sizeof(T);
  cudaFuncSetAttribute(baro_sol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 block(Xt, Wt / BARO_PT);
  baro_sol_kernel<T><<<B, block, smem, (cudaStream_t)stream_p>>>(
      (const T*)spack, (const T*)dpack, (const T*)dtau, (T*)out, Wt, Xt, n_iter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osg_stream_probe_f32(const void* x, void* out, int64_t n, void* s) {
  return run_stream<float>(x, out, n, s);
}
extern "C" int osg_stream_probe_f64(const void* x, void* out, int64_t n, void* s) {
  return run_stream<double>(x, out, n, s);
}
extern "C" int osg_fma_ceiling_f32(const void* x, void* out, int64_t n, int n_iter,
                                   void* s) {
  return run_fma<float>(x, out, n, n_iter, s);
}
extern "C" int osg_fma_ceiling_f64(const void* x, void* out, int64_t n, int n_iter,
                                   void* s) {
  return run_fma<double>(x, out, n, n_iter, s);
}
extern "C" int osg_weno_probe_f32(const void* x, void* out, int W, int Xe, int n_iter,
                                  int upwind, void* s) {
  return run_weno<float>(x, out, W, Xe, n_iter, upwind, s);
}
extern "C" int osg_weno_probe_f64(const void* x, void* out, int W, int Xe, int n_iter,
                                  int upwind, void* s) {
  return run_weno<double>(x, out, W, Xe, n_iter, upwind, s);
}
extern "C" int osg_baro_substep_sol_f32(const void* spack, const void* dpack,
                                        const void* dtau, void* out, int B, int Wt, int Xt,
                                        int n_iter, void* s) {
  return run_baro<float>(spack, dpack, dtau, out, B, Wt, Xt, n_iter, s);
}
extern "C" int osg_baro_substep_sol_f64(const void* spack, const void* dpack,
                                        const void* dtau, void* out, int B, int Wt, int Xt,
                                        int n_iter, void* s) {
  return run_baro<double>(spack, dpack, dtau, out, B, Wt, Xt, n_iter, s);
}
