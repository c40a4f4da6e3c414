// The split-explicit barotropic subcycle: n_sub forward-backward substeps of
// (eta, U, V) on the extended-halo grid, returning the SM05-weighted averages.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_baro.py:
// barotropic_substeps_pallas (_kernel), whose oracle is the XLA scan of
// models/hydrostatic.py:barotropic_substeps. The arithmetic here follows that
// scan term for term (the port's plain version, kernels/barotropic.py):
//   eta <- eta - dtau * ((dy_fc U)[i+1] - (dy_fc U)[i] + (dx_cf V)[j+1] - (dx_cf V)[j]) * inv_az
//   U   <- (U - dtau * (gH_u * (eta[i] - eta[i-1]) * inv_dx - GU)) * mask_u
//   V   <- (V - dtau * (gH_v * (eta[j] - eta[j-1]) * inv_dy - GV)) * mask_v
//   acc <- acc + w_m * (eta, U, V)      (acc <- w_0 * (eta, U, V) on substep 0)
// dtau is not folded into the factors, so the kernel differs from the plain
// version only where nvcc contracts a multiply-add into an FMA.
//
// What bounds it on the H100: bytes. One substep makes 26 plane passes of
// 724 x 1484 f32 (4.3 MB each): launch A reads 6 planes and writes eta, launch B
// reads 14 (6 static, eta, U, V, GU, GV, 3 accumulators) and writes 5. That is
// 112 MB per substep, 2.35 GB for the 21 substeps of the main path, 0.70 ms at
// 3.35 TB/s. The working set (about 20 planes, 86 MB) does not fit the 50 MB L2.
//
// Design: one thread per cell, two launches per substep (A: eta; B: U, V and the
// three accumulators), because B reads eta's neighbours and there is no grid-wide
// barrier inside a launch in this version. The state ping-pongs between two work
// buffers so that no launch reads a cell it writes; the first substep reads the
// inputs themselves and starts the averages, so the entry makes no staging copies
// and no zero fill. With the per-substep x-wrap, a halo column is computed from
// the formula at the interior column it copies, from the same inputs, so it
// equals that cell bitwise. A cell whose stencil
// leaves the array is written 0. dtau and the weights are read from device
// memory, so the host never waits on the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DY_FC, DX_CF, INV_AZ, GH_U, GH_V, INV_DX, INV_DY, MASK_U, MASK_V, N_STATIC };

__device__ __forceinline__ int src_col(int i, int Nx, int Hx, int wrap) {
  if (!wrap) return i;
  if (i < Hx) return i + Nx;
  if (i >= Hx + Nx) return i - Nx;
  return i;
}

template <typename T>
__global__ void eta_kernel(const T* __restrict__ st, const T* __restrict__ eta,
                           const T* __restrict__ U, const T* __restrict__ V,
                           T* __restrict__ eta_out, const T* __restrict__ dtau_p,
                           int Ye, int Xe, int Nx, int Hx, int wrap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xe || j >= Ye) return;
  const int64_t P = (int64_t)Ye * Xe;
  const int s = src_col(i, Nx, Hx, wrap);
  const int64_t k = (int64_t)j * Xe + s;
  T out = T(0);
  if (j + 1 < Ye && s + 1 < Xe) {
    const T* dy = st + DY_FC * P;
    const T* dx = st + DX_CF * P;
    const T div = ((dy[k + 1] * U[k + 1] - dy[k] * U[k]) +
                   (dx[k + Xe] * V[k + Xe] - dx[k] * V[k])) * st[INV_AZ * P + k];
    out = eta[k] - *dtau_p * div;
  }
  eta_out[(int64_t)j * Xe + i] = out;
}

template <typename T>
__global__ void uv_kernel(const T* __restrict__ st, const T* __restrict__ eta,
                          const T* __restrict__ U, const T* __restrict__ V,
                          const T* __restrict__ GU, const T* __restrict__ GV,
                          T* __restrict__ U_out, T* __restrict__ V_out,
                          T* __restrict__ acc_eta, T* __restrict__ acc_U,
                          T* __restrict__ acc_V, const T* __restrict__ dtau_p,
                          const T* __restrict__ w_p, int Ye, int Xe, int Nx, int Hx,
                          int wrap, int first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xe || j >= Ye) return;
  const int64_t P = (int64_t)Ye * Xe;
  const int s = src_col(i, Nx, Hx, wrap);
  const int64_t k = (int64_t)j * Xe + s;
  const int64_t o = (int64_t)j * Xe + i;
  const T dtau = *dtau_p;
  T u = T(0), v = T(0);
  if (s >= 1) {
    u = (U[k] - dtau * (st[GH_U * P + k] * (eta[k] - eta[k - 1]) * st[INV_DX * P + k] -
                        GU[k])) * st[MASK_U * P + k];
  }
  if (j >= 1) {
    v = (V[k] - dtau * (st[GH_V * P + k] * (eta[k] - eta[k - Xe]) * st[INV_DY * P + k] -
                        GV[k])) * st[MASK_V * P + k];
  }
  U_out[o] = u;
  V_out[o] = v;
  const T w = *w_p;
  if (first) {  // the first substep starts the averages: acc = w * x
    acc_eta[o] = w * eta[o];
    acc_U[o] = w * u;
    acc_V[o] = w * v;
  } else {
    acc_eta[o] = acc_eta[o] + w * eta[o];
    acc_U[o] = acc_U[o] + w * u;
    acc_V[o] = acc_V[o] + w * v;
  }
}

// Substep 0 reads the filled inputs (eta, U, V), which are never written; substep
// m >= 1 reads the work buffers written by substep m - 1. work: 6 planes, two
// (eta, U, V) sets that the state ping-pongs between; acc: 3 planes [eta, U, V]
// that the first substep overwrites, so neither needs initialising.
template <typename T>
int run(const void* st, const void* eta, const void* U, const void* V, const void* GU,
        const void* GV, void* work, void* acc, const void* dtau, const void* weights,
        int n_sub, int Ye, int Xe, int Nx, int Hx, int wrap, void* stream_p) {
  cudaStream_t stream = (cudaStream_t)stream_p;
  const int64_t P = (int64_t)Ye * Xe;
  T* W = (T*)work;
  T* A = (T*)acc;
  const dim3 block(32, 8);
  const dim3 grid((Xe + block.x - 1) / block.x, (Ye + block.y - 1) / block.y);
  const T* cur_eta = (const T*)eta;
  const T* cur_U = (const T*)U;
  const T* cur_V = (const T*)V;
  for (int m = 0; m < n_sub; ++m) {
    T* nxt = W + (m % 2) * 3 * P;
    eta_kernel<T><<<grid, block, 0, stream>>>((const T*)st, cur_eta, cur_U, cur_V, nxt,
                                              (const T*)dtau, Ye, Xe, Nx, Hx, wrap);
    int err = (int)cudaGetLastError();
    if (err) return err;
    uv_kernel<T><<<grid, block, 0, stream>>>(
        (const T*)st, nxt, cur_U, cur_V, (const T*)GU, (const T*)GV, nxt + P,
        nxt + 2 * P, A, A + P, A + 2 * P, (const T*)dtau, (const T*)weights + m, Ye,
        Xe, Nx, Hx, wrap, m == 0);
    err = (int)cudaGetLastError();
    if (err) return err;
    cur_eta = nxt;
    cur_U = nxt + P;
    cur_V = nxt + 2 * P;
  }
  return 0;
}

}  // namespace

extern "C" int osg_barotropic_f32(const void* st, const void* eta, const void* U,
                                  const void* V, const void* GU, const void* GV,
                                  void* work, void* acc, const void* dtau,
                                  const void* weights, int n_sub, int Ye, int Xe,
                                  int Nx, int Hx, int wrap, void* stream) {
  return run<float>(st, eta, U, V, GU, GV, work, acc, dtau, weights, n_sub, Ye, Xe, Nx,
                    Hx, wrap, stream);
}

extern "C" int osg_barotropic_f64(const void* st, const void* eta, const void* U,
                                  const void* V, const void* GU, const void* GV,
                                  void* work, void* acc, const void* dtau,
                                  const void* weights, int n_sub, int Ye, int Xe,
                                  int Nx, int Hx, int wrap, void* stream) {
  return run<double>(st, eta, U, V, GU, GV, work, acc, dtau, weights, n_sub, Ye, Xe,
                     Nx, Hx, wrap, stream);
}
