// Every layer-coupled vertical term of the layered tendency, as additive
// contributions (dGu, dGv, dGc).
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_vert.py:vertical_pallas
// (_kernel); its math is pallas_vert.py:198-298, which the port's plain version
// (kernels/vertical.py:vertical_plain) follows term for term:
//   w_k    = -sum_{k'>=k} dz_k' ((dy_fc u)_{i+1} - (dy_fc u)_i + (dx_cf v)_{j+1}
//            - (dx_cf v)_j) inv_az                    (interfaces k = 1..Nz-1)
//   dGu_k  = -0.5 (cu_k + cu_{k+1}),  cu_k = 0.5 (w_k + w_k(i-1)) (u_{k-1} - u_k)/dzc
//            [+ nu_v/dz_k (Fu_k - Fu_{k+1}),  Fu_k = (u_{k-1} - u_k)/dzc mu_{k-1} mu_k]
//            - (p_k - p_k(i-1)) inv_dx,  p_k = dz_k b_k / 2 - sum_{k'<=k} dz_k' b_k'
//   dGv_k  likewise with v, w(j-1), mv and inv_dy
//   dGc_tk = (-1/dz_k (F_k - F_{k+1}) [+ kappa_v/dz_k (D_k - D_{k+1})]) mc_k,
//            F_k = w_k (c_{k-1} + c_k)/2,  D_k = (c_{k-1} - c_k)/dzc mc_{k-1} mc_k
// with no flux through the surface and the floor. b is the prognostic buoyancy
// tracer ("tracer_b"), g_b (alpha (T - T0) - beta (S - S0)) mc ("linear_eos"), or
// absent ("none"). The per-layer factors (dz, 1/dzc, -1/dz, nu_v/dz, kappa_v/dz)
// come from the wrapper as one (5, Nz) coefficient stack, computed in float64 on
// the host, as the Pallas kernel bakes them in as Python floats.
//
// What bounds it on the H100: bytes. At the baroclinic front's 1/4-degree x 10
// shape (planes of 690 x 1450, 4.0 MB at f32; c and b give P = 20 tracer planes;
// S = 3 mask planes per layer) launch A reads u, v and 3 metric planes and writes
// w (9 planes): 32 planes, 128 MB. Launch B reads u, v, w, c, b, the 30 mask planes
// and 2 metric planes and writes dGu, dGv, dGc: 121 planes, 484 MB. Together 0.61
// GB, 0.18 ms at 3.35 TB/s. About 60 flops per cell and layer, 0.6 GFLOP per
// call: the flops do not bound it at f32 or f64.
//
// Design: one thread per (y, x) column, looping over the layers with every running
// sum (w, the pressure integral, the interface fluxes of the layer above) in
// registers, so Nz is bounded only by time (no per-thread array: Nz = 75 costs
// no more registers than Nz = 10). w is needed at the columns (j, i-1) and
// (j-1, i) as well, so launch A writes it to a scratch stack from the floor up
// and launch B reads the neighbours through L1/L2; the pressure integral is kept
// for the three columns it is differenced over. The layer sums run in the Pallas
// kernel's order, so the kernel differs from the plain version only where nvcc
// contracts a multiply and an add into one FMA. Cells within 1 of the array edge
// (the stencil's reach) are written 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DZ, RDZC, MRDZ, NUDZ, KAPDZ, N_COEF };       // coefficient rows
enum { IAZ, IDX, IDY, DYFC, DXCF, N_G };            // g_pack planes
enum { MODE_NONE = 0, MODE_TRACER_B = 1, MODE_LINEAR_EOS = 2 };

// Launch A: w at the top interface of layers 1..nz-1, summed from the floor up.
template <typename T>
__global__ void w_kernel(const T* __restrict__ u, const T* __restrict__ v,
                         const T* __restrict__ g, const T* __restrict__ coef,
                         T* __restrict__ w, int nz, int Yb, int Xb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xb || j >= Yb) return;
  const int64_t P = (int64_t)Yb * Xb;
  const int64_t X = Xb;
  const int64_t c0 = (int64_t)j * Xb + i;
  if (i >= Xb - 1 || j >= Yb - 1) {
    for (int k = 1; k < nz; ++k) w[k * P + c0] = T(0);
    return;
  }
  const T iaz = g[IAZ * P + c0];
  const T dyfc = g[DYFC * P + c0], dyfc_e = g[DYFC * P + c0 + 1];
  const T dxcf = g[DXCF * P + c0], dxcf_n = g[DXCF * P + c0 + X];
  T acc = T(0);
  for (int k = nz - 1; k >= 1; --k) {
    const int64_t o = k * P + c0;
    const T fu = dyfc * u[o], fu_e = dyfc_e * u[o + 1];
    const T fv = dxcf * v[o], fv_n = dxcf_n * v[o + X];
    const T hdiv = coef[DZ * nz + k] * ((fu_e - fu) + (fv_n - fv)) * iaz;
    acc = (k == nz - 1) ? hdiv : acc + hdiv;
    w[o] = -acc;
  }
}

struct Eos {
  int mode, it_T, it_S;
  double g_b, alpha, beta, T0, S0;
};

// b of layer k at the column offset col (o = k P + col).
template <typename T>
__device__ __forceinline__ T buoyancy(const T* __restrict__ c, const T* __restrict__ b,
                                      const T* __restrict__ sp, const Eos& e, int nz,
                                      int S, int k, int64_t P, int64_t col) {
  const int64_t o = k * P + col;
  if (e.mode == MODE_TRACER_B) return b[o];
  T bb = T(0);
  bool have = false;
  if (e.it_T >= 0) {
    bb = T(e.alpha) * (c[(int64_t)e.it_T * nz * P + o] - T(e.T0));
    have = true;
  }
  if (e.it_S >= 0) {
    const T t = T(e.beta) * (c[(int64_t)e.it_S * nz * P + o] - T(e.S0));
    bb = have ? bb - t : -t;
  }
  return T(e.g_b) * bb * sp[(int64_t)k * S * P + col];
}

// Launch B: dGu, dGv and dGc of one column.
template <typename T>
__global__ void vertical_kernel(const T* __restrict__ u, const T* __restrict__ v,
                                const T* __restrict__ c, const T* __restrict__ b,
                                const T* __restrict__ sp, const T* __restrict__ g,
                                const T* __restrict__ coef, const T* __restrict__ w,
                                T* __restrict__ dgu, T* __restrict__ dgv,
                                T* __restrict__ dgc, int nz, int n_c, int n_tr, int S,
                                int Yb, int Xb, Eos e, int viscous, int diffusive) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xb || j >= Yb) return;
  const int64_t P = (int64_t)Yb * Xb;
  const int64_t X = Xb;
  const int64_t c0 = (int64_t)j * Xb + i;
  if (i < 1 || j < 1 || i >= Xb - 1 || j >= Yb - 1) {
    for (int k = 0; k < nz; ++k) {
      dgu[k * P + c0] = T(0);
      dgv[k * P + c0] = T(0);
    }
    for (int t = 0; t < n_tr * nz; ++t) dgc[t * P + c0] = T(0);
    return;
  }

  // --- momentum: w-advection, nu_v, hydrostatic pressure gradient
  const T idx = g[IDX * P + c0], idy = g[IDY * P + c0];
  T uk = u[c0], vk = v[c0];
  T mu_k = viscous ? sp[1 * P + c0] : T(0);
  T mv_k = viscous ? sp[2 * P + c0] : T(0);
  T cu_t = T(0), cv_t = T(0), fu_t = T(0), fv_t = T(0);  // top interface of layer k
  T csum = T(0), csum_x = T(0), csum_y = T(0);
  for (int k = 0; k < nz; ++k) {
    const bool top = k > 0, bot = k + 1 < nz;
    T cu_b = T(0), cv_b = T(0), fu_b = T(0), fv_b = T(0);
    T ub = T(0), vb = T(0), mu_b = T(0), mv_b = T(0);
    if (bot) {
      const int64_t o = (k + 1) * P + c0;
      ub = u[o];
      vb = v[o];
      const T rdzc = coef[RDZC * nz + k];
      const T du = (uk - ub) * rdzc;
      const T dv = (vk - vb) * rdzc;
      const T wc = w[o];
      cu_b = T(0.5) * (wc + w[o - 1]) * du;
      cv_b = T(0.5) * (wc + w[o - X]) * dv;
      if (viscous) {
        mu_b = sp[((int64_t)(k + 1) * S + 1) * P + c0];
        mv_b = sp[((int64_t)(k + 1) * S + 2) * P + c0];
        fu_b = du * (mu_k * mu_b);
        fv_b = dv * (mv_k * mv_b);
      }
    }
    T gu = T(0), gv = T(0);
    if (top || bot) {
      const T su = top ? (bot ? cu_t + cu_b : cu_t) : cu_b;
      const T sv = top ? (bot ? cv_t + cv_b : cv_t) : cv_b;
      gu = T(-0.5) * su;
      gv = T(-0.5) * sv;
      if (viscous) {
        const T nd = coef[NUDZ * nz + k];
        const T tu = top ? (bot ? fu_t + (-fu_b) : fu_t) : -fu_b;
        const T tv = top ? (bot ? fv_t + (-fv_b) : fv_t) : -fv_b;
        gu = gu + nd * tu;
        gv = gv + nd * tv;
      }
    }
    if (e.mode != MODE_NONE) {
      const T dz = coef[DZ * nz + k];
      const T bdz = dz * buoyancy(c, b, sp, e, nz, S, k, P, c0);
      const T bdz_x = dz * buoyancy(c, b, sp, e, nz, S, k, P, c0 - 1);
      const T bdz_y = dz * buoyancy(c, b, sp, e, nz, S, k, P, c0 - X);
      csum = top ? csum + bdz : bdz;
      csum_x = top ? csum_x + bdz_x : bdz_x;
      csum_y = top ? csum_y + bdz_y : bdz_y;
      const T p = T(0.5) * bdz - csum;
      const T p_x = T(0.5) * bdz_x - csum_x;
      const T p_y = T(0.5) * bdz_y - csum_y;
      gu = gu - (p - p_x) * idx;
      gv = gv - (p - p_y) * idy;
    }
    dgu[k * P + c0] = gu;
    dgv[k * P + c0] = gv;
    cu_t = cu_b;
    cv_t = cv_b;
    fu_t = fu_b;
    fv_t = fv_b;
    uk = ub;
    vk = vb;
    mu_k = mu_b;
    mv_k = mv_b;
  }

  // --- tracers (c blocks, then b): centered vertical flux divergence, kappa_v
  for (int t = 0; t < n_tr; ++t) {
    const T* ct = t < n_c ? c + (int64_t)t * nz * P : b;
    T* out = dgc + (int64_t)t * nz * P;
    T ck = ct[c0];
    T mck = sp[c0];
    T f_t = T(0), d_t = T(0);
    for (int k = 0; k < nz; ++k) {
      const bool top = k > 0, bot = k + 1 < nz;
      T f_b = T(0), d_b = T(0), cb = T(0), mcb = T(0);
      if (bot) {
        const int64_t o = (k + 1) * P + c0;
        cb = ct[o];
        mcb = sp[(int64_t)(k + 1) * S * P + c0];
        f_b = w[o] * (T(0.5) * (ck + cb));
        if (diffusive) d_b = (ck - cb) * coef[RDZC * nz + k] * (mck * mcb);
      }
      T G = T(0);
      if (top || bot) {
        const T s = top ? (bot ? f_t + (-f_b) : f_t) : -f_b;
        G = coef[MRDZ * nz + k] * s;
        if (diffusive) {
          const T s2 = top ? (bot ? d_t + (-d_b) : d_t) : -d_b;
          G = G + coef[KAPDZ * nz + k] * s2;
        }
      }
      out[k * P + c0] = G * mck;
      f_t = f_b;
      d_t = d_b;
      ck = cb;
      mck = mcb;
    }
  }
}

template <typename T>
int launch(const void* u, const void* v, const void* c, const void* b, const void* sp,
           const void* g, const void* coef, void* w, void* dgu, void* dgv, void* dgc,
           int nz, int n_c, int n_tr, int S, int Yb, int Xb, int mode, int it_T, int it_S,
           int viscous, int diffusive, double g_b, double alpha, double beta, double T0,
           double S0, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y);
  cudaStream_t s = (cudaStream_t)stream;
  w_kernel<T><<<grid, block, 0, s>>>((const T*)u, (const T*)v, (const T*)g,
                                     (const T*)coef, (T*)w, nz, Yb, Xb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Eos e{mode, it_T, it_S, g_b, alpha, beta, T0, S0};
  vertical_kernel<T><<<grid, block, 0, s>>>(
      (const T*)u, (const T*)v, (const T*)c, (const T*)b, (const T*)sp, (const T*)g,
      (const T*)coef, (const T*)w, (T*)dgu, (T*)dgv, (T*)dgc, nz, n_c, n_tr, S, Yb, Xb,
      e, viscous, diffusive);
  return (int)cudaGetLastError();
}

}  // namespace

#define OSG_VERTICAL_ENTRY(SUFFIX, TYPE)                                              \
  extern "C" int osg_vertical_##SUFFIX(                                               \
      const void* u, const void* v, const void* c, const void* b, const void* sp,     \
      const void* g, const void* coef, void* w, void* dgu, void* dgv, void* dgc,      \
      int nz, int n_c, int n_tr, int S, int Yb, int Xb, int mode, int it_T, int it_S, \
      int viscous, int diffusive, double g_b, double alpha, double beta, double T0,   \
      double S0, void* stream) {                                                      \
    return launch<TYPE>(u, v, c, b, sp, g, coef, w, dgu, dgv, dgc, nz, n_c, n_tr, S,  \
                        Yb, Xb, mode, it_T, it_S, viscous, diffusive, g_b, alpha,     \
                        beta, T0, S0, stream);                                        \
  }

OSG_VERTICAL_ENTRY(f32, float)
OSG_VERTICAL_ENTRY(f64, double)
