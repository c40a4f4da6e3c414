// Flux-form upwind WENO-5 tracer advection tendency, in column and layered mode, with
// the fused kappa_h Laplacian.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:tracer_adv_pallas
// (_kernel) with all its operands, in its two modes; its math is
// pallas_adv.py:213-247:
//   cx = upwind WENO-5 of c at the x faces (upwinded on u), cy likewise in y
//   column  (one tracer plane; models/hydrostatic.py:698-702): the pack is
//     [h_u, dy_fc, h_v, dx_cf, IV (, K_u, K_v, K_c)], IV = mask_c / (Az_cc h_c), and
//     G = -(dxc(u h_u dy_fc cx) + dyc(v h_v dx_cf cy)) IV
//   layered (n_tr Nz tracer-major planes over Nz velocity layers; models/layered.py
//   :815-822): u and v are masked, so u dzu == u dz_k; the pack holds S = 1 or 4
//     planes per layer, [IV (, K_u, K_v, K_c)], IV = mask_c / (Az_cc dz_k), and
//     G = -(dxc(u dz_k dy_fc cx) + dyc(v dz_k dx_cf cy)) IV
//   with K planes (kappa_h, pallas_adv.py:239-243), in both modes:
//     G += (dxc((dxf c) K_u) + dyc((dyf c) K_v)) K_c
//   and, where the additive stack acc is given (pallas_adv.py:244-246), G += acc,
//   read at the cell itself before the store.
// The flux factors are applied in the plain version's order, ((u h) len) cx with
// h = h_u or dz_k, not through a prefactored A_u, so the kernel differs from the
// port's plain version (kernels/tracer_adv.py) only where nvcc contracts into an FMA.
//
// What bounds it on the H100: the WENO-5 arithmetic, then bytes. Column mode reads
// c, u, v and 5 static planes and writes G: 9 planes of 690 x 1450 f32 (4 MB each),
// 36 MB per call, 11 us at 3.35 TB/s. Layered mode at the baroclinic front's
// 1/4-degree x 10 (one tracer stack of 10 planes) reads c, u, v, IV (40 planes) and
// the 2 shared metric planes and writes G (10 planes): 0.2 GB, 60 us; kappa_h adds 3
// planes a layer and acc one a tracer plane (40 MB for 10). Each thread recomputes
// both x faces and both y faces of its cell: four reconstructions with 7 IEEE
// divisions each, a cell and plane, 0.24 ms for 10 planes at the measured WENO-5 rate.
//
// Design: one thread per cell (and plane, blockIdx.z, in layered mode), neighbour
// reads from global memory through L1/L2. Cells within 3 of the edge (the stencil's
// reach) are written 0. kappa_h and acc are template switches, so the paths without
// them are the same code as before: with acc as a null test on its pointer, the
// kappa_h kernel without acc ran 12-15 % slower on the H100 (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5.cuh"

namespace {

enum { H_U, DY_FC, H_V, DX_CF, INV_VOL, K_U, K_V, K_C };
constexpr int REACH = 3;

// flux through the face at k, stencil stride d (1: x faces, Xb: y faces), with the
// face's thickness h
template <typename T>
__device__ __forceinline__ T face_flux(const T* __restrict__ c, const T* __restrict__ vel,
                                       T h, const T* __restrict__ len, int64_t k,
                                       int64_t d) {
  const T w = vel[k];
  const T cf = weno5_upwind(w > T(0), c[k - 3 * d], c[k - 2 * d], c[k - d], c[k],
                            c[k + d], c[k + 2 * d]);
  return w * h * len[k] * cf;
}

// the kappa_h Laplacian at k from the face factors ku, kv and the cell factor kc
template <typename T>
__device__ __forceinline__ T diffusion(const T* __restrict__ c, const T* __restrict__ ku,
                                       const T* __restrict__ kv, T kc, int64_t k,
                                       int64_t X) {
  const T gx0 = (c[k] - c[k - 1]) * ku[k];
  const T gx1 = (c[k + 1] - c[k]) * ku[k + 1];
  const T gy0 = (c[k] - c[k - X]) * kv[k];
  const T gy1 = (c[k + X] - c[k]) * kv[k + X];
  return ((gx1 - gx0) + (gy1 - gy0)) * kc;
}

template <typename T, bool HAS_DIFF, bool HAS_ACC>
__global__ void tracer_adv_kernel(const T* __restrict__ c, const T* __restrict__ u,
                                  const T* __restrict__ v, const T* __restrict__ st,
                                  const T* __restrict__ acc, T* __restrict__ G, int Yb,
                                  int Xb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xb || j >= Yb) return;
  const int64_t k = (int64_t)j * Xb + i;
  if (i < REACH || j < REACH || i >= Xb - REACH || j >= Yb - REACH) {
    G[k] = T(0);
    return;
  }
  const int64_t P = (int64_t)Yb * Xb;
  const int64_t X = Xb;
  const T* hu = st + H_U * P;
  const T* dy = st + DY_FC * P;
  const T* hv = st + H_V * P;
  const T* dx = st + DX_CF * P;
  const T gx = face_flux(c, u, hu[k + 1], dy, k + 1, 1) - face_flux(c, u, hu[k], dy, k, 1);
  const T gy = face_flux(c, v, hv[k + X], dx, k + X, X) - face_flux(c, v, hv[k], dx, k, X);
  T g = -(gx + gy) * st[INV_VOL * P + k];
  if (HAS_DIFF) g = g + diffusion(c, st + K_U * P, st + K_V * P, st[K_C * P + k], k, X);
  if constexpr (HAS_ACC) g = g + acc[k];
  G[k] = g;
}

// Layered mode: blockIdx.z is the tracer plane t Nz + layer; g = [dy_fc, dx_cf]; the
// pack holds S = 1 + 3 HAS_DIFF planes per layer.
template <typename T, bool HAS_DIFF, bool HAS_ACC>
__global__ void tracer_adv_layered_kernel(const T* __restrict__ c, const T* __restrict__ u,
                                          const T* __restrict__ v, const T* __restrict__ iv,
                                          const T* __restrict__ g, const T* __restrict__ dz,
                                          const T* __restrict__ acc, T* __restrict__ G,
                                          int nz, int Yb, int Xb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xb || j >= Yb) return;
  const int64_t P = (int64_t)Yb * Xb;
  const int layer = blockIdx.z % nz;
  c += blockIdx.z * P;
  G += blockIdx.z * P;
  if constexpr (HAS_ACC) acc += blockIdx.z * P;
  u += layer * P;
  v += layer * P;
  const int64_t k = (int64_t)j * Xb + i;
  if (i < REACH || j < REACH || i >= Xb - REACH || j >= Yb - REACH) {
    G[k] = T(0);
    return;
  }
  const int64_t X = Xb;
  const T dzk = dz[layer];
  const T* dy = g;
  const T* dx = g + P;
  const T gx = face_flux(c, u, dzk, dy, k + 1, 1) - face_flux(c, u, dzk, dy, k, 1);
  const T gy = face_flux(c, v, dzk, dx, k + X, X) - face_flux(c, v, dzk, dx, k, X);
  constexpr int S = HAS_DIFF ? 4 : 1;
  const T* lp = iv + (int64_t)layer * S * P;  // this layer's [IV (, K_u, K_v, K_c)]
  T out = -(gx + gy) * lp[k];
  if (HAS_DIFF) out = out + diffusion(c, lp + P, lp + 2 * P, lp[3 * P + k], k, X);
  if constexpr (HAS_ACC) out = out + acc[k];
  G[k] = out;
}

template <typename T, bool HAS_DIFF, bool HAS_ACC>
void launch_column(const void* c, const void* u, const void* v, const void* st,
                   const void* acc, void* G, int Yb, int Xb, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y);
  tracer_adv_kernel<T, HAS_DIFF, HAS_ACC><<<grid, block, 0, s>>>(
      (const T*)c, (const T*)u, (const T*)v, (const T*)st, (const T*)acc, (T*)G, Yb, Xb);
}

template <typename T>
int launch(const void* c, const void* u, const void* v, const void* st, const void* acc,
           void* G, int Yb, int Xb, int has_diff, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (has_diff && acc)
    launch_column<T, true, true>(c, u, v, st, acc, G, Yb, Xb, s);
  else if (has_diff)
    launch_column<T, true, false>(c, u, v, st, acc, G, Yb, Xb, s);
  else if (acc)
    launch_column<T, false, true>(c, u, v, st, acc, G, Yb, Xb, s);
  else
    launch_column<T, false, false>(c, u, v, st, acc, G, Yb, Xb, s);
  return (int)cudaGetLastError();
}

template <typename T, bool HAS_DIFF, bool HAS_ACC>
void launch_stack(const void* c, const void* u, const void* v, const void* iv,
                  const void* g, const void* dz, const void* acc, void* G, int n_planes,
                  int nz, int Yb, int Xb, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y, n_planes);
  tracer_adv_layered_kernel<T, HAS_DIFF, HAS_ACC><<<grid, block, 0, s>>>(
      (const T*)c, (const T*)u, (const T*)v, (const T*)iv, (const T*)g, (const T*)dz,
      (const T*)acc, (T*)G, nz, Yb, Xb);
}

template <typename T>
int launch_layered(const void* c, const void* u, const void* v, const void* iv,
                   const void* g, const void* dz, const void* acc, void* G, int n_planes,
                   int nz, int Yb, int Xb, int has_diff, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (has_diff && acc)
    launch_stack<T, true, true>(c, u, v, iv, g, dz, acc, G, n_planes, nz, Yb, Xb, s);
  else if (has_diff)
    launch_stack<T, true, false>(c, u, v, iv, g, dz, acc, G, n_planes, nz, Yb, Xb, s);
  else if (acc)
    launch_stack<T, false, true>(c, u, v, iv, g, dz, acc, G, n_planes, nz, Yb, Xb, s);
  else
    launch_stack<T, false, false>(c, u, v, iv, g, dz, acc, G, n_planes, nz, Yb, Xb, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osg_tracer_adv_f32(const void* c, const void* u, const void* v,
                                  const void* st, const void* acc, void* G, int Yb, int Xb,
                                  int has_diff, void* stream) {
  return launch<float>(c, u, v, st, acc, G, Yb, Xb, has_diff, stream);
}

extern "C" int osg_tracer_adv_f64(const void* c, const void* u, const void* v,
                                  const void* st, const void* acc, void* G, int Yb, int Xb,
                                  int has_diff, void* stream) {
  return launch<double>(c, u, v, st, acc, G, Yb, Xb, has_diff, stream);
}

extern "C" int osg_tracer_adv_layered_f32(const void* c, const void* u, const void* v,
                                          const void* iv, const void* g, const void* dz,
                                          const void* acc, void* G, int n_planes, int nz,
                                          int Yb, int Xb, int has_diff, void* stream) {
  return launch_layered<float>(c, u, v, iv, g, dz, acc, G, n_planes, nz, Yb, Xb, has_diff,
                               stream);
}

extern "C" int osg_tracer_adv_layered_f64(const void* c, const void* u, const void* v,
                                          const void* iv, const void* g, const void* dz,
                                          const void* acc, void* G, int n_planes, int nz,
                                          int Yb, int Xb, int has_diff, void* stream) {
  return launch_layered<double>(c, u, v, iv, g, dz, acc, G, n_planes, nz, Yb, Xb, has_diff,
                                stream);
}
