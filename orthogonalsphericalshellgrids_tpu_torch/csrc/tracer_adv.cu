// Flux-form upwind WENO-5 tracer advection tendency, in column and layered mode.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:tracer_adv_pallas
// (_kernel) without kappa_h, in its two modes; its math is pallas_adv.py:213-247:
//   cx = upwind WENO-5 of c at the x faces (upwinded on u), cy likewise in y
//   column  (one tracer plane, S = 3; models/hydrostatic.py:698-702):
//     G = -(dxc(u h_u dy_fc cx) + dyc(v h_v dx_cf cy)) mask_c / (Az_cc h_c)
//   layered (n_tr Nz tracer-major planes over Nz velocity layers, S = 1;
//   models/layered.py:815-822): u and v are masked, so u dzu == u dz_k and
//     G = -(dxc(u dz_k dy_fc cx) + dyc(v dz_k dx_cf cy)) IV,  IV = mask_c / (Az_cc dz_k)
// The flux factors are applied in the plain version's order, ((u h) len) cx with
// h = h_u or dz_k, not through a prefactored A_u, so the kernel differs from the
// port's plain version (kernels/tracer_adv.py) only where nvcc contracts into an FMA.
//
// What bounds it on the H100: bytes if the neighbour reads hit L1/L2. Column mode
// reads c, u, v and 5 static planes and writes G: 9 planes of 690 x 1450 f32 (4 MB
// each), 36 MB per call, 11 us at 3.35 TB/s. Layered mode at the baroclinic front's
// 1/4-degree x 10 (one tracer stack of 10 planes) reads c, u, v, IV (40 planes) and
// the 2 shared metric planes and writes G (10 planes): 0.2 GB, 60 us. About
// 4 x 70 flops per cell and plane (four face reconstructions: each thread
// recomputes both x faces and both y faces of its cell), 0.3 GFLOP per plane; at
// f64 the flops bound it.
//
// Design: one thread per cell (and plane, blockIdx.z, in layered mode), neighbour
// reads from global memory through L1/L2. Cells within 4 of the edge (the reach of
// the Pallas kernel; this stencil reaches 3) are written 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5.cuh"

namespace {

enum { H_U, DY_FC, H_V, DX_CF, INV_VOL, N_STATIC };
constexpr int REACH = 4;

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

template <typename T>
__global__ void tracer_adv_kernel(const T* __restrict__ c, const T* __restrict__ u,
                                  const T* __restrict__ v, const T* __restrict__ st,
                                  T* __restrict__ G, int Yb, int Xb) {
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
  G[k] = -(gx + gy) * st[INV_VOL * P + k];
}

// Layered mode: blockIdx.z is the tracer plane t Nz + layer; g = [dy_fc, dx_cf].
template <typename T>
__global__ void tracer_adv_layered_kernel(const T* __restrict__ c, const T* __restrict__ u,
                                          const T* __restrict__ v, const T* __restrict__ iv,
                                          const T* __restrict__ g, const T* __restrict__ dz,
                                          T* __restrict__ G, int nz, int Yb, int Xb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xb || j >= Yb) return;
  const int64_t P = (int64_t)Yb * Xb;
  const int layer = blockIdx.z % nz;
  c += blockIdx.z * P;
  G += blockIdx.z * P;
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
  G[k] = -(gx + gy) * iv[layer * P + k];
}

template <typename T>
int launch(const void* c, const void* u, const void* v, const void* st, void* G, int Yb,
           int Xb, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y);
  tracer_adv_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)c, (const T*)u, (const T*)v, (const T*)st, (T*)G, Yb, Xb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_layered(const void* c, const void* u, const void* v, const void* iv,
                   const void* g, const void* dz, void* G, int n_planes, int nz, int Yb,
                   int Xb, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y, n_planes);
  tracer_adv_layered_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)c, (const T*)u, (const T*)v, (const T*)iv, (const T*)g, (const T*)dz,
      (T*)G, nz, Yb, Xb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osg_tracer_adv_f32(const void* c, const void* u, const void* v,
                                  const void* st, void* G, int Yb, int Xb, void* stream) {
  return launch<float>(c, u, v, st, G, Yb, Xb, stream);
}

extern "C" int osg_tracer_adv_f64(const void* c, const void* u, const void* v,
                                  const void* st, void* G, int Yb, int Xb, void* stream) {
  return launch<double>(c, u, v, st, G, Yb, Xb, stream);
}

extern "C" int osg_tracer_adv_layered_f32(const void* c, const void* u, const void* v,
                                          const void* iv, const void* g, const void* dz,
                                          void* G, int n_planes, int nz, int Yb, int Xb,
                                          void* stream) {
  return launch_layered<float>(c, u, v, iv, g, dz, G, n_planes, nz, Yb, Xb, stream);
}

extern "C" int osg_tracer_adv_layered_f64(const void* c, const void* u, const void* v,
                                          const void* iv, const void* g, const void* dz,
                                          void* G, int n_planes, int nz, int Yb, int Xb,
                                          void* stream) {
  return launch_layered<double>(c, u, v, iv, g, dz, G, n_planes, nz, Yb, Xb, stream);
}
