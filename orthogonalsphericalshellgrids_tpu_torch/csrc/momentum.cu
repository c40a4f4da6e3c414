// Vector-invariant horizontal momentum tendencies of a stack of layers, with the
// fused nu_h Laplacians and quadratic bottom drag.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:momentum_pallas
// (_kernel) without its acc/mask_out operands, in its two uses: one layer with
// has_mask (the single-layer model) and Nz layers without (models/layered.py:704-710,
// where the tendency is masked after the vertical terms are added), each with or
// without the per-layer closure pack. Its math is pallas_mom.py:198-259, which the
// port's plain version (kernels/momentum.py) follows:
//   zeta   = (dxf(dy_cf v) - dyf(dx_fc u)) inv_az_ff,   q = zeta + f_ff
//   v_hat  = ixf(iyc(dx_cf v)) inv_dx_fc,               u_hat = iyf(ixc(dy_fc u)) inv_dy_cf
//   q_at_u = upwind WENO-5 of q in y at the u point, upwinded on v_hat
//   q_at_v = upwind WENO-5 of q in x at the v point, upwinded on u_hat
//   ke     = (ixc(u^2) + iyc(v^2)) / 2
//   Gu = (q_at_u v_hat - dxf(ke) inv_dx_fc) [mask_u]
//   Gv = (-q_at_v u_hat - dyf(ke) inv_dy_cf) [mask_v]
// then, from the layer's planes of the closure pack (plane k L + i, L = 6 has_lap +
// 2 has_drag), the free-slip Laplacians
//   Gu += (dxf((dxc u) LU_C) + dyc((dyf u) LU_F)) LU_S
//   Gv += (dxc((dxf v) LV_F) + dyf((dyc v) LV_C)) LV_S
// and the quadratic drag Gu -= DR_U sp_u u, Gv -= DR_V sp_v v with
// sp_u = sqrt(u^2 + ixf(iyc v)^2), sp_v = sqrt(v^2 + iyf(ixc u)^2). The 8 metric
// planes are shared by every layer; the two mask planes exist only with has_mask.
// Each option is a template switch, so the single-layer no-closure path is the same
// expression as without the closures.
//
// What bounds it on the H100: bytes, if the neighbour reads hit L1/L2. Per cell and
// layer it reads u, v and the static planes and writes Gu, Gv. One masked layer of
// 690 x 1450 f32 (4 MB a plane): 14 planes, 56 MB, 17 us at 3.35 TB/s. Ten layers
// of the baroclinic front: u, v, Gu, Gv of every layer (40 planes) plus the 8
// shared planes, read once if they stay in L2 (32 MB of its 50 MB) and once per
// layer if not: 0.19 to 0.48 GB, 0.06 to 0.14 ms. The gyre adds 8 closure planes a
// layer (80 planes, 0.32 GB at 1/4 degree x 10). About 300 flops per cell and layer
// (two WENO-5 reconstructions plus the 12 vorticity values they need) and 40 more
// for the closures, 0.3 GFLOP per layer, 5 us at the 67 TFLOP/s f32 rate; at f64
// the flops bound it.
//
// Design: one thread per cell and layer (blockIdx.z is the layer), neighbour reads
// straight from global memory through L1/L2; each thread recomputes the vorticity
// at the 11 points its two stencils need, and the two Laplacian fluxes and drag
// speeds on each side of its own point. Cells within 3 of the edge (the stencil's
// reach) are written 0, so the output is finite everywhere and a grid with the
// smallest halo WENO-5 allows (3) keeps every interior cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5.cuh"

namespace {

enum { DY_CF, DX_FC, INV_AZ_FF, F_FF, DX_CF, INV_DX_FC, DY_FC, INV_DY_CF, MASK_U,
       MASK_V, N_STATIC };
enum { LU_C, LU_F, LU_S, LV_F, LV_C, LV_S };
constexpr int REACH = 3;

template <typename T>
struct Planes {
  const T* u;
  const T* v;
  const T* st;
  int64_t P;
  int X;
  __device__ __forceinline__ T s(int p, int64_t k) const { return st[p * P + k]; }
  // q = zeta + f at the FF point k
  __device__ __forceinline__ T q(int64_t k) const {
    const T dvx = s(DY_CF, k) * v[k] - s(DY_CF, k - 1) * v[k - 1];
    const T duy = s(DX_FC, k) * u[k] - s(DX_FC, k - X) * u[k - X];
    return (dvx - duy) * s(INV_AZ_FF, k) + s(F_FF, k);
  }
  __device__ __forceinline__ T ke(int64_t k) const {
    return T(0.5) * (T(0.5) * (u[k] * u[k] + u[k + 1] * u[k + 1]) +
                     T(0.5) * (v[k] * v[k] + v[k + X] * v[k + X]));
  }
};

// The closure terms at k of one layer, added to the (masked) advective gu, gv; lp is
// the layer's L = 6 HAS_LAP + 2 HAS_DRAG planes of P cells each.
template <typename T, bool HAS_LAP, bool HAS_DRAG>
__device__ __forceinline__ void add_closures(const T* __restrict__ u,
                                             const T* __restrict__ v,
                                             const T* __restrict__ lp, int64_t P,
                                             int64_t k, int64_t X, T& gu, T& gv) {
  if constexpr (HAS_LAP) {
    const T* lu_c = lp + LU_C * P;
    const T* lu_f = lp + LU_F * P;
    const T* lv_f = lp + LV_F * P;
    const T* lv_c = lp + LV_C * P;
    const T gxu0 = (u[k + 1] - u[k]) * lu_c[k];
    const T gxu1 = (u[k] - u[k - 1]) * lu_c[k - 1];
    const T gyu0 = (u[k] - u[k - X]) * lu_f[k];
    const T gyu1 = (u[k + X] - u[k]) * lu_f[k + X];
    gu = gu + ((gxu0 - gxu1) + (gyu1 - gyu0)) * lp[LU_S * P + k];
    const T gxv0 = (v[k] - v[k - 1]) * lv_f[k];
    const T gxv1 = (v[k + 1] - v[k]) * lv_f[k + 1];
    const T gyv0 = (v[k + X] - v[k]) * lv_c[k];
    const T gyv1 = (v[k] - v[k - X]) * lv_c[k - X];
    gv = gv + ((gxv1 - gxv0) + (gyv0 - gyv1)) * lp[LV_S * P + k];
  }
  if constexpr (HAS_DRAG) {
    const T* dr = lp + (HAS_LAP ? 6 : 0) * P;  // [DR_U, DR_V]
    const T vc0 = T(0.5) * (v[k] + v[k + X]);
    const T vc1 = T(0.5) * (v[k - 1] + v[k - 1 + X]);
    const T vu = T(0.5) * (vc0 + vc1);
    const T sp_u = sqrt(u[k] * u[k] + vu * vu);
    const T uc0 = T(0.5) * (u[k] + u[k + 1]);
    const T uc1 = T(0.5) * (u[k - X] + u[k - X + 1]);
    const T uv = T(0.5) * (uc0 + uc1);
    const T sp_v = sqrt(v[k] * v[k] + uv * uv);
    gu = gu - dr[k] * sp_u * u[k];
    gv = gv - dr[P + k] * sp_v * v[k];
  }
}

template <typename T, bool HAS_MASK, bool HAS_LAP, bool HAS_DRAG>
__global__ void momentum_kernel(const T* __restrict__ u, const T* __restrict__ v,
                                const T* __restrict__ st, const T* __restrict__ lay,
                                T* __restrict__ Gu, T* __restrict__ Gv, int Yb, int Xb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xb || j >= Yb) return;
  const int64_t layer = (int64_t)blockIdx.z * Yb * Xb;
  u += layer;
  v += layer;
  Gu += layer;
  Gv += layer;
  const int64_t k = (int64_t)j * Xb + i;
  if (i < REACH || j < REACH || i >= Xb - REACH || j >= Yb - REACH) {
    Gu[k] = T(0);
    Gv[k] = T(0);
    return;
  }
  const Planes<T> p{u, v, st, (int64_t)Yb * Xb, Xb};
  const int64_t X = Xb;

  // v_hat at the u point, u_hat at the v point
  const T iy0 = T(0.5) * (p.s(DX_CF, k) * v[k] + p.s(DX_CF, k + X) * v[k + X]);
  const T iy1 = T(0.5) * (p.s(DX_CF, k - 1) * v[k - 1] + p.s(DX_CF, k - 1 + X) * v[k - 1 + X]);
  const T v_hat = T(0.5) * (iy0 + iy1) * p.s(INV_DX_FC, k);
  const T ix0 = T(0.5) * (p.s(DY_FC, k) * u[k] + p.s(DY_FC, k + 1) * u[k + 1]);
  const T ix1 = T(0.5) * (p.s(DY_FC, k - X) * u[k - X] + p.s(DY_FC, k - X + 1) * u[k - X + 1]);
  const T u_hat = T(0.5) * (ix0 + ix1) * p.s(INV_DY_CF, k);

  const T qc = p.q(k);
  // q along y at rows j-2..j+3 (face index j+1 of the reconstruction)
  const T q_at_u = weno5_upwind(v_hat > T(0), p.q(k - 2 * X), p.q(k - X), qc, p.q(k + X),
                                p.q(k + 2 * X), p.q(k + 3 * X));
  const T q_at_v = weno5_upwind(u_hat > T(0), p.q(k - 2), p.q(k - 1), qc, p.q(k + 1),
                                p.q(k + 2), p.q(k + 3));

  const T kc = p.ke(k);
  const T gu = q_at_u * v_hat - (kc - p.ke(k - 1)) * p.s(INV_DX_FC, k);
  const T gv = -q_at_v * u_hat - (kc - p.ke(k - X)) * p.s(INV_DY_CF, k);
  if constexpr (HAS_LAP || HAS_DRAG) {
    // the single-layer convention: the advective part is masked first
    T cu = HAS_MASK ? gu * p.s(MASK_U, k) : gu;
    T cv = HAS_MASK ? gv * p.s(MASK_V, k) : gv;
    constexpr int L = 6 * HAS_LAP + 2 * HAS_DRAG;
    add_closures<T, HAS_LAP, HAS_DRAG>(u, v, lay + (int64_t)blockIdx.z * L * p.P, p.P, k,
                                       X, cu, cv);
    Gu[k] = cu;
    Gv[k] = cv;
  } else {
    Gu[k] = HAS_MASK ? gu * p.s(MASK_U, k) : gu;
    Gv[k] = HAS_MASK ? gv * p.s(MASK_V, k) : gv;
  }
}

template <typename T, bool HAS_MASK, bool HAS_LAP, bool HAS_DRAG>
void launch_one(const void* u, const void* v, const void* st, const void* lay, void* Gu,
                void* Gv, int nz, int Yb, int Xb, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y, nz);
  momentum_kernel<T, HAS_MASK, HAS_LAP, HAS_DRAG><<<grid, block, 0, stream>>>(
      (const T*)u, (const T*)v, (const T*)st, (const T*)lay, (T*)Gu, (T*)Gv, Yb, Xb);
}

template <typename T, bool HAS_MASK>
void launch_mask(const void* u, const void* v, const void* st, const void* lay, void* Gu,
                 void* Gv, int nz, int Yb, int Xb, int has_lap, int has_drag,
                 cudaStream_t s) {
  if (has_lap && has_drag)
    launch_one<T, HAS_MASK, true, true>(u, v, st, lay, Gu, Gv, nz, Yb, Xb, s);
  else if (has_lap)
    launch_one<T, HAS_MASK, true, false>(u, v, st, lay, Gu, Gv, nz, Yb, Xb, s);
  else if (has_drag)
    launch_one<T, HAS_MASK, false, true>(u, v, st, lay, Gu, Gv, nz, Yb, Xb, s);
  else
    launch_one<T, HAS_MASK, false, false>(u, v, st, lay, Gu, Gv, nz, Yb, Xb, s);
}

template <typename T>
int launch(const void* u, const void* v, const void* st, const void* lay, void* Gu,
           void* Gv, int nz, int Yb, int Xb, int has_mask, int has_lap, int has_drag,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (has_mask)
    launch_mask<T, true>(u, v, st, lay, Gu, Gv, nz, Yb, Xb, has_lap, has_drag, s);
  else
    launch_mask<T, false>(u, v, st, lay, Gu, Gv, nz, Yb, Xb, has_lap, has_drag, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osg_momentum_f32(const void* u, const void* v, const void* st,
                                const void* lay, void* Gu, void* Gv, int nz, int Yb,
                                int Xb, int has_mask, int has_lap, int has_drag,
                                void* stream) {
  return launch<float>(u, v, st, lay, Gu, Gv, nz, Yb, Xb, has_mask, has_lap, has_drag,
                       stream);
}

extern "C" int osg_momentum_f64(const void* u, const void* v, const void* st,
                                const void* lay, void* Gu, void* Gv, int nz, int Yb,
                                int Xb, int has_mask, int has_lap, int has_drag,
                                void* stream) {
  return launch<double>(u, v, st, lay, Gu, Gv, nz, Yb, Xb, has_mask, has_lap, has_drag,
                        stream);
}
