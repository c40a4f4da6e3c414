// Vector-invariant horizontal momentum tendencies of a stack of layers, with the
// fused nu_h Laplacians, quadratic bottom drag, an additive pair and a closing mask.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:momentum_pallas
// (_kernel) with all its operands, in its two uses: one layer with has_mask (the
// single-layer model) and Nz layers without (models/layered.py:704-710), each with or
// without the per-layer closure pack, the additive (acc_u, acc_v) and the closing
// (out_u, out_v) mask. Its math is pallas_mom.py:198-268, which the port's plain
// version (kernels/momentum.py) follows:
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
// sp_u = sqrt(u^2 + ixf(iyc v)^2), sp_v = sqrt(v^2 + iyf(ixc u)^2); then
//   Gu = (Gu + acc_u) out_u,   Gv = (Gv + acc_v) out_v
// where each pair is given. The 8 metric planes are shared by every layer; the two
// mask planes exist only with has_mask.
//
// What bounds it on the H100: bytes and the WENO-5 arithmetic, about equally at f32.
// Ten layers of 690 x 1450 (4 MB a plane): u, v, Gu, Gv (40 planes) and the 8
// shared planes read once, 0.19 GB, 58 us at 3.35 TB/s; acc and the closing mask add
// 40 planes (0.35 GB, 0.10 ms), the gyre's closure pack 80 more. Two upwind WENO-5
// reconstructions a cell and layer, each with 7 IEEE divisions: 0.12 ms at the
// measured WENO-5 rate. One masked layer: 14 planes, 17 us.
//
// Design: the TPU kernel's grid order, row blocks outer and layers inner (statics
// reuse), as a CUDA tile. Each CTA of 256 threads owns a TY x TX tile of output cells
// and loops over the layers itself; the grid covers the (y, x) tiles only.
//   - The 8 metric planes of the tile and its REACH-cell ring (the window) go to
//     shared memory once per CTA and serve every layer.
//   - Per layer: u and v over the window to shared memory, then q = zeta + f once per
//     window point (less the first row and column) and KE once per point of the tile
//     and its one-cell ring, into shared memory; then each cell's two
//     reconstructions read q from there, with the stencil's operands selected on the
//     upwind side first so that a warp whose signs differ evaluates one
//     reconstruction, not two; v_hat and u_hat come from the shared u, v and metrics.
//   - Windows load through registers, every load of a batch issued before its first
//     store: the metric planes and layer 0's u and v in two batches of five planes,
//     each later layer's u and v in one. 4-byte cp.async copies (rows of 1450 floats
//     are not 16-byte aligned, so neither 16-byte copies nor a TMA tile can take
//     them) lost on the H100, with the next layer prefetched and without, and so did
//     copying acc, mask_out and the closure pack to shared memory a layer ahead
//     (PERF.md §6).
//   - The mask planes, the closure pack, acc and the closing mask have no reuse
//     across layers: each cell reads them from global memory, coalesced.
//   - Tiles are clipped at the plane's edge; window cells outside the array are 0 and
//     never feed a kept cell. Cells within REACH of the edge (the stencil's reach)
//     are written 0, so the output is finite everywhere and a grid with the smallest
//     halo WENO-5 allows (3) keeps every interior cell.
// kernels/momentum.py:launch_plan holds the same tile per dtype; the entry refuses a
// plan made for another. Only FMA contraction separates it from the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5.cuh"

namespace {

enum { DY_CF, DX_FC, INV_AZ_FF, F_FF, DX_CF, INV_DX_FC, DY_FC, INV_DY_CF, N_METRIC };
enum { MASK_U = N_METRIC, MASK_V };
enum { LU_C, LU_F, LU_S, LV_F, LV_C, LV_S };
constexpr int REACH = 3;
constexpr int THREADS = 256;

// the output tile of a CTA, (rows, columns), per dtype
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int Y = 8, X = 64; };
template <> struct Tile<double> { static constexpr int Y = 8, X = 32; };

// Shared memory of one CTA: the metric planes, u and v over the window (WY x WX);
// q at window rows and columns from 1 (QY x QX); KE at window rows 2..TY+2 and
// columns 2..TX+2 (KY x KX).
template <typename T>
struct Layout {
  static constexpr int TY = Tile<T>::Y, TX = Tile<T>::X;
  static constexpr int WY = TY + 2 * REACH, WX = TX + 2 * REACH, WN = WY * WX;
  static constexpr int QY = TY + 5, QX = TX + 5, KY = TY + 1, KX = TX + 1;
  static constexpr int BYTES =
      ((N_METRIC + 2) * WN + QY * QX + KY * KX) * static_cast<int>(sizeof(T));
};

// The windows of NP planes into shared memory: window point p of plane i is the cell
// (y0 - REACH + p / WX, x0 - REACH + p % WX) of src[i], 0 outside the array. Every
// load is issued before the first store.
template <typename T, int WX, int WN, int NP>
__device__ __forceinline__ void load_windows(const T* const (&src)[NP],
                                             T* const (&dst)[NP], int y0, int x0, int Yb,
                                             int Xb) {
  constexpr int N = (WN + THREADS - 1) / THREADS;
  T val[NP][N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int p = threadIdx.x + it * THREADS;
    const int y = y0 - REACH + p / WX, x = x0 - REACH + p % WX;
    const bool in = p < WN && y >= 0 && y < Yb && x >= 0 && x < Xb;
    const int64_t k = (int64_t)y * Xb + x;
#pragma unroll
    for (int i = 0; i < NP; ++i) val[i][it] = in ? src[i][k] : T(0);
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int p = threadIdx.x + it * THREADS;
    if (p < WN) {
#pragma unroll
      for (int i = 0; i < NP; ++i) dst[i][p] = val[i][it];
    }
  }
}

// The closure terms of one cell, added to the (masked) advective gu, gv: u and v at
// window point w of the shared windows (row stride WX); lp is the layer's L = 6
// HAS_LAP + 2 HAS_DRAG planes of P cells each, read at the cell's plane index k.
template <typename T, bool HAS_LAP, bool HAS_DRAG, int WX>
__device__ __forceinline__ void add_closures(const T* su, const T* sv, int w,
                                             const T* __restrict__ lp, int64_t P,
                                             int64_t k, int64_t X, T& gu, T& gv) {
  if constexpr (HAS_LAP) {
    const T* lu_c = lp + LU_C * P;
    const T* lu_f = lp + LU_F * P;
    const T* lv_f = lp + LV_F * P;
    const T* lv_c = lp + LV_C * P;
    const T gxu0 = (su[w + 1] - su[w]) * lu_c[k];
    const T gxu1 = (su[w] - su[w - 1]) * lu_c[k - 1];
    const T gyu0 = (su[w] - su[w - WX]) * lu_f[k];
    const T gyu1 = (su[w + WX] - su[w]) * lu_f[k + X];
    gu = gu + ((gxu0 - gxu1) + (gyu1 - gyu0)) * lp[LU_S * P + k];
    const T gxv0 = (sv[w] - sv[w - 1]) * lv_f[k];
    const T gxv1 = (sv[w + 1] - sv[w]) * lv_f[k + 1];
    const T gyv0 = (sv[w + WX] - sv[w]) * lv_c[k];
    const T gyv1 = (sv[w] - sv[w - WX]) * lv_c[k - X];
    gv = gv + ((gxv1 - gxv0) + (gyv0 - gyv1)) * lp[LV_S * P + k];
  }
  if constexpr (HAS_DRAG) {
    const T* dr = lp + (HAS_LAP ? 6 : 0) * P;  // [DR_U, DR_V]
    const T vc0 = T(0.5) * (sv[w] + sv[w + WX]);
    const T vc1 = T(0.5) * (sv[w - 1] + sv[w - 1 + WX]);
    const T vu = T(0.5) * (vc0 + vc1);
    const T sp_u = sqrt(su[w] * su[w] + vu * vu);
    const T uc0 = T(0.5) * (su[w] + su[w + 1]);
    const T uc1 = T(0.5) * (su[w - WX] + su[w - WX + 1]);
    const T uv = T(0.5) * (uc0 + uc1);
    const T sp_v = sqrt(sv[w] * sv[w] + uv * uv);
    gu = gu - dr[k] * sp_u * su[w];
    gv = gv - dr[P + k] * sp_v * sv[w];
  }
}

struct Args {
  const void *u, *v, *st, *lay, *acc_u, *acc_v, *out_u, *out_v;
  void *Gu, *Gv;
  int nz, Yb, Xb;
};

template <typename T, bool HAS_MASK, bool HAS_LAP, bool HAS_DRAG>
__global__ void __launch_bounds__(THREADS)
    momentum_kernel(const T* __restrict__ u, const T* __restrict__ v,
                    const T* __restrict__ st, const T* __restrict__ lay,
                    const T* __restrict__ acc_u, const T* __restrict__ acc_v,
                    const T* __restrict__ out_u, const T* __restrict__ out_v,
                    T* __restrict__ Gu, T* __restrict__ Gv, int nz, int Yb, int Xb) {
  using Lo = Layout<T>;
  constexpr int TY = Lo::TY, TX = Lo::TX, WX = Lo::WX, WN = Lo::WN;
  constexpr int QX = Lo::QX, KX = Lo::KX;
  constexpr int L = 6 * HAS_LAP + 2 * HAS_DRAG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // metric plane i at sm + i WN
  T* su = sm + N_METRIC * WN;
  T* sv = su + WN;
  T* sq = sv + WN;
  T* ske = sq + Lo::QY * QX;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int64_t P = (int64_t)Yb * Xb;
  const int64_t X = Xb;

  {  // the metric planes and layer 0's u and v, in two batches of five planes
    const T* const src0[5] = {st, st + P, st + 2 * P, st + 3 * P, st + 4 * P};
    T* const dst0[5] = {sm, sm + WN, sm + 2 * WN, sm + 3 * WN, sm + 4 * WN};
    load_windows<T, WX, WN, 5>(src0, dst0, y0, x0, Yb, Xb);
    const T* const src1[5] = {st + 5 * P, st + 6 * P, st + 7 * P, u, v};
    T* const dst1[5] = {sm + 5 * WN, sm + 6 * WN, sm + 7 * WN, su, sv};
    load_windows<T, WX, WN, 5>(src1, dst1, y0, x0, Yb, Xb);
  }

#pragma unroll 1
  for (int layer = 0; layer < nz; ++layer) {
    const int64_t off = layer * P;
    if (layer > 0) {
      __syncthreads();  // the previous layer's reads of su, sv, sq, ske are done
      const T* const src[2] = {u + off, v + off};
      T* const dst[2] = {su, sv};
      load_windows<T, WX, WN, 2>(src, dst, y0, x0, Yb, Xb);
    }
    __syncthreads();
#pragma unroll 1
    for (int p = threadIdx.x; p < Lo::QY * QX; p += THREADS) {
      const int w = (1 + p / QX) * WX + 1 + p % QX;
      const T dvx = sm[DY_CF * WN + w] * sv[w] - sm[DY_CF * WN + w - 1] * sv[w - 1];
      const T duy = sm[DX_FC * WN + w] * su[w] - sm[DX_FC * WN + w - WX] * su[w - WX];
      sq[p] = (dvx - duy) * sm[INV_AZ_FF * WN + w] + sm[F_FF * WN + w];
    }
#pragma unroll 1
    for (int p = threadIdx.x; p < Lo::KY * KX; p += THREADS) {
      const int w = (2 + p / KX) * WX + 2 + p % KX;
      ske[p] = T(0.5) * (T(0.5) * (su[w] * su[w] + su[w + 1] * su[w + 1]) +
                         T(0.5) * (sv[w] * sv[w] + sv[w + WX] * sv[w + WX]));
    }
    __syncthreads();

#pragma unroll 1
    for (int p = threadIdx.x; p < TY * TX; p += THREADS) {
      const int ly = p / TX, lx = p % TX;
      const int j = y0 + ly, i = x0 + lx;
      if (j >= Yb || i >= Xb) continue;
      const int64_t kk = (int64_t)j * Xb + i;  // the cell in its plane
      const int64_t k = off + kk;
      if (i < REACH || j < REACH || i >= Xb - REACH || j >= Yb - REACH) {
        Gu[k] = T(0);
        Gv[k] = T(0);
        continue;
      }
      const int w = (ly + REACH) * WX + lx + REACH;
      const T* dx_cf = sm + DX_CF * WN;
      const T* dy_fc = sm + DY_FC * WN;
      const T inv_dx = sm[INV_DX_FC * WN + w];
      const T inv_dy = sm[INV_DY_CF * WN + w];

      // v_hat at the u point, u_hat at the v point
      const T iy0 = T(0.5) * (dx_cf[w] * sv[w] + dx_cf[w + WX] * sv[w + WX]);
      const T iy1 = T(0.5) * (dx_cf[w - 1] * sv[w - 1] + dx_cf[w - 1 + WX] * sv[w - 1 + WX]);
      const T v_hat = T(0.5) * (iy0 + iy1) * inv_dx;
      const T ix0 = T(0.5) * (dy_fc[w] * su[w] + dy_fc[w + 1] * su[w + 1]);
      const T ix1 = T(0.5) * (dy_fc[w - WX] * su[w - WX] + dy_fc[w - WX + 1] * su[w - WX + 1]);
      const T u_hat = T(0.5) * (ix0 + ix1) * inv_dy;

      // q along y at rows j-2..j+3 and along x at columns i-2..i+3 (face index j+1,
      // i+1 of the reconstruction); q of window point (r, c) is sq[(r-1) QX + c-1]
      const int qc = (ly + REACH - 1) * QX + lx + REACH - 1;
      const T q_at_u = weno5_upwind_selected(v_hat > T(0), sq[qc - 2 * QX], sq[qc - QX],
                                             sq[qc], sq[qc + QX], sq[qc + 2 * QX],
                                             sq[qc + 3 * QX]);
      const T q_at_v = weno5_upwind_selected(u_hat > T(0), sq[qc - 2], sq[qc - 1], sq[qc],
                                             sq[qc + 1], sq[qc + 2], sq[qc + 3]);

      // KE of window point (r, c) is ske[(r-2) KX + c-2]
      const int kc = (ly + REACH - 2) * KX + lx + REACH - 2;
      const T ke_c = ske[kc];
      T gu = q_at_u * v_hat - (ke_c - ske[kc - 1]) * inv_dx;
      T gv = -q_at_v * u_hat - (ke_c - ske[kc - KX]) * inv_dy;
      if constexpr (HAS_MASK) {
        // the single-layer convention: the advective part is masked first
        gu = gu * st[MASK_U * P + kk];
        gv = gv * st[MASK_V * P + kk];
      }
      if constexpr (L > 0)
        add_closures<T, HAS_LAP, HAS_DRAG, WX>(su, sv, w, lay + (int64_t)layer * L * P, P,
                                               kk, X, gu, gv);
      if (acc_u != nullptr) {
        gu = gu + acc_u[k];
        gv = gv + acc_v[k];
      }
      if (out_u != nullptr) {
        gu = gu * out_u[k];
        gv = gv * out_v[k];
      }
      Gu[k] = gu;
      Gv[k] = gv;
    }
  }
}

template <typename T, bool HAS_MASK, bool HAS_LAP, bool HAS_DRAG>
int launch_one(const Args& a, cudaStream_t s) {
  using Lo = Layout<T>;
  if constexpr (Lo::BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        momentum_kernel<T, HAS_MASK, HAS_LAP, HAS_DRAG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Lo::BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.Xb + Lo::TX - 1) / Lo::TX, (a.Yb + Lo::TY - 1) / Lo::TY);
  momentum_kernel<T, HAS_MASK, HAS_LAP, HAS_DRAG><<<grid, THREADS, Lo::BYTES, s>>>(
      (const T*)a.u, (const T*)a.v, (const T*)a.st, (const T*)a.lay, (const T*)a.acc_u,
      (const T*)a.acc_v, (const T*)a.out_u, (const T*)a.out_v, (T*)a.Gu, (T*)a.Gv, a.nz,
      a.Yb, a.Xb);
  return (int)cudaGetLastError();
}

template <typename T, bool HAS_MASK>
int launch_mask(const Args& a, int has_lap, int has_drag, cudaStream_t s) {
  if (has_lap && has_drag) return launch_one<T, HAS_MASK, true, true>(a, s);
  if (has_lap) return launch_one<T, HAS_MASK, true, false>(a, s);
  if (has_drag) return launch_one<T, HAS_MASK, false, true>(a, s);
  return launch_one<T, HAS_MASK, false, false>(a, s);
}

template <typename T>
int launch(const Args& a, int has_mask, int has_lap, int has_drag, int ty, int tx,
           void* stream) {
  // a plan made for another tile, or a grid the launch cannot take, is refused
  if (ty != Tile<T>::Y || tx != Tile<T>::X || a.nz < 1 ||
      (a.Yb + Tile<T>::Y - 1) / Tile<T>::Y > 65535 ||
      (a.acc_u == nullptr) != (a.acc_v == nullptr) ||
      (a.out_u == nullptr) != (a.out_v == nullptr) ||
      (a.lay == nullptr) != (has_lap == 0 && has_drag == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return has_mask ? launch_mask<T, true>(a, has_lap, has_drag, s)
                  : launch_mask<T, false>(a, has_lap, has_drag, s);
}

}  // namespace

extern "C" int osg_momentum_f32(const void* u, const void* v, const void* st,
                                const void* lay, const void* acc_u, const void* acc_v,
                                const void* out_u, const void* out_v, void* Gu, void* Gv,
                                int nz, int Yb, int Xb, int has_mask, int has_lap,
                                int has_drag, int ty, int tx, void* stream) {
  return launch<float>({u, v, st, lay, acc_u, acc_v, out_u, out_v, Gu, Gv, nz, Yb, Xb},
                       has_mask, has_lap, has_drag, ty, tx, stream);
}

extern "C" int osg_momentum_f64(const void* u, const void* v, const void* st,
                                const void* lay, const void* acc_u, const void* acc_v,
                                const void* out_u, const void* out_v, void* Gu, void* Gv,
                                int nz, int Yb, int Xb, int has_mask, int has_lap,
                                int has_drag, int ty, int tx, void* stream) {
  return launch<double>({u, v, st, lay, acc_u, acc_v, out_u, out_v, Gu, Gv, nz, Yb, Xb},
                        has_mask, has_lap, has_drag, ty, tx, stream);
}
