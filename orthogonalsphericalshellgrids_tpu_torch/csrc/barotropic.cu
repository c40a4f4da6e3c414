// The split-explicit barotropic subcycle: n_sub forward-backward substeps of
// (eta, U, V) on the extended-halo grid, returning the SM05-weighted averages.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_baro.py:
// barotropic_substeps_pallas (_kernel), whose oracle is the XLA scan of
// models/hydrostatic.py:barotropic_substeps. Per substep, as the port's plain
// version (kernels/barotropic.py) writes it:
//   eta <- eta - dtau * ((dy_fc U)[i+1] - (dy_fc U)[i] + (dx_cf V)[j+1] - (dx_cf V)[j]) * inv_az
//   U   <- (U - dtau * (gH_u * (eta[i] - eta[i-1]) * inv_dx - GU)) * mask_u
//   V   <- (V - dtau * (gH_v * (eta[j] - eta[j-1]) * inv_dy - GV)) * mask_v
//   acc <- acc + w_m * (eta, U, V)
// dtau is folded into the factors once, in registers, as the TPU kernel does
// (c_az = dtau inv_az, c_u = dtau gH_u inv_dx, dtau GU, ...); the mask multiply stays.
//
// What bounds it on the H100: once the state stays on chip, operations and the
// loads of each window. The call is 21 x 724 x 1484 = 22.56 M point-substeps of
// about 30 flops, which the substep probe (csrc/probes.cu) runs at 732-806 G
// point-substeps/s: 0.028-0.031 ms. Its operands, 14 planes of 4.3 MB in and 3 out,
// take 0.026 ms at the measured stream rate. The two-launch-per-substep kernel this
// one replaced moved 26 planes a substep (2.35 GB a call) and took 1.11 ms.
//
// Design: time tiles with trapezoidal halos. Validity shrinks one cell per substep
// (each update reads one neighbour on each side), so a CTA that loads a window of
// its tile plus a ring of k cells can run k substeps with no exchange and end with
// its tile exact. One launch runs k substeps over every tile; ceil(n_sub / k)
// launches run the call (at float32 k <= 11: two launches for 21 substeps), and
// between them only the state (eta, U, V) and the three averages cross device
// memory. A thread owns PT consecutive rows of one column of the window and keeps
// their 9 factors, state and averages in registers; only the x-flux dy_fc U and
// eta, which a neighbouring column reads, and the y-flux of each thread's first row
// go through shared memory: two barriers a substep. The ring's cells compute values
// that never reach the tile; a neighbour outside the window is clamped to the cell
// itself, and cells outside the array hold 0, so every value stays finite. A tile's
// cells are written only by its CTA, and the sums run in substep order, so the
// result is deterministic and independent of the tile plan: the y-flux is rounded
// before its difference (mul_rn), since a thread's last row takes its northern flux
// from shared memory, where nvcc would otherwise fuse the product of the rows below
// into the difference, and a cell's eta would then depend on its row in the tile (a
// y-partitioned run tiles each rank's rows from its own first row). On the H100 the window
// of 64 x 48 at float32 takes 0.19 ms, its load phase and its compute phase one
// after the other (one 512-thread CTA an SM at 126 registers); the ring makes 2.9x
// the point-substeps of the plane. A persistent variant that copied the next tile's
// window into shared memory with 4-byte cp.async while computing took 0.21-0.23 ms,
// and one cooperative launch with a grid barrier every substep (design B,
// benchmarks/baro_persistent.cu) 0.70 ms.
//
// The per-substep x-wrap: the window's columns are read periodically
// (column L at Hx + (L - Hx) mod Nx), so a halo column is the interior column it
// copies, computed the same way, bitwise. The one exception is the plain version's
// read of the east halo column Hx + Nx at the seam: the flux that the column
// Hx + Nx - 1 reads east of itself is dy_fc[Hx + Nx] times U there, U the input's
// at substep 0 and the wrapped state after. The column whose source is Hx
// publishes that flux in place of its own.
//
// The launch plan (k, window, tile, grid) is computed in kernels/barotropic.py:
// launch_plan, which the CPU tests check and replay; the entry point verifies the
// window the plan assumed and returns cudaErrorInvalidValue on a mismatch or on a
// wrap whose halo does not fit the plane.
//
// Members (an ensemble, the counterpart of jax.vmap over the TPU kernel): n_members
// sets of (eta, U, V, GU, GV) at a member stride of one plane, sharing the factors,
// dtau and the weights. The grid's z index is the member: each CTA offsets its
// member's planes once, before the loads, and the state and the averages are
// written as (3, n_members, Ye, Xe), so that each average is one contiguous member
// stack. Every launch of the plan runs all members, and a member's cells see the
// arithmetic of a one-member launch, so each member is bitwise its own launch; with
// one member the offsets are 0 and the component stride is the plane, as before.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DY_FC, DX_CF, INV_AZ, GH_U, GH_V, INV_DX, INV_DY, MASK_U, MASK_V };

constexpr int K_LIMIT = 16;  // substeps a launch may run: the weights' buffer

// The window of one CTA: WX columns by NTY thread rows, each thread owning PT
// consecutive rows of its column, all of their values in registers (126 registers
// a thread at float32, one 512-thread CTA an SM). kernels/barotropic.py:WINDOW
// holds the same numbers.
template <typename T>
struct Window;
template <>
struct Window<float> {
  static constexpr int WX = 64, NTY = 8, PT = 6;
};
template <>
struct Window<double> {
  static constexpr int WX = 32, NTY = 8, PT = 4;
};

// a product rounded on its own, never fused into a following add
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

template <typename T, bool WRAP>
__global__ void __launch_bounds__(Window<T>::WX * Window<T>::NTY, 1)
    subcycle_kernel(const T* __restrict__ st, const T* __restrict__ eta_in,
                    const T* __restrict__ U_in, const T* __restrict__ V_in,
                    const T* __restrict__ GU, const T* __restrict__ GV,
                    T* __restrict__ state_out, T* __restrict__ acc,
                    const T* __restrict__ dtau_p, const T* __restrict__ weights, int m0,
                    int m1, int Ye, int Xe, int Nx, int Hx, int k) {
  constexpr int WX = Window<T>::WX, NTY = Window<T>::NTY, PT = Window<T>::PT;
  constexpr int WY = NTY * PT;
  __shared__ T fx_s[WY][WX];
  __shared__ T eta_s[WY][WX];
  __shared__ T fy_s[NTY][WX];
  __shared__ T seam_dy[WY], seam_u0[WY];
  __shared__ T w_s[K_LIMIT];

  const int tx = threadIdx.x, ty = threadIdx.y, y0 = ty * PT;
  const int TX = WX - 2 * k, TY = WY - 2 * k;
  const int L = blockIdx.x * TX - k + tx;  // the column: logical in wrap mode
  const int wy0 = blockIdx.y * TY - k;
  const int gx = WRAP ? Hx + pmod(L - Hx, Nx) : L;
  const bool col_in = WRAP || (L >= 0 && L < Xe);
  const bool seam = WRAP && gx == Hx;
  const bool out_col = tx >= k && tx < WX - k && L < Xe;
  const int64_t P = (int64_t)Ye * Xe;
  // this CTA's member: its planes, and the component stride of state_out and acc
  const int64_t MP = (int64_t)blockIdx.z * P, CS = (int64_t)gridDim.z * P;
  eta_in += MP;
  U_in += MP;
  V_in += MP;
  GU += MP;
  GV += MP;
  acc += MP;
  if (state_out != nullptr) state_out += MP;
  const T dtau = *dtau_p;
  if (ty == 0 && tx < m1 - m0) w_s[tx] = weights[m0 + tx];

  T dy[PT], dx[PT], caz[PT], cu[PT], cv[PT], mu[PT], mv[PT], gu[PT], gv[PT];
  T eta[PT], U[PT], V[PT], a0[PT], a1[PT], a2[PT];
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int y = y0 + r, gy = wy0 + y;
    a0[r] = a1[r] = a2[r] = T(0);
    if (col_in && gy >= 0 && gy < Ye) {
      const int64_t o = (int64_t)gy * Xe + gx;
      dy[r] = st[DY_FC * P + o];
      dx[r] = st[DX_CF * P + o];
      caz[r] = dtau * st[INV_AZ * P + o];
      cu[r] = dtau * st[GH_U * P + o] * st[INV_DX * P + o];
      cv[r] = dtau * st[GH_V * P + o] * st[INV_DY * P + o];
      mu[r] = st[MASK_U * P + o];
      mv[r] = st[MASK_V * P + o];
      gu[r] = dtau * GU[o];
      gv[r] = dtau * GV[o];
      eta[r] = eta_in[o];
      U[r] = U_in[o];
      V[r] = V_in[o];
      if (seam) {  // read by this thread only
        const int64_t e = (int64_t)gy * Xe + Hx + Nx;
        seam_dy[y] = st[DY_FC * P + e];
        seam_u0[y] = U_in[e];
      }
      if (m0 > 0 && out_col && y >= k && y < WY - k) {
        const int64_t q = (int64_t)gy * Xe + L;
        a0[r] = acc[q];
        a1[r] = acc[CS + q];
        a2[r] = acc[2 * CS + q];
      }
    } else {
      dy[r] = dx[r] = caz[r] = cu[r] = cv[r] = mu[r] = mv[r] = gu[r] = gv[r] = T(0);
      eta[r] = U[r] = V[r] = T(0);
      if (seam) seam_dy[y] = seam_u0[y] = T(0);
    }
  }
  __syncthreads();  // w_s

  const int xe = tx + 1 < WX ? tx + 1 : tx;
  const int xw = tx > 0 ? tx - 1 : tx;
  for (int m = m0; m < m1; ++m) {
    T fx[PT], fy[PT];
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      fx[r] = dy[r] * U[r];
      fy[r] = mul_rn(dx[r], V[r]);
      T pub = fx[r];
      if (seam) pub = seam_dy[y0 + r] * (m == 0 ? seam_u0[y0 + r] : U[r]);
      fx_s[y0 + r][tx] = pub;
    }
    fy_s[ty][tx] = fy[0];
    __syncthreads();
    const T fy_top = ty + 1 < NTY ? fy_s[ty + 1][tx] : fy[PT - 1];
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      const T fy_n = r + 1 < PT ? fy[r + 1] : fy_top;
      eta[r] = eta[r] - caz[r] * ((fx_s[y0 + r][xe] - fx[r]) + (fy_n - fy[r]));
      eta_s[y0 + r][tx] = eta[r];
    }
    __syncthreads();
    const T eta_bot = ty > 0 ? eta_s[y0 - 1][tx] : eta[0];
    const T w = w_s[m - m0];
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      const T eta_south = r > 0 ? eta[r - 1] : eta_bot;
      U[r] = (U[r] - (cu[r] * (eta[r] - eta_s[y0 + r][xw]) - gu[r])) * mu[r];
      V[r] = (V[r] - (cv[r] * (eta[r] - eta_south) - gv[r])) * mv[r];
      a0[r] = a0[r] + w * eta[r];
      a1[r] = a1[r] + w * U[r];
      a2[r] = a2[r] + w * V[r];
    }
    // the next substep writes fx_s and fy_s, which no thread reads after the
    // barrier above, and eta_s only after its first barrier
  }

  if (!out_col) return;
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    const int y = y0 + r, gy = wy0 + y;
    if (y < k || y >= WY - k || gy >= Ye) continue;
    const int64_t q = (int64_t)gy * Xe + L;
    if (state_out != nullptr) {
      state_out[q] = eta[r];
      state_out[CS + q] = U[r];
      state_out[2 * CS + q] = V[r];
    }
    acc[q] = a0[r];
    acc[CS + q] = a1[r];
    acc[2 * CS + q] = a2[r];
  }
}

// Launch l runs substeps [m0, m1) = [l k, min((l + 1) k, n_sub)). It reads the inputs
// (l = 0) or the state the launch before wrote (work set (l - 1) % 2) and writes
// work set l % 2, except the last launch; acc is the (3, n_members, Ye, Xe) output,
// written whole by the first launch, and so is each work set. wx and wy are the
// window the caller's plan assumed.
template <typename T, bool WRAP>
int run_wrap(const void* st, const void* eta, const void* U, const void* V, const void* GU,
             const void* GV, void* work, void* acc, const void* dtau, const void* weights,
             int n_sub, int n_members, int Ye, int Xe, int Nx, int Hx, int k,
             cudaStream_t stream) {
  constexpr int WX = Window<T>::WX, WY = Window<T>::NTY * Window<T>::PT;
  const int64_t MP = (int64_t)n_members * Ye * Xe;  // one component of every member
  const dim3 block(WX, Window<T>::NTY);
  const dim3 grid((Xe + WX - 2 * k - 1) / (WX - 2 * k), (Ye + WY - 2 * k - 1) / (WY - 2 * k),
                  n_members);
  const T* in[3] = {(const T*)eta, (const T*)U, (const T*)V};
  for (int m0 = 0, l = 0; m0 < n_sub; m0 += k, ++l) {
    const int m1 = m0 + k < n_sub ? m0 + k : n_sub;
    T* out = m1 < n_sub ? (T*)work + (l % 2) * 3 * MP : nullptr;
    subcycle_kernel<T, WRAP><<<grid, block, 0, stream>>>(
        (const T*)st, in[0], in[1], in[2], (const T*)GU, (const T*)GV, out, (T*)acc,
        (const T*)dtau, (const T*)weights, m0, m1, Ye, Xe, Nx, Hx, k);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    in[0] = out;
    in[1] = out + MP;
    in[2] = out + 2 * MP;
  }
  return 0;
}

template <typename T>
int run(const void* st, const void* eta, const void* U, const void* V, const void* GU,
        const void* GV, void* work, void* acc, const void* dtau, const void* weights,
        int n_sub, int n_members, int Ye, int Xe, int Nx, int Hx, int wrap, int k, int wx,
        int wy, cudaStream_t stream) {
  constexpr int WX = Window<T>::WX, WY = Window<T>::NTY * Window<T>::PT;
  if (wx != WX || wy != WY || n_sub < 1 || k < 1 || k > K_LIMIT || WX - 2 * k < 1 ||
      WY - 2 * k < 1 || n_members < 1 || n_members > 65535 ||
      (wrap && (Hx < 1 || Hx > Nx || Xe != Nx + 2 * Hx)))
    return (int)cudaErrorInvalidValue;
  if (wrap)
    return run_wrap<T, true>(st, eta, U, V, GU, GV, work, acc, dtau, weights, n_sub,
                             n_members, Ye, Xe, Nx, Hx, k, stream);
  return run_wrap<T, false>(st, eta, U, V, GU, GV, work, acc, dtau, weights, n_sub,
                            n_members, Ye, Xe, Nx, Hx, k, stream);
}

}  // namespace

#define OSG_BARO_ARGS                                                                     \
  const void *st, const void *eta, const void *U, const void *V, const void *GU,         \
      const void *GV, void *work, void *acc, const void *dtau, const void *weights,      \
      int n_sub, int n_members, int Ye, int Xe, int Nx, int Hx, int wrap, int k, int wx,  \
      int wy, void *stream

extern "C" int osg_barotropic_f32(OSG_BARO_ARGS) {
  return run<float>(st, eta, U, V, GU, GV, work, acc, dtau, weights, n_sub, n_members, Ye,
                    Xe, Nx, Hx, wrap, k, wx, wy, (cudaStream_t)stream);
}

extern "C" int osg_barotropic_f64(OSG_BARO_ARGS) {
  return run<double>(st, eta, U, V, GU, GV, work, acc, dtau, weights, n_sub, n_members, Ye,
                     Xe, Nx, Hx, wrap, k, wx, wy, (cudaStream_t)stream);
}
