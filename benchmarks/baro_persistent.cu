// Design B of the barotropic subcycle, the persistent design that the port's
// time-tiled kernel (orthogonalsphericalshellgrids_tpu_torch/csrc/barotropic.cu) was
// measured against; built and timed only by benchmarks/torch_baro_ab.py, not part of
// the port. One cooperative launch, one CTA per SM, each CTA owning one
// tile of the plane for all n_sub substeps. The tile's state (eta, U, V) and a
// one-cell ring live in shared memory with its three averages; dtau GU and dtau GV
// live in registers; the 9 static planes (39 MB at 1/4 degree) are streamed from L2
// every substep. After each substep the CTA publishes its tile's edge cells to a
// ping-pong buffer in global memory, the grid synchronises, and each CTA reads its
// ring from its neighbours' edges. float32 and the no-wrap mode only, as the
// measurement needs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum { DY_FC, DX_CF, INV_AZ, GH_U, GH_V, INV_DX, INV_DY, MASK_U, MASK_V };

constexpr int B_THREADS = 1024;
constexpr int B_SLOTS = 8;  // tile cells a thread owns

__device__ __forceinline__ float ld(const float* p, int64_t P, int plane, int gy, int gx,
                                    int Ye, int Xe) {
  return (gy >= 0 && gy < Ye && gx >= 0 && gx < Xe) ? p[plane * P + (int64_t)gy * Xe + gx]
                                                     : 0.0f;
}

__global__ void __launch_bounds__(B_THREADS, 1)
    persistent_kernel(const float* __restrict__ st, const float* __restrict__ eta_in,
                      const float* __restrict__ U_in, const float* __restrict__ V_in,
                      const float* __restrict__ GU, const float* __restrict__ GV,
                      float* __restrict__ pub, float* __restrict__ acc_out,
                      const float* __restrict__ dtau_p, const float* __restrict__ w,
                      int n_sub, int Ye, int Xe, int TBY, int TBX, int gxn) {
  extern __shared__ __align__(16) float sm[];
  const int RW = TBX + 2, RH = TBY + 2, RN = RW * RH, TN = TBX * TBY;
  float* eta_s = sm;
  float* U_s = eta_s + RN;
  float* V_s = U_s + RN;
  float* a_s = V_s + RN;  // 3 x TN
  const int tid = threadIdx.x;
  const int ty0 = (blockIdx.x / gxn) * TBY, tx0 = (blockIdx.x % gxn) * TBX;
  const int64_t P = (int64_t)Ye * Xe;
  const float dtau = *dtau_p;
  cg::grid_group grid = cg::this_grid();

  // region cell (ry, rx) is global (ty0 - 1 + ry, tx0 - 1 + rx)
  for (int c = tid; c < RN; c += B_THREADS) {
    const int gy = ty0 - 1 + c / RW, gx = tx0 - 1 + c % RW;
    eta_s[c] = ld(eta_in, 0, 0, gy, gx, Ye, Xe);
    U_s[c] = ld(U_in, 0, 0, gy, gx, Ye, Xe);
    V_s[c] = ld(V_in, 0, 0, gy, gx, Ye, Xe);
  }
  float gu[B_SLOTS], gv[B_SLOTS];
#pragma unroll
  for (int s = 0; s < B_SLOTS; ++s) {
    const int c = tid + s * B_THREADS;
    gu[s] = gv[s] = 0.0f;
    if (c < TN) {
      const int gy = ty0 + c / TBX, gx = tx0 + c % TBX;
      gu[s] = dtau * ld(GU, 0, 0, gy, gx, Ye, Xe);
      gv[s] = dtau * ld(GV, 0, 0, gy, gx, Ye, Xe);
      a_s[c] = a_s[TN + c] = a_s[2 * TN + c] = 0.0f;
    }
  }
  __syncthreads();

  const int n_eta = TN + TBY + TBX;  // the tile, its west column and its south row
  for (int m = 0; m < n_sub; ++m) {
    // eta on the tile and the west/south ring, in place (it reads only its own eta)
#pragma unroll 3
    for (int e = tid; e < n_eta; e += B_THREADS) {
      int ry, rx;
      if (e < TN) {
        ry = 1 + e / TBX;
        rx = 1 + e % TBX;
      } else if (e < TN + TBY) {
        ry = 1 + (e - TN);
        rx = 0;
      } else {
        ry = 0;
        rx = 1 + (e - TN - TBY);
      }
      const int gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
      const int c = ry * RW + rx;
      const float fx = ld(st, P, DY_FC, gy, gx, Ye, Xe) * U_s[c];
      const float fxe = ld(st, P, DY_FC, gy, gx + 1, Ye, Xe) * U_s[c + 1];
      const float fy = ld(st, P, DX_CF, gy, gx, Ye, Xe) * V_s[c];
      const float fyn = ld(st, P, DX_CF, gy + 1, gx, Ye, Xe) * V_s[c + RW];
      const float caz = dtau * ld(st, P, INV_AZ, gy, gx, Ye, Xe);
      eta_s[c] = eta_s[c] - caz * ((fxe - fx) + (fyn - fy));
    }
    __syncthreads();
    const float wm = w[m];
#pragma unroll
    for (int s = 0; s < B_SLOTS; ++s) {
      const int t = tid + s * B_THREADS;
      if (t < TN) {
        const int ty = t / TBX, tx = t % TBX;
        const int gy = ty0 + ty, gx = tx0 + tx;
        const int c = (ty + 1) * RW + tx + 1;
        const float cu = dtau * ld(st, P, GH_U, gy, gx, Ye, Xe) * ld(st, P, INV_DX, gy, gx, Ye, Xe);
        const float cv = dtau * ld(st, P, GH_V, gy, gx, Ye, Xe) * ld(st, P, INV_DY, gy, gx, Ye, Xe);
        const float e = eta_s[c];
        const float u = (U_s[c] - (cu * (e - eta_s[c - 1]) - gu[s])) *
                        ld(st, P, MASK_U, gy, gx, Ye, Xe);
        const float v = (V_s[c] - (cv * (e - eta_s[c - RW]) - gv[s])) *
                        ld(st, P, MASK_V, gy, gx, Ye, Xe);
        U_s[c] = u;
        V_s[c] = v;
        a_s[t] = a_s[t] + wm * e;
        a_s[TN + t] = a_s[TN + t] + wm * u;
        a_s[2 * TN + t] = a_s[2 * TN + t] + wm * v;
        if (m + 1 < n_sub && (ty == 0 || tx == 0 || ty == TBY - 1 || tx == TBX - 1) &&
            gy < Ye && gx < Xe) {
          float* b = pub + (m % 2) * 3 * P + (int64_t)gy * Xe + gx;
          b[0] = e;
          b[P] = u;
          b[2 * P] = v;
        }
      }
    }
    if (m + 1 == n_sub) break;
    grid.sync();
    // the ring from the neighbours' edges
    const float* b = pub + (m % 2) * 3 * P;
    for (int c = tid; c < 2 * RW + 2 * TBY; c += B_THREADS) {
      int ry, rx;
      if (c < RW) {
        ry = 0;
        rx = c;
      } else if (c < 2 * RW) {
        ry = RH - 1;
        rx = c - RW;
      } else if (c < 2 * RW + TBY) {
        ry = 1 + c - 2 * RW;
        rx = 0;
      } else {
        ry = 1 + c - 2 * RW - TBY;
        rx = RW - 1;
      }
      const int gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
      const int r = ry * RW + rx;
      eta_s[r] = ld(b, P, 0, gy, gx, Ye, Xe);
      U_s[r] = ld(b, P, 1, gy, gx, Ye, Xe);
      V_s[r] = ld(b, P, 2, gy, gx, Ye, Xe);
    }
    __syncthreads();
  }
  __syncthreads();
  for (int t = tid; t < TN; t += B_THREADS) {
    const int gy = ty0 + t / TBX, gx = tx0 + t % TBX;
    if (gy < Ye && gx < Xe) {
      const int64_t q = (int64_t)gy * Xe + gx;
      acc_out[q] = a_s[t];
      acc_out[P + q] = a_s[TN + t];
      acc_out[2 * P + q] = a_s[2 * TN + t];
    }
  }
}

}  // namespace

// pub: 6 planes (two ping-pong edge buffers of eta, U, V); acc: 3 planes. Returns
// cudaErrorCooperativeLaunchTooLarge when no tile plan fits the co-resident grid.
extern "C" int osg_barotropic_persistent_f32(const void* st, const void* eta,
                                             const void* U, const void* V,
                                             const void* GU, const void* GV, void* pub,
                                             void* acc, const void* dtau,
                                             const void* weights, int n_sub, int Ye,
                                             int Xe, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int best_n = -1, best_gx = 0, best_tby = 0, best_tbx = 0;
  size_t best_smem = 0;
  for (int gx = 1; gx <= sms; ++gx) {
    const int gy = sms / gx;
    const int tbx = (Xe + gx - 1) / gx, tby = (Ye + gy - 1) / gy;
    const int n = tbx * tby;
    const size_t smem = (size_t)(3 * (tbx + 2) * (tby + 2) + 3 * n) * sizeof(float);
    if (n > B_THREADS * B_SLOTS || smem > 232448) continue;
    if (best_n < 0 || n < best_n) {
      best_n = n;
      best_gx = gx;
      best_tby = tby;
      best_tbx = tbx;
      best_smem = smem;
    }
  }
  if (best_n < 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaFuncSetAttribute(persistent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)best_smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_kernel, B_THREADS,
                                                best_smem);
  const int gxn = best_gx, gyn = (Ye + best_tby - 1) / best_tby;
  const int blocks = gxn * gyn;
  if (per_sm < 1 || blocks > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* st_ = (const float*)st;
  const float* e_ = (const float*)eta;
  const float* u_ = (const float*)U;
  const float* v_ = (const float*)V;
  const float* gu_ = (const float*)GU;
  const float* gv_ = (const float*)GV;
  float* pub_ = (float*)pub;
  float* acc_ = (float*)acc;
  const float* dt_ = (const float*)dtau;
  const float* w_ = (const float*)weights;
  int tby = best_tby, tbx = best_tbx;
  void* args[] = {&st_, &e_, &u_, &v_, &gu_, &gv_, &pub_, &acc_, &dt_, &w_,
                  &n_sub, &Ye, &Xe, &tby, &tbx, (void*)&gxn};
  cudaLaunchCooperativeKernel((const void*)persistent_kernel, dim3(blocks), dim3(B_THREADS),
                              args, best_smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

