// The layered step's post-barotropic update: AB2 predictor, split-explicit corrector
// and tracer update in one pass.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_corr.py:corrector_pallas
// (_kernel, pallas_corr.py:40-80). Per (y, x) column and layer k, with the AB2
// weights w1, w2 and the step dt read from device memory:
//   u*_k  = (u0_k + dt (w1 Gu_k - w2 Gu_old_k)) m_u,k,     m_u,k = (dzu_k != 0)
//   ubar  = sum_k u*_k dzu_k
//   u_k   = (u*_k + (U_a inv_h_u - ubar inv_h_u)) m_u,k
// the same for v, and for every tracer plane p (tracer-major, layer p mod Nz) and
// every plane of the prognostic buoyancy b when it is given
//   c_p   = (c0_p + dt (w1 Gc_p - w2 Gc_old_p)) mask_c,(p mod Nz).
// The masks are recovered exactly from the thickness carriers (no reciprocal), and
// U_a, V_a are the barotropic averages cropped to the base layout (a strided view of
// the widened free-surface arrays: the kernel reads them in place). The port's
// plain version (kernels/corrector.py) is the torch chain of models/layered.py.
//
// What bounds it on the H100: bytes. At 1/4 degree x 10 in f32 (planes of 690 x
// 1450, 4.0 MB) with two tracers and no b (P = 20): it reads u0, Gu, Gu_old, dzu and
// the same for v (80 planes), c0, Gc, Gc_old (60) and mask_c (10), plus inv_h and
// U_a for u and v (4), and writes u, v and c (40): 194 planes, 0.78 GB, 0.23 ms at
// 3.35 TB/s. About 8 flops per value, far below the f32 rate.
//
// Design: one thread per (y, x) column loops over the layers twice. The first pass
// writes u*_k to the output and sums u*_k dzu_k in a register; the second reads u*_k
// back (mostly from L2: the columns in flight hold about 20 MB) and applies the
// depth-mean replacement. The tracer planes are pointwise and take one pass. Nothing
// carries over between blocks, so no row blocking or padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T ab2(T x0, T g, T g_old, T w1, T w2, T dt) {
  return x0 + dt * (w1 * g - w2 * g_old);
}

// one velocity component of the column at k: predictor, depth sum, corrector
template <typename T>
__device__ __forceinline__ void velocity_column(
    const T* __restrict__ x0, const T* __restrict__ g, const T* __restrict__ g_old,
    const T* __restrict__ dzx, T inv_h, T X_a, T* __restrict__ out, int nz, int64_t P,
    int64_t k, T w1, T w2, T dt) {
  T xb = T(0);
  for (int l = 0; l < nz; ++l) {
    const int64_t kl = l * P + k;
    const T m = dzx[kl] != T(0) ? T(1) : T(0);
    const T xs = ab2(x0[kl], g[kl], g_old[kl], w1, w2, dt) * m;
    out[kl] = xs;
    xb = xb + xs * dzx[kl];
  }
  const T d = X_a * inv_h - xb * inv_h;
  for (int l = 0; l < nz; ++l) {
    const int64_t kl = l * P + k;
    const T m = dzx[kl] != T(0) ? T(1) : T(0);
    out[kl] = (out[kl] + d) * m;
  }
}

template <typename T>
__device__ __forceinline__ void tracer_planes(
    const T* __restrict__ c0, const T* __restrict__ g, const T* __restrict__ g_old,
    const T* __restrict__ mc, T* __restrict__ out, int n_planes, int nz, int64_t P,
    int64_t k, T w1, T w2, T dt) {
  for (int p = 0; p < n_planes; ++p) {
    const int64_t kp = p * P + k;
    out[kp] = ab2(c0[kp], g[kp], g_old[kp], w1, w2, dt) * mc[(p % nz) * P + k];
  }
}

template <typename T>
struct Args {
  const T *u0, *gu, *guo, *v0, *gv, *gvo, *c0, *gc, *gco, *b0, *gb, *gbo;
  const T *dzu, *dzv, *mc, *ihu, *ihv, *Ua, *Va, *w1, *w2, *dt;
  T *un, *vn, *cn, *bn;
};

template <typename T>
__global__ void corrector_kernel(Args<T> a, int n_c, int nz, int Yb, int Xb,
                                 int64_t pitch_a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Xb || j >= Yb) return;
  const int64_t P = (int64_t)Yb * Xb;
  const int64_t k = (int64_t)j * Xb + i;
  const int64_t ka = (int64_t)j * pitch_a + i;
  const T w1 = *a.w1, w2 = *a.w2, dt = *a.dt;
  velocity_column(a.u0, a.gu, a.guo, a.dzu, a.ihu[k], a.Ua[ka], a.un, nz, P, k, w1, w2, dt);
  velocity_column(a.v0, a.gv, a.gvo, a.dzv, a.ihv[k], a.Va[ka], a.vn, nz, P, k, w1, w2, dt);
  tracer_planes(a.c0, a.gc, a.gco, a.mc, a.cn, n_c, nz, P, k, w1, w2, dt);
  if (a.b0 != nullptr) tracer_planes(a.b0, a.gb, a.gbo, a.mc, a.bn, nz, nz, P, k, w1, w2, dt);
}

template <typename T>
int launch(void* const* p, int n_c, int nz, int Yb, int Xb, int64_t pitch_a,
           void* stream) {
  Args<T> a;
  const T** in[] = {&a.u0, &a.gu, &a.guo, &a.v0, &a.gv, &a.gvo, &a.c0, &a.gc, &a.gco,
                    &a.b0, &a.gb, &a.gbo, &a.dzu, &a.dzv, &a.mc, &a.ihu, &a.ihv, &a.Ua,
                    &a.Va, &a.w1, &a.w2, &a.dt};
  constexpr int n_in = sizeof(in) / sizeof(in[0]);
  for (int q = 0; q < n_in; ++q) *in[q] = (const T*)p[q];
  a.un = (T*)p[n_in];
  a.vn = (T*)p[n_in + 1];
  a.cn = (T*)p[n_in + 2];
  a.bn = (T*)p[n_in + 3];
  const dim3 block(32, 8);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y);
  corrector_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(a, n_c, nz, Yb, Xb,
                                                                 pitch_a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: u0, Gu, Gu_old, v0, Gv, Gv_old, c0, Gc, Gc_old, b0, Gb, Gb_old (the three b
// pointers null without a prognostic b), dzu, dzv, mask_c, inv_h_u, inv_h_v, U_a, V_a,
// w1, w2, dt, then the outputs u, v, c, b (b null without it).
extern "C" int osg_corrector_f32(void* const* ptrs, int n_c, int nz, int Yb, int Xb,
                                 int pitch_a, void* stream) {
  return launch<float>(ptrs, n_c, nz, Yb, Xb, pitch_a, stream);
}

extern "C" int osg_corrector_f64(void* const* ptrs, int n_c, int nz, int Yb, int Xb,
                                 int pitch_a, void* stream) {
  return launch<double>(ptrs, n_c, nz, Yb, Xb, pitch_a, stream);
}
