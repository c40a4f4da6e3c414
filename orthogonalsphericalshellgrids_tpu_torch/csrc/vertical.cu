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
// The masks come from one plane of wet-layer counts n (int32, one a column): the
// model's masks are grid-fitted from one bottom (models/layered.py), so
//   mc_k = k < n,  mu_k = mc_k mc_k(i-1),  mv_k = mc_k mc_k(j-1)
// as 0/1 values, in place of the (Nz S) mask planes of the Pallas kernel's pack.
//
// What bounds it on the H100: bytes. At the 1/4-degree x 10 shape (planes of 690 x
// 1450, 4.0 MB at f32) the front (c and b) reads u, v, c, b (40 planes), the count
// plane and 5 metric planes and writes dGu, dGv and dGc (40 planes): 0.33 GB, 98 us
// at 3.35 TB/s; the gyre (T and S, linear EOS) the same bytes. About 60 flops per
// cell and layer: the flops do not bound it at f32 or f64.
//
// Design: one launch. A CTA of 256 threads owns a TY x TX tile of columns and the
// window of the tile plus one column to the west and one row to the south, where the
// stencil reads w and p (Tile<T>; kernels/vertical.py:launch_plan holds the same
// numbers and the chunk of interfaces, and the entry refuses another plan).
//   - w over the window is summed from the floor up, in the plain version's order,
//     into shared memory, a chunk of interfaces at a time: when Nz - 1 interfaces do
//     not fit (more than CHUNK<T>), each chunk is summed again from the floor, so its
//     sums keep the same order and Nz is bounded only by time. At Nz = 10 the one
//     chunk holds every interface.
//   - Then the layers top down: b (from T and S, or read) and the pressure integral
//     once per window point and layer, the running sum in the point's thread, p into
//     shared memory; each column's momentum terms from w and p of its own, west and
//     south points, the running interface terms in registers; then each tracer
//     block's flux divergence from w in registers and c of the layers above, at and
//     below (re-read through L1), so any number of blocks needs no per-block state.
//   - The next layer's u, v and buoyancy inputs are loaded before the present layer's
//     arithmetic; MIN_BLOCKS<T> holds the registers to three CTAs an SM at f32. Both
//     layer sums keep their order exactly (no total - prefix), so the kernel differs
//     from the plain version only where nvcc contracts a multiply and an add into one
//     FMA. Cells within 1 of the array edge (the stencil's reach) are written 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { DZ, RDZC, MRDZ, NUDZ, KAPDZ, N_COEF };       // coefficient rows
enum { IAZ, IDX, IDY, DYFC, DXCF, N_G };            // g_pack planes
enum { MODE_NONE = 0, MODE_TRACER_B = 1, MODE_LINEAR_EOS = 2 };
constexpr int THREADS = 256;

// the tile of columns a CTA owns, (rows, columns), one column a thread; the most
// interfaces of w a CTA holds in shared memory at once; and the CTAs an SM must hold
// at once (a register budget)
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int Y = 8, X = 32, CHUNK = 32, MIN_BLOCKS = 3;
};
template <> struct Tile<double> {
  static constexpr int Y = 8, X = 32, CHUNK = 16, MIN_BLOCKS = 2;
};

// The window: the tile and one column west and one row south of it, (TY + 1) x
// (TX + 1) points; window point p is the column (y0 - 1 + p / WX, x0 - 1 + p % WX).
template <typename T>
struct Layout {
  static constexpr int TY = Tile<T>::Y, TX = Tile<T>::X;
  static constexpr int WX = TX + 1, WN = (TY + 1) * WX;
  static constexpr int PTS = (WN + THREADS - 1) / THREADS;  // window points a thread
  static_assert(TY * TX == THREADS, "one column a thread");
  // shared memory for a chunk of nc interfaces: w, then p, then the counts
  static constexpr int bytes(int nc) {
    return (nc + 1) * WN * static_cast<int>(sizeof(T)) + WN * static_cast<int>(sizeof(int));
  }
};

struct Args {
  const void *u, *v, *c, *b;
  const int* n_wet;
  const void *g, *coef;
  void *dgu, *dgv, *dgc;
  int nz, n_c, n_tr, Yb, Xb, it_T, it_S, viscous, diffusive, chunk;
  double g_b, alpha, beta, T0, S0;
};

template <typename T>
__device__ __forceinline__ T mask(bool wet) { return wet ? T(1) : T(0); }

// w at the interfaces klo..khi of the window points this thread owns, summed from
// the floor (interface nz - 1) up as the plain version sums them; 0 where the column
// has no east or north neighbour in the array (no kept column reads it there).
template <typename T>
__device__ void w_chunk(const T* __restrict__ u, const T* __restrict__ v,
                        const T* __restrict__ g, const T* __restrict__ coef, T* sw, int klo,
                        int khi, int nz, int Yb, int Xb, int y0, int x0) {
  using Lo = Layout<T>;
  const int64_t P = (int64_t)Yb * Xb;
  const int64_t X = Xb;
#pragma unroll
  for (int it = 0; it < Lo::PTS; ++it) {
    const int p = threadIdx.x + it * THREADS;
    if (p >= Lo::WN) break;
    const int y = y0 - 1 + p / Lo::WX, x = x0 - 1 + p % Lo::WX;
    if (y < 0 || x < 0 || y >= Yb - 1 || x >= Xb - 1) {
      for (int k = klo; k <= khi; ++k) sw[(k - klo) * Lo::WN + p] = T(0);
      continue;
    }
    const int64_t c0 = (int64_t)y * Xb + x;
    const T iaz = g[IAZ * P + c0];
    const T dyfc = g[DYFC * P + c0], dyfc_e = g[DYFC * P + c0 + 1];
    const T dxcf = g[DXCF * P + c0], dxcf_n = g[DXCF * P + c0 + X];
    T acc = T(0);
#pragma unroll 2
    for (int k = nz - 1; k >= klo; --k) {
      const int64_t o = k * P + c0;
      const T fu = dyfc * u[o], fu_e = dyfc_e * u[o + 1];
      const T fv = dxcf * v[o], fv_n = dxcf_n * v[o + X];
      const T hdiv = coef[DZ * nz + k] * ((fu_e - fu) + (fv_n - fv)) * iaz;
      acc = (k == nz - 1) ? hdiv : acc + hdiv;
      if (k <= khi) sw[(k - klo) * Lo::WN + p] = -acc;
    }
  }
}

// The buoyancy inputs of layer k at column offset col: T and S (linear EOS) or b.
template <typename T, int MODE>
__device__ __forceinline__ void load_b(const T* __restrict__ c, const T* __restrict__ b,
                                       const Args& a, int k, int64_t P, int64_t col,
                                       bool in, T& x0, T& x1) {
  const int64_t o = k * P + col;
  if constexpr (MODE == MODE_TRACER_B) {
    x0 = in ? b[o] : T(0);
  } else if constexpr (MODE == MODE_LINEAR_EOS) {
    x0 = in && a.it_T >= 0 ? c[(int64_t)a.it_T * a.nz * P + o] : T(0);
    x1 = in && a.it_S >= 0 ? c[(int64_t)a.it_S * a.nz * P + o] : T(0);
  }
}

// b of a layer from its inputs, as vertical_plain forms it (mc the point's mask).
template <typename T, int MODE>
__device__ __forceinline__ T buoyancy(const Args& a, T x0, T x1, T mc) {
  if constexpr (MODE == MODE_TRACER_B) return x0;
  T bb = T(0);
  bool have = false;
  if (a.it_T >= 0) {
    bb = T(a.alpha) * (x0 - T(a.T0));
    have = true;
  }
  if (a.it_S >= 0) {
    const T t = T(a.beta) * (x1 - T(a.S0));
    bb = have ? bb - t : -t;
  }
  return T(a.g_b) * bb * mc;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, Tile<T>::MIN_BLOCKS) vertical_kernel(const Args a) {
  using Lo = Layout<T>;
  constexpr int TX = Lo::TX, WX = Lo::WX, WN = Lo::WN, PTS = Lo::PTS;
  const T* __restrict__ u = (const T*)a.u;
  const T* __restrict__ v = (const T*)a.v;
  const T* __restrict__ c = (const T*)a.c;
  const T* __restrict__ b = (const T*)a.b;
  const T* __restrict__ g = (const T*)a.g;
  const T* __restrict__ coef = (const T*)a.coef;
  T* __restrict__ dgu = (T*)a.dgu;
  T* __restrict__ dgv = (T*)a.dgv;
  T* __restrict__ dgc = (T*)a.dgc;
  const int nz = a.nz, Yb = a.Yb, Xb = a.Xb, chunk = a.chunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);  // w of the chunk's interfaces over the window
  T* sp = sw + chunk * WN;                 // p of the layer over the window
  int* sn = reinterpret_cast<int*>(sp + WN);  // wet-layer counts over the window
  const int y0 = blockIdx.y * Lo::TY, x0 = blockIdx.x * TX;
  const int64_t P = (int64_t)Yb * Xb;

  // the window points this thread owns: counts, and the buoyancy inputs of layer 0
  int64_t pcol[PTS];
  bool pin[PTS];
  int pn[PTS];
  T bx0[PTS], bx1[PTS], csum[PTS];
#pragma unroll
  for (int it = 0; it < PTS; ++it) {
    const int p = threadIdx.x + it * THREADS;
    const int y = y0 - 1 + p / WX, x = x0 - 1 + p % WX;
    pin[it] = p < WN && y >= 0 && x >= 0 && y < Yb && x < Xb;
    pcol[it] = (int64_t)y * Xb + x;
    pn[it] = pin[it] ? a.n_wet[pcol[it]] : 0;
    if (p < WN) sn[p] = pn[it];
    bx0[it] = bx1[it] = csum[it] = T(0);
    if constexpr (MODE != MODE_NONE) load_b<T, MODE>(c, b, a, 0, P, pcol[it], pin[it], bx0[it], bx1[it]);
  }

  // this thread's column, and whether the kernel keeps it (else its outputs are 0)
  const int ly = threadIdx.x / TX, lx = threadIdx.x % TX;
  const int j = y0 + ly, i = x0 + lx;
  const bool in = j < Yb && i < Xb;
  const bool keep = i >= 1 && j >= 1 && i < Xb - 1 && j < Yb - 1;
  const int64_t c0 = (int64_t)j * Xb + i;
  const int wc = (ly + 1) * WX + lx + 1;  // the column's window point
  if (in && !keep) {
    for (int k = 0; k < nz; ++k) {
      dgu[k * P + c0] = T(0);
      dgv[k * P + c0] = T(0);
    }
    for (int t = 0; t < a.n_tr * nz; ++t) dgc[t * P + c0] = T(0);
  }
  const T idx = keep ? g[IDX * P + c0] : T(0);
  const T idy = keep ? g[IDY * P + c0] : T(0);
  T uk = keep ? u[c0] : T(0), vk = keep ? v[c0] : T(0);
  T ub = keep && nz > 1 ? u[P + c0] : T(0), vb = keep && nz > 1 ? v[P + c0] : T(0);
  T cu_t = T(0), cv_t = T(0), fu_t = T(0), fv_t = T(0);  // top interface of layer k
  T w_t = T(0);                                          // w at the top interface
  int nc = 0, nw = 0, ns = 0;                            // counts: column, west, south

#pragma unroll 1
  for (int k = 0; k < nz; ++k) {
    const bool top = k > 0, bot = k + 1 < nz;
    // the next layer's loads, before this layer's arithmetic
    T un = T(0), vn = T(0);
    if (keep && k + 2 < nz) {
      un = u[(k + 2) * P + c0];
      vn = v[(k + 2) * P + c0];
    }
    T nx0[PTS], nx1[PTS];
    if constexpr (MODE != MODE_NONE) {
#pragma unroll
      for (int it = 0; it < PTS; ++it) {
        nx0[it] = nx1[it] = T(0);
        if (bot) load_b<T, MODE>(c, b, a, k + 1, P, pcol[it], pin[it], nx0[it], nx1[it]);
      }
    }
    if (top) __syncthreads();  // the previous layer's reads of sw and sp are done
    if (bot && k % chunk == 0)  // interface k + 1 opens a chunk
      w_chunk<T>(u, v, g, coef, sw, k + 1, min(k + chunk, nz - 1), nz, Yb, Xb, y0, x0);
    if constexpr (MODE != MODE_NONE) {
      const T dz = coef[DZ * nz + k];
#pragma unroll
      for (int it = 0; it < PTS; ++it) {
        const int p = threadIdx.x + it * THREADS;
        const T bdz = dz * buoyancy<T, MODE>(a, bx0[it], bx1[it], mask<T>(k < pn[it]));
        csum[it] = top ? csum[it] + bdz : bdz;
        if (p < WN) sp[p] = T(0.5) * bdz - csum[it];
        bx0[it] = nx0[it];
        bx1[it] = nx1[it];
      }
    }
    __syncthreads();
    if (k == 0) {
      nc = sn[wc];
      nw = sn[wc - 1];
      ns = sn[wc - WX];
    }

    if (keep) {
      // --- momentum: w-advection, nu_v, hydrostatic pressure gradient
      T cu_b = T(0), cv_b = T(0), fu_b = T(0), fv_b = T(0), w_b = T(0);
      if (bot) {
        const T* swk = sw + (k % chunk) * WN;  // interface k + 1
        const T rdzc = coef[RDZC * nz + k];
        const T du = (uk - ub) * rdzc;
        const T dv = (vk - vb) * rdzc;
        w_b = swk[wc];
        cu_b = T(0.5) * (w_b + swk[wc - 1]) * du;
        cv_b = T(0.5) * (w_b + swk[wc - WX]) * dv;
        if (a.viscous) {
          fu_b = du * (mask<T>(k < nc && k < nw) * mask<T>(k + 1 < nc && k + 1 < nw));
          fv_b = dv * (mask<T>(k < nc && k < ns) * mask<T>(k + 1 < nc && k + 1 < ns));
        }
      }
      T gu = T(0), gv = T(0);
      if (top || bot) {
        const T su = top ? (bot ? cu_t + cu_b : cu_t) : cu_b;
        const T sv = top ? (bot ? cv_t + cv_b : cv_t) : cv_b;
        gu = T(-0.5) * su;
        gv = T(-0.5) * sv;
        if (a.viscous) {
          const T nd = coef[NUDZ * nz + k];
          const T tu = top ? (bot ? fu_t + (-fu_b) : fu_t) : -fu_b;
          const T tv = top ? (bot ? fv_t + (-fv_b) : fv_t) : -fv_b;
          gu = gu + nd * tu;
          gv = gv + nd * tv;
        }
      }
      if constexpr (MODE != MODE_NONE) {
        const T p = sp[wc];
        gu = gu - (p - sp[wc - 1]) * idx;
        gv = gv - (p - sp[wc - WX]) * idy;
      }
      dgu[k * P + c0] = gu;
      dgv[k * P + c0] = gv;

      // --- tracers (c blocks, then b): centered vertical flux divergence, kappa_v
      const T mck = mask<T>(k < nc);
      const T mrdz = coef[MRDZ * nz + k];
      const T kapdz = coef[KAPDZ * nz + k];
      const T rdzc_t = top ? coef[RDZC * nz + k - 1] : T(0);
      const T rdzc_b = bot ? coef[RDZC * nz + k] : T(0);
#pragma unroll 1
      for (int t = 0; t < a.n_tr; ++t) {
        const T* ct = t < a.n_c ? c + (int64_t)t * nz * P : b;
        const T ck = ct[k * P + c0];
        const T cm = top ? ct[(k - 1) * P + c0] : T(0);
        const T cb = bot ? ct[(k + 1) * P + c0] : T(0);
        T f_t = T(0), d_t = T(0), f_b = T(0), d_b = T(0);
        if (top) {
          f_t = w_t * (T(0.5) * (cm + ck));
          if (a.diffusive) d_t = (cm - ck) * rdzc_t * (mask<T>(k - 1 < nc) * mck);
        }
        if (bot) {
          f_b = w_b * (T(0.5) * (ck + cb));
          if (a.diffusive) d_b = (ck - cb) * rdzc_b * (mck * mask<T>(k + 1 < nc));
        }
        T G = T(0);
        if (top || bot) {
          const T s = top ? (bot ? f_t + (-f_b) : f_t) : -f_b;
          G = mrdz * s;
          if (a.diffusive) {
            const T s2 = top ? (bot ? d_t + (-d_b) : d_t) : -d_b;
            G = G + kapdz * s2;
          }
        }
        dgc[((int64_t)t * nz + k) * P + c0] = G * mck;
      }
      cu_t = cu_b;
      cv_t = cv_b;
      fu_t = fu_b;
      fv_t = fv_b;
      w_t = w_b;
      uk = ub;
      vk = vb;
      ub = un;
      vb = vn;
    }
  }
}

template <typename T, int MODE>
int launch_mode(const Args& a, cudaStream_t s) {
  using Lo = Layout<T>;
  const int bytes = Lo::bytes(a.chunk);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vertical_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.Xb + Lo::TX - 1) / Lo::TX, (a.Yb + Lo::TY - 1) / Lo::TY);
  vertical_kernel<T, MODE><<<grid, THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int mode, int ty, int tx, void* stream) {
  // a plan made for another tile or chunk, or a grid the launch cannot take, is refused
  const int chunk = a.nz > 1 ? (a.nz - 1 < Tile<T>::CHUNK ? a.nz - 1 : Tile<T>::CHUNK) : 1;
  if (ty != Tile<T>::Y || tx != Tile<T>::X || a.chunk != chunk || a.nz < 1 ||
      a.n_tr < a.n_c || (a.Yb + Tile<T>::Y - 1) / Tile<T>::Y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_TRACER_B) return launch_mode<T, MODE_TRACER_B>(a, s);
  if (mode == MODE_LINEAR_EOS) return launch_mode<T, MODE_LINEAR_EOS>(a, s);
  return launch_mode<T, MODE_NONE>(a, s);
}

}  // namespace

#define OSG_VERTICAL_ENTRY(SUFFIX, TYPE)                                                 \
  extern "C" int osg_vertical_##SUFFIX(                                                  \
      const void* u, const void* v, const void* c, const void* b, const void* n_wet,     \
      const void* g, const void* coef, void* dgu, void* dgv, void* dgc, int nz, int n_c, \
      int n_tr, int Yb, int Xb, int mode, int it_T, int it_S, int viscous,               \
      int diffusive, int ty, int tx, int chunk, double g_b, double alpha, double beta,   \
      double T0, double S0, void* stream) {                                              \
    const Args a{u,  v,    c,    b,       (const int*)n_wet, g,     coef,  dgu, dgv,     \
                 dgc, nz,  n_c,  n_tr,    Yb,                Xb,    it_T,  it_S,         \
                 viscous, diffusive, chunk, g_b, alpha, beta, T0, S0};                   \
    return launch<TYPE>(a, mode, ty, tx, stream);                                        \
  }

OSG_VERTICAL_ENTRY(f32, float)
OSG_VERTICAL_ENTRY(f64, double)
