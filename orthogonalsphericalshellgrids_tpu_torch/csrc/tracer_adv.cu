// Flux-form upwind WENO-5 tracer advection tendency, in column and layered mode, with
// the fused kappa_h Laplacian and an additive stack.
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
//   planes per layer, [IV (, K_u, K_v, K_c)], IV = mask_c / (Az_cc dz_k), and
//     G = -(dxc(u dz_k dy_fc cx) + dyc(v dz_k dx_cf cy)) IV
//   with K planes (kappa_h, pallas_adv.py:239-243), in both modes:
//     G += (dxc((dxf c) K_u) + dyc((dyf c) K_v)) K_c
//   and, where the additive stack acc is given (pallas_adv.py:244-246), G += acc.
// The flux factors are applied in the plain version's order, ((u h) len) cx with
// h = h_u or dz_k, not through a prefactored A_u, so the kernel differs from the
// port's plain version (kernels/tracer_adv.py) only where nvcc contracts into an FMA.
//
// What bounds it on the H100: the WENO-5 arithmetic, then bytes. The function needs
// each face once: two reconstructions a cell and plane (an x face and a y face), each
// with 7 IEEE divisions, 0.12 ms for 10 planes of 690 x 1450 at the measured WENO-5
// rate. Column mode reads c, u, v and 5 static planes and writes G: 9 planes of 4 MB,
// 36 MB, 11 us at 3.35 TB/s. Layered mode at the baroclinic front's 1/4-degree x 10
// (one tracer stack) reads c, u, v, IV (40 planes) and the 2 shared metric planes
// and writes G (10 planes): 0.2 GB, 60 us; kappa_h adds 3 planes a layer and acc one
// a tracer plane.
//
// Design: tiles in shared memory, each face reconstructed once, every operand
// copied ahead. A CTA of 256 threads owns a TY x TX tile of output cells (Tile<T>;
// kernels/tracer_adv.py:launch_plan holds the same numbers and the entry refuses a
// plan made for others).
//   - The loads are asynchronous copies (cp.async) into shared memory, zero outside
//     the array: per tracer plane c over the tile and the stencil's reach of 3 (the
//     window) and acc at the cells; per layer u and v at the tile's faces, IV and
//     the kappa_h planes; once a CTA the metric planes [dy_fc, dx_cf] at the faces
//     (column mode: the pack's planes). In layered mode the CTA loops over the
//     layers and, per layer, over the tracer blocks of the stack (T and S in the
//     gyre), and the next plane's (and layer's) copies are issued into a second
//     buffer before the present plane's arithmetic, so they arrive while it runs.
//     No operand waits in a register, which keeps the kernel within 64 registers a
//     thread at f32 and the SM at 4 CTAs of 8 warps.
//   - Per plane every x face of the tile (TY rows of TX + 1) and every y face (TY + 1
//     rows of TX) is reconstructed once, with the stencil's operands selected on the
//     upwind side, into shared memory; then each cell's divergence from the stored
//     fluxes, kappa_h from the window, and acc last.
//   - Divisions go through weno5.cuh:div_nz: on exact zeros (the front's all-zero
//     tracer, land in the gyre) IEEE division takes its slow path, 2.9x the time of
//     random data at f32 in benchmarks/torch_div_probe.py (PERF.md); the guard gives
//     the same bits for every input.
//   - Cells within REACH of the edge (the stencil's reach) are written 0; window
//     cells and faces outside the array are 0 and never feed a kept cell. kappa_h and
//     acc are template switches, so each mode compiles only its own statements (a
//     runtime null test on acc once slowed the kappa_h mode without it by 12-15 %).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "weno5.cuh"

namespace {

enum { H_U, DY_FC, H_V, DX_CF, INV_VOL, K_U, K_V, K_C };  // the column pack
constexpr int REACH = 3;
constexpr int THREADS = 256;

// the output tile of a CTA, (rows, columns), and the CTAs an SM must hold at once (a
// register budget), per dtype
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int Y = 16, X = 32, MIN_BLOCKS = 4; };
template <> struct Tile<double> { static constexpr int Y = 16, X = 32, MIN_BLOCKS = 2; };

// Shared memory of one CTA, as offsets in elements of T. Faces are numbered x faces
// first (TY rows of TX + 1: face lx lies west of cell lx), then y faces (TY + 1 rows
// of TX: face ly lies south of cell row ly); cells by row (TY rows of TX). NB buffers
// of what a plane or a layer copies: two in layered mode (the next one in flight).
template <typename T, bool LAYERED, bool HAS_DIFF, bool HAS_ACC>
struct Layout {
  static constexpr int TY = Tile<T>::Y, TX = Tile<T>::X;
  static constexpr int WY = TY + 2 * REACH, WX = TX + 2 * REACH, WN = WY * WX;
  static constexpr int NXF = TY * (TX + 1), NF = NXF + (TY + 1) * TX;
  static constexpr int CN = TY * TX, CELLS = CN / THREADS;
  static constexpr int NB = LAYERED ? 2 : 1;
  static constexpr int WIN = 0;                              // c over the window
  static constexpr int FLUX = WIN + NB * WN;                 // the face fluxes
  static constexpr int VEL = FLUX + NF;                      // u at x faces, v at y faces
  static constexpr int LEN = VEL + NB * NF;                  // dy_fc, dx_cf at the faces
  static constexpr int HF = LEN + NF;                        // column: h_u, h_v at the faces
  static constexpr int KF = HF + (LAYERED ? 0 : NF);         // K_u, K_v at the faces
  static constexpr int IV = KF + (HAS_DIFF ? NB * NF : 0);   // IV at the cells
  static constexpr int KC = IV + NB * CN;                    // K_c at the cells
  static constexpr int ACC = KC + (HAS_DIFF ? NB * CN : 0);  // acc at the cells
  static constexpr int BYTES = (ACC + (HAS_ACC ? NB * CN : 0)) * static_cast<int>(sizeof(T));
  static_assert(CN % THREADS == 0, "a thread owns whole cells");
};

// src[off] into *dst as an asynchronous copy, or 0 where off < 0 (outside the array)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int off) {
  __pipeline_memcpy_async(dst, src + (off < 0 ? 0 : off), sizeof(T), off < 0 ? sizeof(T) : 0);
}

// the faces of the tile from planes sx (x faces) and sy (y faces)
template <class Lo, typename T>
__device__ __forceinline__ void copy_faces(T* dst, const T* sx, const T* sy, int y0, int x0,
                                           int Yb, int Xb) {
#pragma unroll
  for (int it = 0; it < (Lo::NF + THREADS - 1) / THREADS; ++it) {
    const int p = threadIdx.x + it * THREADS;
    if (p >= Lo::NF) break;
    int y, x;
    if (p < Lo::NXF) {
      y = p / (Lo::TX + 1);
      x = p - y * (Lo::TX + 1);
    } else {
      y = (p - Lo::NXF) / Lo::TX;
      x = p - Lo::NXF - y * Lo::TX;
    }
    y += y0;
    x += x0;
    copy_async(dst + p, p < Lo::NXF ? sx : sy, y < Yb && x < Xb ? y * Xb + x : -1);
  }
}

// c over the window (rows y0 - REACH.., columns x0 - REACH..)
template <class Lo, typename T>
__device__ __forceinline__ void copy_window(T* dst, const T* src, int y0, int x0, int Yb,
                                            int Xb) {
#pragma unroll
  for (int it = 0; it < (Lo::WN + THREADS - 1) / THREADS; ++it) {
    const int p = threadIdx.x + it * THREADS;
    if (p >= Lo::WN) break;
    const int y = y0 - REACH + p / Lo::WX, x = x0 - REACH + p % Lo::WX;
    copy_async(dst + p, src, y >= 0 && x >= 0 && y < Yb && x < Xb ? y * Xb + x : -1);
  }
}

// this thread's own cells of the tile (each thread reads back only what it copied)
template <class Lo, typename T>
__device__ __forceinline__ void copy_cells(T* dst, const T* src, int y0, int x0, int Yb,
                                           int Xb) {
#pragma unroll
  for (int q = 0; q < Lo::CELLS; ++q) {
    const int p = threadIdx.x + q * THREADS;
    const int y = y0 + p / Lo::TX, x = x0 + p % Lo::TX;
    copy_async(dst + p, src, y < Yb && x < Xb ? y * Xb + x : -1);
  }
}

// The kernel of both modes. Column: st is the (5 or 8)-plane pack, n_planes = nz = 1.
// Layered: c holds n_planes = n_tr nz tracer-major planes over nz layers of u and v,
// st the (nz S) layer-major pack [IV (, K_u, K_v, K_c)], g = [dy_fc, dx_cf], dz (nz).
template <typename T, bool LAYERED, bool HAS_DIFF, bool HAS_ACC>
__global__ void __launch_bounds__(THREADS, Tile<T>::MIN_BLOCKS)
    tracer_adv_kernel(const T* __restrict__ c, const T* __restrict__ u,
                      const T* __restrict__ v, const T* __restrict__ st,
                      const T* __restrict__ g, const T* __restrict__ dz,
                      const T* __restrict__ acc, T* __restrict__ G, int n_planes, int nz,
                      int Yb, int Xb) {
  using Lo = Layout<T, LAYERED, HAS_DIFF, HAS_ACC>;
  constexpr int TX = Lo::TX, WX = Lo::WX, WN = Lo::WN, NXF = Lo::NXF, NF = Lo::NF;
  constexpr int CN = Lo::CN, S = HAS_DIFF ? 4 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int y0 = blockIdx.y * Lo::TY, x0 = blockIdx.x * TX;
  const int64_t P = (int64_t)Yb * Xb;
  const int n_blocks = LAYERED ? n_planes / nz : 1;
  const int n_steps = LAYERED ? n_planes : 1;  // layer by layer, each layer's blocks in turn

  // what a layer copies (IV, the kappa_h planes, u and v) into its buffer b, and what a
  // plane copies (its window and acc) into buffer b
  auto copy_layer = [&](int layer, int b) {
    const T* lp = LAYERED ? st + (int64_t)layer * S * P : st + INV_VOL * P;
    copy_cells<Lo>(sm + Lo::IV + b * CN, lp, y0, x0, Yb, Xb);
    if constexpr (HAS_DIFF) {
      copy_faces<Lo>(sm + Lo::KF + b * NF, lp + P, lp + 2 * P, y0, x0, Yb, Xb);
      copy_cells<Lo>(sm + Lo::KC + b * CN, lp + 3 * P, y0, x0, Yb, Xb);
    }
    copy_faces<Lo>(sm + Lo::VEL + b * NF, u + layer * P, v + layer * P, y0, x0, Yb, Xb);
  };
  auto copy_plane = [&](int64_t off, int b) {
    copy_window<Lo>(sm + Lo::WIN + b * WN, c + off, y0, x0, Yb, Xb);
    if constexpr (HAS_ACC) copy_cells<Lo>(sm + Lo::ACC + b * CN, acc + off, y0, x0, Yb, Xb);
  };

  if constexpr (LAYERED) {
    copy_faces<Lo>(sm + Lo::LEN, g, g + P, y0, x0, Yb, Xb);
  } else {
    copy_faces<Lo>(sm + Lo::LEN, st + DY_FC * P, st + DX_CF * P, y0, x0, Yb, Xb);
    copy_faces<Lo>(sm + Lo::HF, st + H_U * P, st + H_V * P, y0, x0, Yb, Xb);
  }
  copy_layer(0, 0);
  copy_plane(0, 0);
  __pipeline_commit();

#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    const int layer = s / n_blocks, t = s - layer * n_blocks;
    const int bs = LAYERED ? s & 1 : 0, bl = LAYERED ? layer & 1 : 0;
    const int64_t off = ((int64_t)t * nz + layer) * P;  // this tracer plane
    __syncthreads();  // every thread is done with the previous plane's buffers
    if (s + 1 < n_steps) {  // the next plane's copies, and its layer's at a layer's start
      const int l1 = (s + 1) / n_blocks, t1 = s + 1 - l1 * n_blocks;
      if (t1 == 0) copy_layer(l1, l1 & 1);
      copy_plane(((int64_t)t1 * nz + l1) * P, (s + 1) & 1);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this plane's copies have landed
    __syncthreads();

    // each face once: x face (ly, lx) from window row ly + 3, columns lx..lx + 5; y
    // face (ly, lx) from window rows ly..ly + 5, column lx + 3
    const T* sc = sm + Lo::WIN + bs * WN;
    const T* vel = sm + Lo::VEL + bl * NF;
    const T dzk = LAYERED ? dz[layer] : T(0);
#pragma unroll 1
    for (int p = threadIdx.x; p < NF; p += THREADS) {
      const T* w;
      int d;
      if (p < NXF) {
        const int ly = p / (TX + 1);
        w = sc + (ly + REACH) * WX + p - ly * (TX + 1);
        d = 1;
      } else {
        const int ly = (p - NXF) / TX;
        w = sc + ly * WX + (p - NXF - ly * TX) + REACH;
        d = WX;
      }
      const T ve = vel[p];
      T h;
      if constexpr (LAYERED)
        h = dzk;
      else
        h = sm[Lo::HF + p];
      const T cf = weno5_upwind_selected<true>(ve > T(0), w[0], w[d], w[2 * d], w[3 * d],
                                               w[4 * d], w[5 * d]);
      sm[Lo::FLUX + p] = ve * h * sm[Lo::LEN + p] * cf;
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < Lo::CELLS; ++q) {
      const int p = threadIdx.x + q * THREADS;
      const int ly = p / TX, lx = p - ly * TX;
      const int j = y0 + ly, i = x0 + lx;
      if (j >= Yb || i >= Xb) continue;
      T out = T(0);
      if (i >= REACH && j >= REACH && i < Xb - REACH && j < Yb - REACH) {
        const T* fx = sm + Lo::FLUX + ly * (TX + 1) + lx;
        const T* fy = sm + Lo::FLUX + NXF + ly * TX + lx;
        const T gx = fx[1] - fx[0];
        const T gy = fy[TX] - fy[0];
        out = -(gx + gy) * sm[Lo::IV + bl * CN + p];
        if constexpr (HAS_DIFF) {
          const T* w = sc + (ly + REACH) * WX + lx + REACH;
          const T* kx = sm + Lo::KF + bl * NF + ly * (TX + 1) + lx;
          const T* ky = sm + Lo::KF + bl * NF + NXF + ly * TX + lx;
          const T cc = w[0];
          const T gx0 = (cc - w[-1]) * kx[0];
          const T gx1 = (w[1] - cc) * kx[1];
          const T gy0 = (cc - w[-WX]) * ky[0];
          const T gy1 = (w[WX] - cc) * ky[TX];
          out = out + ((gx1 - gx0) + (gy1 - gy0)) * sm[Lo::KC + bl * CN + p];
        }
        if constexpr (HAS_ACC) out = out + sm[Lo::ACC + bs * CN + p];
      }
      G[off + (int64_t)j * Xb + i] = out;
    }
  }
}

struct Args {
  const void *c, *u, *v, *st, *g, *dz, *acc;
  void* G;
  int n_planes, nz, Yb, Xb;
};

template <typename T, bool LAYERED, bool HAS_DIFF, bool HAS_ACC>
int launch_one(const Args& a, cudaStream_t s) {
  using Lo = Layout<T, LAYERED, HAS_DIFF, HAS_ACC>;
  if constexpr (Lo::BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tracer_adv_kernel<T, LAYERED, HAS_DIFF, HAS_ACC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Lo::BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.Xb + Lo::TX - 1) / Lo::TX, (a.Yb + Lo::TY - 1) / Lo::TY);
  tracer_adv_kernel<T, LAYERED, HAS_DIFF, HAS_ACC><<<grid, THREADS, Lo::BYTES, s>>>(
      (const T*)a.c, (const T*)a.u, (const T*)a.v, (const T*)a.st, (const T*)a.g,
      (const T*)a.dz, (const T*)a.acc, (T*)a.G, a.n_planes, a.nz, a.Yb, a.Xb);
  return (int)cudaGetLastError();
}

template <typename T, bool LAYERED>
int launch(const Args& a, int has_diff, int ty, int tx, void* stream) {
  // a plan made for another tile, a plane whose offsets overflow an int, or a grid
  // the launch cannot take, is refused
  if (ty != Tile<T>::Y || tx != Tile<T>::X || a.nz < 1 || a.n_planes < a.nz ||
      a.n_planes % a.nz || (int64_t)a.Yb * a.Xb > 2147483647LL ||
      (a.Yb + Tile<T>::Y - 1) / Tile<T>::Y > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_diff && a.acc) return launch_one<T, LAYERED, true, true>(a, s);
  if (has_diff) return launch_one<T, LAYERED, true, false>(a, s);
  if (a.acc) return launch_one<T, LAYERED, false, true>(a, s);
  return launch_one<T, LAYERED, false, false>(a, s);
}

}  // namespace

extern "C" int osg_tracer_adv_f32(const void* c, const void* u, const void* v,
                                  const void* st, const void* acc, void* G, int Yb, int Xb,
                                  int has_diff, int ty, int tx, void* stream) {
  return launch<float, false>({c, u, v, st, nullptr, nullptr, acc, G, 1, 1, Yb, Xb},
                              has_diff, ty, tx, stream);
}

extern "C" int osg_tracer_adv_f64(const void* c, const void* u, const void* v,
                                  const void* st, const void* acc, void* G, int Yb, int Xb,
                                  int has_diff, int ty, int tx, void* stream) {
  return launch<double, false>({c, u, v, st, nullptr, nullptr, acc, G, 1, 1, Yb, Xb},
                               has_diff, ty, tx, stream);
}

extern "C" int osg_tracer_adv_layered_f32(const void* c, const void* u, const void* v,
                                          const void* iv, const void* g, const void* dz,
                                          const void* acc, void* G, int n_planes, int nz,
                                          int Yb, int Xb, int has_diff, int ty, int tx,
                                          void* stream) {
  return launch<float, true>({c, u, v, iv, g, dz, acc, G, n_planes, nz, Yb, Xb}, has_diff,
                             ty, tx, stream);
}

extern "C" int osg_tracer_adv_layered_f64(const void* c, const void* u, const void* v,
                                          const void* iv, const void* g, const void* dz,
                                          const void* acc, void* G, int n_planes, int nz,
                                          int Yb, int Xb, int has_diff, int ty, int tx,
                                          void* stream) {
  return launch<double, true>({c, u, v, iv, g, dz, acc, G, n_planes, nz, Yb, Xb}, has_diff,
                              ty, tx, stream);
}
