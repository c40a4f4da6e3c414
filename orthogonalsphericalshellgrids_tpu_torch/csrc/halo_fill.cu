// Tripolar halo fill of a (K, Yb, Xb) stack, one launch per field, in two modes:
//   in place (osg_halo_fill):       writes only the halo cells of A;
//   out of place (osg_halo_fill_copy): writes every cell of a fresh buffer B, the
//                                    interior copied from A and the halos filled,
//                                    and never writes A.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:fill_halos_pallas
// (its _row_pass/_row_kernel and _col_pass/_col_kernel) and, with the out-of-place
// mode, :restore_strips_pallas. The TPU step fills a donated buffer in place and
// writes the saved pre-fill strips back afterwards to recover the unfilled field;
// here the fill reads the unfilled field and writes the filled one elsewhere, so
// the unfilled field is never lost and needs no restore. Both modes are bitwise
// equal to the port's plain version, ops/zipper.py:fill_halos: every written value
// is a copy of one interior cell times +1 or -1.
//
// What bounds it on the H100: bytes, and launch latency. In place, only halo cells
// are visited. On the main path the extended free-surface plane (724, 1484) f32 has
// (22 + 23) * 1484 strip cells + 679 * 44 column cells, about 97 k cells: 0.8 MB
// read plus written per fill, 0.2 us of HBM time at 3.35 TB/s. The base plane
// (690, 1450) has about 23 k cells. Out of place, the whole plane is read once and
// written once: 8.6 MB for the extended plane (2.6 us at 3.35 TB/s) and 8.0 MB for
// the base plane, the same bytes as the clone it replaces, in one launch instead of
// two.
//
// Design: filled_value() is the closed-form index map of zipper.py:fold_strip, the
// south rows and the x-wrap. It reads only interior cells of the unfilled plane
// (rows Hy..Hy+Ny-1, columns Hx..Hx+Nx-1), and from the kept half of row Ny where
// the center-y fold overwrites its redundant half.
//   * Out of place: one thread per cell of the plane writes filled_value() into B.
//   * In place: one thread per halo cell. The linear thread index is split into
//     three regions: the Hy south rows, the fold strip (row Ny for center-y fields
//     and the Hy north rows, full width, its own wrap columns included), and the
//     west/east columns of the rows in between. No thread reads a cell that
//     another thread writes:
//       - the south rows read row Hy, and the fold reads rows >= Ny - 1, so the
//         wrapper requires Ny > Hy + 1 (row Hy lies outside the fold window);
//       - the redundant-half overwrite of row Ny (center-y, i0 >= Nx/2) reads
//         i0' < Nx/2 except i0 = Nx/2 of a face-x field, which mirrors onto itself
//         and is read only by its own thread as long as the wrap columns do not
//         reach it: the wrapper requires 2*Hx < Nx;
//       - the wrap columns of row Ny are computed from the same formula as the cell
//         they copy, never read from it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geom {
  int Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y;
  __host__ __device__ int y0() const { return face_y ? Hy + Ny : Hy + Ny - 1; }
};

// Value of cell (y, x) of the filled plane, read from the unfilled plane a.
template <typename T>
__device__ __forceinline__ T filled_value(const T* a, int y, int x, const Geom& g,
                                          T sign) {
  // interior column this cell copies (periodic in x)
  const int i0 = (x < g.Hx ? x + g.Nx : (x >= g.Hx + g.Nx ? x - g.Nx : x)) - g.Hx;
  const int y0 = g.y0();
  if (y < g.Hy) return a[(int64_t)g.Hy * g.Xb + g.Hx + i0];  // zero-gradient south
  if (y < y0) return a[(int64_t)y * g.Xb + g.Hx + i0];        // interior or x-wrap
  // fold strip
  const int mir = g.face_x ? (g.Nx - i0) % g.Nx : g.Nx - 1 - i0;
  const T s = (g.face_x && i0 == 0) ? (sign < T(0) ? -sign : sign) : sign;
  const int r = y - y0;
  if (!g.face_y && r == 0) {  // row Ny of a center-y field: kept half, mirrored half
    if (i0 < g.Nx / 2) return a[(int64_t)y0 * g.Xb + g.Hx + i0];
    return s * a[(int64_t)y0 * g.Xb + g.Hx + mir];
  }
  // halo row Ny+j <- row Ny-j (center-y) or Ny-j+1 (face-y), mirrored
  const int src_row = g.face_y ? y0 - 1 - r : y0 - r;
  return s * a[(int64_t)src_row * g.Xb + g.Hx + mir];
}

template <typename T>
__global__ void halo_fill_kernel(T* A, Geom g, T sign) {
  T* a = A + (int64_t)blockIdx.y * g.Yb * g.Xb;
  const int y0 = g.y0();
  const int64_t n_south = (int64_t)g.Hy * g.Xb;
  const int64_t n_fold = (int64_t)(g.Yb - y0) * g.Xb;
  const int64_t n_mid = (int64_t)(y0 - g.Hy) * 2 * g.Hx;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_south + n_fold + n_mid) return;
  int y, x;
  if (t < n_south) {
    y = (int)(t / g.Xb);
    x = (int)(t % g.Xb);
  } else if (t < n_south + n_fold) {
    y = y0 + (int)((t - n_south) / g.Xb);
    x = (int)((t - n_south) % g.Xb);
    // interior cells of the kept half of row Ny (center-y) stay as they are
    if (!g.face_y && y == y0 && x >= g.Hx && x < g.Hx + g.Nx / 2) return;
  } else {  // west/east columns of the middle rows; east ones start at Hx + Nx
    const int64_t m = t - n_south - n_fold;
    const int c = (int)(m % (2 * g.Hx));
    y = g.Hy + (int)(m / (2 * g.Hx));
    x = c < g.Hx ? c : g.Nx + c;
  }
  a[(int64_t)y * g.Xb + x] = filled_value(a, y, x, g, sign);
}

template <typename T>
__global__ void halo_fill_copy_kernel(const T* __restrict__ A, T* __restrict__ B,
                                      Geom g, T sign) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= g.Xb || y >= g.Yb) return;
  const int64_t plane = (int64_t)blockIdx.z * g.Yb * g.Xb;
  B[plane + (int64_t)y * g.Xb + x] = filled_value(A + plane, y, x, g, sign);
}

template <typename T>
int launch(void* A, int K, int Yb, int Xb, int Nx, int Ny, int Hx, int Hy,
           int face_x, int face_y, int sign, void* stream) {
  const Geom g{Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y};
  const int64_t n = (int64_t)Hy * Xb + (int64_t)(Yb - g.y0()) * Xb +
                    (int64_t)(g.y0() - Hy) * 2 * Hx;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)K);
  halo_fill_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>((T*)A, g, T(sign));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_copy(const void* A, void* B, int K, int Yb, int Xb, int Nx, int Ny, int Hx,
                int Hy, int face_x, int face_y, int sign, void* stream) {
  const Geom g{Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y};
  const dim3 block(128, 4);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y, K);
  halo_fill_copy_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)A, (T*)B, g, T(sign));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osg_halo_fill_f32(void* A, int K, int Yb, int Xb, int Nx, int Ny,
                                 int Hx, int Hy, int face_x, int face_y, int sign,
                                 void* stream) {
  return launch<float>(A, K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, sign, stream);
}

extern "C" int osg_halo_fill_f64(void* A, int K, int Yb, int Xb, int Nx, int Ny,
                                 int Hx, int Hy, int face_x, int face_y, int sign,
                                 void* stream) {
  return launch<double>(A, K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, sign, stream);
}

extern "C" int osg_halo_fill_copy_f32(const void* A, void* B, int K, int Yb, int Xb,
                                      int Nx, int Ny, int Hx, int Hy, int face_x,
                                      int face_y, int sign, void* stream) {
  return launch_copy<float>(A, B, K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, sign,
                            stream);
}

extern "C" int osg_halo_fill_copy_f64(const void* A, void* B, int K, int Yb, int Xb,
                                      int Nx, int Ny, int Hx, int Hy, int face_x,
                                      int face_y, int sign, void* stream) {
  return launch_copy<double>(A, B, K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, sign,
                             stream);
}
