// Tripolar halo fill of halo-inclusive (K, Yb, Xb) stacks, in four entries:
//   group fill (osg_halo_fill_group):      fills the halos of up to 8 fields in
//                                          place in one launch, and with `save`
//                                          first copies the pre-fill value of every
//                                          cell it writes into a packed strip buffer;
//   group restore (osg_halo_restore_group): writes that buffer back into exactly
//                                          the cells the fill wrote, one launch;
//   group pack (osg_halo_pack_group):      copies the top and the bottom Hy interior
//                                          rows of every field of a group into one
//                                          send buffer, one launch (y-sharded runs);
//   out of place (osg_halo_fill_copy):     writes every cell of a fresh buffer B,
//                                          the interior copied from A and the halos
//                                          filled, and never writes A.
//
// Shard roles. A field of a y-partitioned run holds one rank's rows, and its fill
// follows the rank's role (the table's kRole column): `single` (the whole grid, the
// serial fill), `bottom` (rank 0 of several: zero-gradient south rows, the north
// rows received), `middle` (both received) or `top` (the last rank: south rows
// received, the zipper fold). Received rows are read from the receive buffers
// (`south`, `north`: each field's K planes of Hy full-width rows at its kXoff, the
// layout of the send buffer) at their interior columns only, so the x-halo of every
// written row is derived from interior columns, never taken from the neighbour's
// halo (orthogonalsphericalshellgrids_tpu/ops/spmd.py:fill_halos_spmd_groups: south
// rows, north rows or the fold, then the x-wrap). A role without the fold writes the
// Hy north rows in full and only the halo columns of row Ny, so its cells are laid
// out as a face-y field's are. The fold of the top rank reads the rows below row Ny;
// when the rank holds only Ny = Hy rows the lowest of them is a received south row,
// read from `south`.
//
// Replaces: orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:fill_halos_pallas
// (its _row_pass/_row_kernel and _col_pass/_col_kernel, with save=True) and
// :restore_strips_pallas. The step fills the state's own buffers, lets the
// tendencies read them, and restores the saved strips afterwards, so the unfilled
// state comes back bitwise at strip cost. Every written value is a copy of one
// interior cell times +1 or -1, so both the fill and the restore are bitwise equal
// to the port's plain versions (kernels/halo_fill.py, ops/zipper.py:fill_halos).
//
// What bounds it on the H100: bytes, and launch latency. Only written cells are
// visited. A (690, 1450) base plane at halo 5 has about 22 k of them (2.2 %), the
// (724, 1484) extended plane at halo 22 about 96 k (8.9 %). A layered step's group
// (40 base planes, 3 extended) writes about 1.2 M cells: the fill with its save
// reads the sources and the old values and writes the saved copy and the filled
// values, about 17 MB at f32; the restore moves about 9 MB. One launch a group, so
// a step makes three fill launches (state, GU and GV, restore) where it made 8-9.
//
// Design: filled_value() is the closed-form index map of zipper.py:fold_strip, the
// south rows and the x-wrap. It reads only interior cells of the unfilled plane
// (rows Hy..Hy+Ny-1, columns Hx..Hx+Nx-1), and from the kept half of row Ny where
// the center-y fold overwrites its redundant half. One thread per written cell; the
// cells of a plane are numbered in the packed order of cell_of(): the Hy south
// rows, the fold strip (row Ny for center-y fields and the Hy north rows, full
// width, its own wrap columns included) without the kept half of row Ny, then the
// west/east columns of the rows in between. A field's planes follow each other, and
// the fields of a group follow each other, in blocks (the fill and the restore) and
// in the strip buffer alike; the host plan (kernels/halo_fill.py:group_plan) gives
// each field's first block and first strip offset, and the entries below refuse a
// table that disagrees with the geometry. No thread reads a cell that another thread
// writes, so the order of the threads does not matter and the save needs no barrier:
//   - the south rows read row Hy, and the fold reads rows >= Ny - 1, so the wrapper
//     requires Ny > Hy + 1 (row Hy lies outside the fold window) of a single field;
//     a shard's received rows come from the receive buffers, which no thread writes,
//     so a shard needs only Ny >= Hy (its send rows are interior rows);
//   - the redundant-half overwrite of row Ny (center-y, i0 >= Nx/2) reads
//     i0' < Nx/2 except i0 = Nx/2 of a face-x field, which mirrors onto itself and
//     is read only by its own thread (after its save) as long as the wrap columns do
//     not reach it: the wrapper requires 2*Hx < Nx;
//   - the wrap columns of row Ny are computed from the same formula as the cell they
//     copy, never read from it;
//   - fields are separate: the wrapper refuses a group whose byte ranges overlap.
// The field table rides in the kernel's parameters (__grid_constant__, under 600
// bytes), so a launch needs no copy to the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 8;
constexpr int kThreads = 256;
// columns of a field's row in the host table
enum Col { kPtr, kK, kYb, kXb, kNx, kNy, kHx, kHy, kFaceX, kFaceY, kSign, kCells,
           kBlock0, kStrip, kRole, kXoff, kCols };
// the shard roles of the kRole column
enum Role { kSingle, kBottom, kMiddle, kTop };

struct Geom {
  int Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, role;
  __host__ __device__ bool fold() const { return role == kSingle || role == kTop; }
  __host__ __device__ bool recv_south() const { return role == kMiddle || role == kTop; }
  __host__ __device__ bool recv_north() const {
    return role == kBottom || role == kMiddle;
  }
  // the first row of the north strip: row Ny of a center-y fold, else row Ny + 1
  __host__ __device__ int y0() const { return face_y || !fold() ? Hy + Ny : Hy + Ny - 1; }
  // cells of row Ny a center-y fold keeps as they are
  __host__ __device__ int kept() const { return face_y || !fold() ? 0 : Nx / 2; }
  __host__ __device__ int64_t cells() const {
    return (int64_t)Hy * Xb + (int64_t)(Yb - y0()) * Xb - kept() +
           (int64_t)(y0() - Hy) * 2 * Hx;
  }
};

struct Field {
  void* a;
  int64_t strip;  // offset of the field's first saved cell
  int64_t xoff;   // offset of the field's rows in the send and receive buffers
  int64_t cells;  // written cells a plane
  int block0;     // the field's first block
  int K;
  int sign;
  Geom g;
};

struct Group {
  Field f[kMaxFields];
  int n;
};

// (y, x) of written cell m of a plane, in the packed order
__host__ __device__ __forceinline__ void cell_of(int64_t m, const Geom& g, int& y,
                                                 int& x) {
  const int y0 = g.y0();
  const int64_t n_south = (int64_t)g.Hy * g.Xb;
  if (m < n_south) {
    y = (int)(m / g.Xb);
    x = (int)(m % g.Xb);
    return;
  }
  m -= n_south;
  const int kept = g.kept();
  const int64_t n_fold = (int64_t)(g.Yb - y0) * g.Xb - kept;
  if (m < n_fold) {
    const int first = g.Xb - kept;  // written cells of row y0
    if (m < first) {
      y = y0;
      x = m < g.Hx ? (int)m : (int)m + kept;
    } else {
      m -= first;
      y = y0 + 1 + (int)(m / g.Xb);
      x = (int)(m % g.Xb);
    }
    return;
  }
  m -= n_fold;  // west/east columns of the middle rows; east ones start at Hx + Nx
  const int c = (int)(m % (2 * g.Hx));
  y = g.Hy + (int)(m / (2 * g.Hx));
  x = c < g.Hx ? c : g.Nx + c;
}

// Value of cell (y, x) of the filled plane, read from the unfilled plane a and, for
// the received rows, from the plane's rows in the receive buffers.
template <typename T>
__device__ __forceinline__ T filled_value(const T* a, const T* south, const T* north,
                                          int y, int x, const Geom& g, T sign) {
  // interior column this cell copies (periodic in x)
  const int i0 = (x < g.Hx ? x + g.Nx : (x >= g.Hx + g.Nx ? x - g.Nx : x)) - g.Hx;
  const int y0 = g.y0();
  if (y < g.Hy) {
    if (g.recv_south()) return south[(int64_t)y * g.Xb + g.Hx + i0];  // received
    return a[(int64_t)g.Hy * g.Xb + g.Hx + i0];  // zero-gradient south
  }
  if (y < y0) return a[(int64_t)y * g.Xb + g.Hx + i0];  // interior or x-wrap
  if (g.recv_north()) return north[(int64_t)(y - y0) * g.Xb + g.Hx + i0];  // received
  // fold strip
  const int mir = g.face_x ? (g.Nx - i0) % g.Nx : g.Nx - 1 - i0;
  const T s = (g.face_x && i0 == 0) ? (sign < T(0) ? -sign : sign) : sign;
  const int r = y - y0;
  if (!g.face_y && r == 0) {  // row Ny of a center-y field: kept half, mirrored half
    if (i0 < g.Nx / 2) return a[(int64_t)y0 * g.Xb + g.Hx + i0];
    return s * a[(int64_t)y0 * g.Xb + g.Hx + mir];
  }
  // halo row Ny+j <- row Ny-j (center-y) or Ny-j+1 (face-y), mirrored; on a top
  // rank of Ny = Hy rows the lowest source row is a received south row
  const int src_row = g.face_y ? y0 - 1 - r : y0 - r;
  if (src_row < g.Hy) return s * south[(int64_t)src_row * g.Xb + g.Hx + mir];
  return s * a[(int64_t)src_row * g.Xb + g.Hx + mir];
}

// The field of this block and the cell of this thread; false past the field's end.
template <typename T>
__device__ __forceinline__ bool locate(const Group& grp, const Field*& f, T*& a,
                                       int64_t& at, int64_t& t, int& k, int& y, int& x) {
  int i = 0;
  for (int j = 1; j < grp.n; ++j)
    if ((int)blockIdx.x >= grp.f[j].block0) i = j;
  f = &grp.f[i];
  t = (int64_t)((int)blockIdx.x - f->block0) * kThreads + threadIdx.x;
  if (t >= f->K * f->cells) return false;
  k = (int)(t / f->cells);
  cell_of(t - k * f->cells, f->g, y, x);
  a = (T*)f->a + (int64_t)k * f->g.Yb * f->g.Xb;
  at = (int64_t)y * f->g.Xb + x;
  return true;
}

template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
    group_fill_kernel(const __grid_constant__ Group grp, T* __restrict__ saved,
                      const T* __restrict__ south, const T* __restrict__ north) {
  const Field* f;
  T* a;
  int64_t at, t;
  int k, y, x;
  if (!locate(grp, f, a, at, t, k, y, x)) return;
  // this plane's rows in the receive buffers (null where the role receives none)
  const int64_t rows = f->xoff + (int64_t)k * f->g.Hy * f->g.Xb;
  if (kSave) saved[f->strip + t] = a[at];
  a[at] = filled_value<T>(a, south ? south + rows : nullptr,
                          north ? north + rows : nullptr, y, x, f->g, T(f->sign));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_restore_kernel(const __grid_constant__ Group grp,
                         const T* __restrict__ saved) {
  const Field* f;
  T* a;
  int64_t at, t;
  int k, y, x;
  if (!locate(grp, f, a, at, t, k, y, x)) return;
  a[at] = saved[f->strip + t];
}

// The send buffer of a y-sharded exchange: part 0 holds every field's top Hy interior
// rows (rows Ny .. Ny+Hy-1, for the rank above), part 1 its bottom Hy interior rows
// (rows Hy .. 2Hy-1, for the rank below); in each part field after field at its
// kXoff, plane after plane, Hy full-width rows a plane. blockIdx.y is the field,
// blockIdx.z the part.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_pack_kernel(const __grid_constant__ Group grp, T* __restrict__ send,
                      int64_t part_len) {
  const Field& f = grp.f[blockIdx.y];
  const int64_t strip = (int64_t)f.g.Hy * f.g.Xb;  // a plane's rows: contiguous
  const int64_t row0 = (int64_t)(blockIdx.z == 0 ? f.g.Ny : f.g.Hy) * f.g.Xb;
  const T* a = (const T*)f.a;
  T* out = send + blockIdx.z * part_len + f.xoff;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < f.K * strip;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t k = e / strip;
    out[e] = a[k * f.g.Yb * f.g.Xb + row0 + (e - k * strip)];
  }
}

template <typename T>
__global__ void halo_fill_copy_kernel(const T* __restrict__ A, T* __restrict__ B,
                                      Geom g, T sign) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= g.Xb || y >= g.Yb) return;
  const int64_t plane = (int64_t)blockIdx.z * g.Yb * g.Xb;
  B[plane + (int64_t)y * g.Xb + x] =
      filled_value<T>(A + plane, nullptr, nullptr, y, x, g, sign);
}

// The group of the host table (kCols int64 a field), checked against the geometry:
// each field's cells, first block, first strip offset and offset in the send and
// receive buffers as the host plan lays them out, and a geometry its role can fill
// without a thread reading a cell of the launch (Ny > Hy + 1 for a single field,
// Ny >= Hy for a shard). Returns the blocks of the launch, or 0 for a table it
// refuses; `part_len` is the length of one part of the send buffer.
int make_group(const int64_t* table, int n, Group& grp, int64_t& part_len) {
  if (n < 1 || n > kMaxFields) return 0;
  grp.n = n;
  int64_t block = 0, strip = 0, xoff = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = table + (int64_t)i * kCols;
    Field& f = grp.f[i];
    f.a = (void*)(uintptr_t)r[kPtr];
    f.K = (int)r[kK];
    f.sign = (int)r[kSign];
    f.g = Geom{(int)r[kYb], (int)r[kXb], (int)r[kNx], (int)r[kNy], (int)r[kHx],
               (int)r[kHy], (int)r[kFaceX], (int)r[kFaceY], (int)r[kRole]};
    if (r[kRole] < kSingle || r[kRole] > kTop || (i > 0 && f.g.role != grp.f[0].g.role))
      return 0;
    const Geom& g = f.g;
    const bool rows_ok = g.role == kSingle ? g.Ny > g.Hy + 1 : g.Ny >= g.Hy;
    if (!rows_ok || g.Hy < 1 || g.Nx % 2 || 2 * g.Hx >= g.Nx ||
        g.Yb != g.Ny + 2 * g.Hy || g.Xb != g.Nx + 2 * g.Hx)
      return 0;
    f.cells = g.cells();
    f.block0 = (int)block;
    f.strip = strip;
    f.xoff = xoff;
    if (f.a == nullptr || f.K < 1 || f.cells < 1 || r[kCells] != f.cells ||
        r[kBlock0] != block || r[kStrip] != strip || r[kXoff] != xoff)
      return 0;
    block += (f.K * f.cells + kThreads - 1) / kThreads;
    strip += f.K * f.cells;
    xoff += (int64_t)f.K * g.Hy * g.Xb;
  }
  part_len = xoff;
  return block < (int64_t)1 << 31 ? (int)block : 0;
}

template <typename T>
int launch_group(const int64_t* table, int n, void* saved, int save, const void* south,
                 const void* north, void* stream) {
  Group grp;
  int64_t part_len;
  const int blocks = make_group(table, n, grp, part_len);
  // the receive buffers the role reads, and no other
  if (blocks == 0 || (save && saved == nullptr) ||
      (south != nullptr) != grp.f[0].g.recv_south() ||
      (north != nullptr) != grp.f[0].g.recv_north())
    return (int)cudaErrorInvalidValue;
  if (save)
    group_fill_kernel<T, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        grp, (T*)saved, (const T*)south, (const T*)north);
  else
    group_fill_kernel<T, false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        grp, nullptr, (const T*)south, (const T*)north);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pack(const int64_t* table, int n, void* send, void* stream) {
  Group grp;
  int64_t part_len;
  if (make_group(table, n, grp, part_len) == 0 || send == nullptr ||
      grp.f[0].g.role == kSingle)
    return (int)cudaErrorInvalidValue;
  int64_t most = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t len = (int64_t)grp.f[i].K * grp.f[i].g.Hy * grp.f[i].g.Xb;
    most = len > most ? len : most;
  }
  const int64_t bx = (most + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(bx < 1024 ? bx : 1024), n, 2);
  group_pack_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(grp, (T*)send,
                                                                     part_len);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_restore(const int64_t* table, int n, const void* saved, void* stream) {
  Group grp;
  int64_t part_len;
  const int blocks = make_group(table, n, grp, part_len);
  if (blocks == 0 || saved == nullptr) return (int)cudaErrorInvalidValue;
  group_restore_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      grp, (const T*)saved);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_copy(const void* A, void* B, int K, int Yb, int Xb, int Nx, int Ny, int Hx,
                int Hy, int face_x, int face_y, int sign, void* stream) {
  const Geom g{Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, kSingle};
  const dim3 block(128, 4);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y, K);
  halo_fill_copy_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)A, (T*)B, g, T(sign));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osg_halo_fill_group_f32(const int64_t* table, int n, void* saved,
                                       int save, const void* south, const void* north,
                                       void* stream) {
  return launch_group<float>(table, n, saved, save, south, north, stream);
}

extern "C" int osg_halo_fill_group_f64(const int64_t* table, int n, void* saved,
                                       int save, const void* south, const void* north,
                                       void* stream) {
  return launch_group<double>(table, n, saved, save, south, north, stream);
}

extern "C" int osg_halo_pack_group_f32(const int64_t* table, int n, void* send,
                                       void* stream) {
  return launch_pack<float>(table, n, send, stream);
}

extern "C" int osg_halo_pack_group_f64(const int64_t* table, int n, void* send,
                                       void* stream) {
  return launch_pack<double>(table, n, send, stream);
}

extern "C" int osg_halo_restore_group_f32(const int64_t* table, int n,
                                          const void* saved, void* stream) {
  return launch_restore<float>(table, n, saved, stream);
}

extern "C" int osg_halo_restore_group_f64(const int64_t* table, int n,
                                          const void* saved, void* stream) {
  return launch_restore<double>(table, n, saved, stream);
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
