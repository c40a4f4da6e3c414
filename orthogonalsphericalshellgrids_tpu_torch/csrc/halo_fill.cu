// Tripolar halo fill of halo-inclusive (K, Yb, Xb) stacks, in four entries:
//   group fill (osg_halo_fill_group):      fills the halos of up to 8 fields in
//                                          place in one launch, and with `save`
//                                          first copies the pre-fill value of every
//                                          cell it writes into a packed strip buffer;
//   group restore (osg_halo_restore_group): writes that buffer back into exactly
//                                          the cells the fill wrote, one launch;
//   group pack (osg_halo_pack_group):      copies the rows or the columns a sharded
//                                          rank sends into one send buffer, one
//                                          launch;
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
// x-blocks. On a 2-D (x, y) mesh a field holds the columns [ix*Nx, (ix+1)*Nx) of
// nx_g = n_x*Nx (the kRanksX, kIx and kNxG columns; n_x = 1 is the y-partitioned
// case above). Its fill runs in two launches, in the order of the JAX package's
// ops/spmd2d.py:fill_halos_spmd2d_groups: `inner` writes the cells of the interior
// columns (the south rows, the received north rows or the fold), then, after the
// x exchange, `outer` writes every x-halo cell from the x-neighbours' columns
// (`west`, `east`: each field's K planes of Yb rows of Hx columns at its kColOff),
// so that the corners and the x halos of the fold rows come from the neighbours'
// filled rows. The fold of an x-block reads the mirrored columns from the fold
// strips of the top ranks (`strips[q]`: rank q's rows Ny-1 .. Ny+Hy-1 at its
// interior columns, each field's K planes at its kFoldOff): all of them with the
// gather, or its mirror rank's and the one after it with the mirror
// (ops/spmd2d.py:_fold_arith; the face-x mirror of global column ig is
// (nx_g - ig) % nx_g, which for the block's first column lies in the block after
// the mirror rank). A top rank of Ny = Hy rows has a received south row as the
// lowest row of its strip, which it packed before receiving it: the fold reads that
// row from the top row of the rank below the strip's (`lows[q]`, its send rows at
// kXoff). Row Ny keeps the cells of global columns below nx_g/2: all, none or some
// of a block's columns. Both launches save into one packed buffer at the plan's
// offsets, so the save and the restore keep the serial plan's layout. Two rounds of
// exchange (rows and strips, then columns) and not one: in one round a block would
// need its diagonal neighbours' corners and, for the x halos of its fold rows, the
// fold strips of its x-neighbours' mirror blocks too, so the mirror mode would no
// longer read two blocks' strips; two launches of a few microseconds cost less than
// that bookkeeping, and each launch still reads only buffers no thread writes.
//
// Phases. A launch writes the plan's cells of its phase: all of them; `wrap`, the
// x-halo columns of the rows between the south and the north strips, from the
// plane's own columns (the local x-wrap that the overlap split's bulk pass of a
// y-partitioned rank reads, orthogonalsphericalshellgrids_tpu/models/
// hydrostatic.py:865-866); `no_wrap`, every other cell (the exchanged fill after
// it); `inner` and `outer` (x-blocks). Each phase saves exactly the cells it writes,
// and a restore of one phase writes back exactly those (a fill that fails after its
// first phase undoes that phase alone).
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
//   - an x-block's fold reads the strips and its own kept cells of row Ny, its
//     outer phase the received columns: no plane cell its launch writes;
//   - fields are separate: the wrapper refuses a group whose byte ranges overlap.
// The field table and the fold strips' addresses ride in the kernel's parameters
// (__grid_constant__, about 1.4 KB), so a launch needs no copy to the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 8;
constexpr int kMaxRanksX = 32;  // x-ranks whose fold strips a launch can read
constexpr int kThreads = 256;
// columns of a field's row in the host table
enum Col { kPtr, kK, kYb, kXb, kNx, kNy, kHx, kHy, kFaceX, kFaceY, kSign, kCells,
           kBlock0, kStrip, kRole, kXoff, kRanksX, kIx, kNxG, kFoldOff, kColOff, kCols };
// the shard roles of the kRole column
enum Role { kSingle, kBottom, kMiddle, kTop };
// the cells of the plan a launch writes (and saves)
enum Phase { kAll, kWrap, kNoWrap, kInner, kOuter };
// what a pack copies: the rows sent in y (and the fold strip), or the x columns
enum PackKind { kPackRows, kPackCols };

struct Geom {
  int Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, role;
  int n_x, ix, nx_g;  // x-ranks, this block's x-rank, global interior columns
  __host__ __device__ bool fold() const { return role == kSingle || role == kTop; }
  __host__ __device__ bool recv_south() const { return role == kMiddle || role == kTop; }
  __host__ __device__ bool recv_north() const {
    return role == kBottom || role == kMiddle;
  }
  // the first row of the north strip: row Ny of a center-y fold, else row Ny + 1
  __host__ __device__ int y0() const { return face_y || !fold() ? Hy + Ny : Hy + Ny - 1; }
  // cells of row Ny a center-y fold keeps as they are: the block's columns below
  // global column nx_g / 2
  __host__ __device__ int kept() const {
    if (face_y || !fold()) return 0;
    const int k = nx_g / 2 - ix * Nx;
    return k < 0 ? 0 : (k > Nx ? Nx : k);
  }
  __host__ __device__ int64_t cells() const {
    return (int64_t)Hy * Xb + (int64_t)(Yb - y0()) * Xb - kept() +
           (int64_t)(y0() - Hy) * 2 * Hx;
  }
};

struct Field {
  void* a;
  int64_t strip;    // offset of the field's first saved cell
  int64_t xoff;     // offset of the field's rows in the send and receive buffers
  int64_t foldoff;  // offset of the field's planes in a rank's fold strip
  int64_t coloff;   // offset of the field's columns in the x send and receive buffers
  int64_t cells;  // written cells a plane
  int block0;     // the field's first block
  int K;
  int sign;
  Geom g;
};

struct Group {
  Field f[kMaxFields];
  const void* strips[kMaxRanksX];  // the top ranks' fold strips (x-blocks)
  const void* lows[kMaxRanksX];    // the send rows of the ranks below them
  int n;
  int phase;
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
// the received rows, columns and fold strips, from the plane's parts of the receive
// buffers (`fold` is the plane's offset in each fold strip).
template <typename T>
__device__ __forceinline__ T filled_value(const T* a, const T* south, const T* north,
                                          const T* west, const T* east,
                                          const void* const* strips,
                                          const void* const* lows, int64_t rows,
                                          int64_t fold, int y, int x, const Geom& g,
                                          T sign) {
  if (g.n_x > 1) {  // an x-block: its x halos are the x-neighbours' columns
    if (x < g.Hx) return west[(int64_t)y * g.Hx + x];
    if (x >= g.Hx + g.Nx) return east[(int64_t)y * g.Hx + x - g.Hx - g.Nx];
  }
  // interior column this cell copies (periodic in x)
  const int i0 = (x < g.Hx ? x + g.Nx : (x >= g.Hx + g.Nx ? x - g.Nx : x)) - g.Hx;
  const int y0 = g.y0();
  if (y < g.Hy) {
    if (g.recv_south()) return south[(int64_t)y * g.Xb + g.Hx + i0];  // received
    return a[(int64_t)g.Hy * g.Xb + g.Hx + i0];  // zero-gradient south
  }
  if (y < y0) return a[(int64_t)y * g.Xb + g.Hx + i0];  // interior or x-wrap
  if (g.recv_north()) return north[(int64_t)(y - y0) * g.Xb + g.Hx + i0];  // received
  const int r = y - y0;
  if (g.n_x > 1) {  // the fold of an x-block, from the top ranks' strips
    const int ig = g.ix * g.Nx + i0;  // global column
    const int mir = g.face_x ? (g.nx_g - ig) % g.nx_g : g.nx_g - 1 - ig;
    const T s = (g.face_x && ig == 0) ? (sign < T(0) ? -sign : sign) : sign;
    if (!g.face_y && r == 0 && ig < g.nx_g / 2)  // the kept part of row Ny
      return a[(int64_t)y0 * g.Xb + g.Hx + i0];
    // strip row Hy is row Ny; halo row Ny+j reads strip row Hy - j (center-y) or
    // Hy - j + 1 (face-y), which is Hy - r from either y0; strip row 0 of a rank of
    // Ny = Hy rows is the top interior row of the rank below it
    const int q = mir / g.Nx, c = mir % g.Nx;
    if (r == g.Hy && g.Ny == g.Hy)
      return s * ((const T*)lows[q])[rows + (int64_t)(g.Hy - 1) * g.Xb + g.Hx + c];
    return s * ((const T*)strips[q])[fold + (int64_t)(g.Hy - r) * g.Nx + c];
  }
  // fold strip
  const int mir = g.face_x ? (g.Nx - i0) % g.Nx : g.Nx - 1 - i0;
  const T s = (g.face_x && i0 == 0) ? (sign < T(0) ? -sign : sign) : sign;
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

// Whether the plan's cell (y, x) belongs to `phase`.
__device__ __forceinline__ bool in_phase(int phase, const Geom& g, int y, int x) {
  const bool outer = x < g.Hx || x >= g.Hx + g.Nx;
  const bool wrap = outer && y >= g.Hy && y < g.y0();
  switch (phase) {
    case kWrap: return wrap;
    case kNoWrap: return !wrap;
    case kInner: return !outer;
    case kOuter: return outer;
    default: return true;
  }
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
                      const T* __restrict__ south, const T* __restrict__ north,
                      const T* __restrict__ west, const T* __restrict__ east) {
  const Field* f;
  T* a;
  int64_t at, t;
  int k, y, x;
  if (!locate(grp, f, a, at, t, k, y, x) || !in_phase(grp.phase, f->g, y, x)) return;
  const Geom& g = f->g;
  // this plane's rows and columns in the receive buffers (null where the launch
  // receives none) and its offset in the fold strips
  const int64_t rows = f->xoff + (int64_t)k * g.Hy * g.Xb;
  const int64_t cols = f->coloff + (int64_t)k * g.Yb * g.Hx;
  const int64_t fold = f->foldoff + (int64_t)k * (g.Hy + 1) * g.Nx;
  if (kSave) saved[f->strip + t] = a[at];
  a[at] = filled_value<T>(a, south ? south + rows : nullptr,
                          north ? north + rows : nullptr, west ? west + cols : nullptr,
                          east ? east + cols : nullptr, grp.strips, grp.lows, rows, fold,
                          y, x, g, T(f->sign));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_restore_kernel(const __grid_constant__ Group grp,
                         const T* __restrict__ saved) {
  const Field* f;
  T* a;
  int64_t at, t;
  int k, y, x;
  if (!locate(grp, f, a, at, t, k, y, x) || !in_phase(grp.phase, f->g, y, x)) return;
  a[at] = saved[f->strip + t];
}

// The send buffer of a sharded exchange. Rows (kPackRows): part 0 holds every
// field's top Hy interior rows (rows Ny .. Ny+Hy-1, for the rank above), part 1 its
// bottom Hy interior rows (rows Hy .. 2Hy-1, for the rank below), each at its kXoff,
// Hy full-width rows a plane; on an x-block part 2 (at 2*part_len) holds its fold
// strip, rows Ny-1 .. Ny+Hy-1 at the interior columns, at its kFoldOff. Columns
// (kPackCols, x-blocks): part 0 holds every field's last Hx interior columns (for
// the rank east of it), part 1 its first Hx (for the rank west of it), Yb rows a
// plane at its kColOff. blockIdx.y is the field, blockIdx.z the part.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_pack_kernel(const __grid_constant__ Group grp, T* __restrict__ send,
                      int kind, int64_t part_len) {
  const Field& f = grp.f[blockIdx.y];
  const Geom& g = f.g;
  int r0, c0, h, w;
  int64_t off;
  if (kind == kPackCols) {
    r0 = 0, c0 = blockIdx.z == 0 ? g.Nx : g.Hx, h = g.Yb, w = g.Hx;
    off = blockIdx.z * part_len + f.coloff;
  } else if (blockIdx.z < 2) {
    r0 = blockIdx.z == 0 ? g.Ny : g.Hy, c0 = 0, h = g.Hy, w = g.Xb;
    off = blockIdx.z * part_len + f.xoff;
  } else {
    r0 = g.Ny - 1, c0 = g.Hx, h = g.Hy + 1, w = g.Nx;
    off = 2 * part_len + f.foldoff;
  }
  const int64_t plane = (int64_t)h * w;
  const T* a = (const T*)f.a;
  T* out = send + off;
  for (int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x; e < f.K * plane;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t k = e / plane;
    const int64_t m = e - k * plane;
    const int64_t r = m / w;
    out[e] = a[k * g.Yb * g.Xb + (r0 + r) * g.Xb + c0 + (m - r * w)];
  }
}

template <typename T>
__global__ void halo_fill_copy_kernel(const T* __restrict__ A, T* __restrict__ B,
                                      Geom g, T sign) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= g.Xb || y >= g.Yb) return;
  const int64_t plane = (int64_t)blockIdx.z * g.Yb * g.Xb;
  B[plane + (int64_t)y * g.Xb + x] = filled_value<T>(
      A + plane, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, y, x, g, sign);
}

// The lengths of one part of each send buffer: the rows of one direction, a rank's
// fold strip, the columns of one direction.
struct Parts {
  int64_t rows, fold, cols;
};

// The group of the host table (kCols int64 a field), checked against the geometry:
// each field's cells, first block, first strip offset and offsets in the send and
// receive buffers as the host plan lays them out; one role and one x-rank for all
// fields; and a geometry its role can fill without a thread reading a cell of the
// launch (Ny > Hy + 1 for a single field, Ny >= Hy for a shard, Ny > Hy for the
// fold of an x-block, whose strip must be interior rows). Returns the blocks of the
// launch, or 0 for a table it refuses.
int make_group(const int64_t* table, int n, Group& grp, Parts& parts) {
  if (n < 1 || n > kMaxFields) return 0;
  grp.n = n;
  grp.phase = kAll;
  for (int q = 0; q < kMaxRanksX; ++q) grp.strips[q] = grp.lows[q] = nullptr;
  int64_t block = 0, strip = 0, xoff = 0, foldoff = 0, coloff = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = table + (int64_t)i * kCols;
    Field& f = grp.f[i];
    f.a = (void*)(uintptr_t)r[kPtr];
    f.K = (int)r[kK];
    f.sign = (int)r[kSign];
    f.g = Geom{(int)r[kYb], (int)r[kXb], (int)r[kNx], (int)r[kNy], (int)r[kHx],
               (int)r[kHy], (int)r[kFaceX], (int)r[kFaceY], (int)r[kRole],
               (int)r[kRanksX], (int)r[kIx], (int)r[kNxG]};
    const Geom& g = f.g;
    if (g.role < kSingle || g.role > kTop || g.n_x < 1 || g.n_x > kMaxRanksX ||
        g.ix < 0 || g.ix >= g.n_x || (int64_t)g.nx_g != (int64_t)g.n_x * g.Nx)
      return 0;
    if (i > 0 && (g.role != grp.f[0].g.role || g.n_x != grp.f[0].g.n_x ||
                  g.ix != grp.f[0].g.ix))
      return 0;
    // (an x-block of the top of several y-ranks reads the row below a strip of
    // Ny = Hy rows from the rank below; one alone needs Ny > Hy)
    const bool rows_ok = g.role == kSingle ? (g.n_x == 1 ? g.Ny > g.Hy + 1 : g.Ny > g.Hy)
                                           : g.Ny >= g.Hy;
    // a y-partitioned rank wraps x itself (Nx even, 2*Hx < Nx); an x-block's x
    // sends are interior columns (Nx >= Hx) of an even global row
    const bool cols_ok = g.n_x == 1 ? g.Nx % 2 == 0 && 2 * g.Hx < g.Nx
                                    : g.nx_g % 2 == 0 && g.Nx >= g.Hx && g.Hx >= 1;
    if (!rows_ok || !cols_ok || g.Hy < 1 || g.Yb != g.Ny + 2 * g.Hy ||
        g.Xb != g.Nx + 2 * g.Hx)
      return 0;
    f.cells = g.cells();
    f.block0 = (int)block;
    f.strip = strip;
    f.xoff = xoff;
    f.foldoff = foldoff;
    f.coloff = coloff;
    if (f.a == nullptr || f.K < 1 || f.cells < 1 || r[kCells] != f.cells ||
        r[kBlock0] != block || r[kStrip] != strip || r[kXoff] != xoff ||
        r[kFoldOff] != foldoff || r[kColOff] != coloff)
      return 0;
    block += (f.K * f.cells + kThreads - 1) / kThreads;
    strip += f.K * f.cells;
    xoff += (int64_t)f.K * g.Hy * g.Xb;
    foldoff += (int64_t)f.K * (g.Hy + 1) * g.Nx;
    coloff += (int64_t)f.K * g.Yb * g.Hx;
  }
  parts = Parts{xoff, foldoff, coloff};
  return block < (int64_t)1 << 31 ? (int)block : 0;
}

// The receive buffers a launch of `phase` reads, and no other: the phase must be one
// of the role's (x-blocks fill `inner` then `outer`, a y-partitioned rank `all`, or
// `wrap` then `no_wrap`); `inner` and the fill reading rows read the role's rows and,
// on the fold of an x-block, the strips of the x-ranks its mirror columns lie in
// (and the rows of the ranks below them where a field has Ny = Hy); `outer` reads
// both x-neighbours' columns.
bool receives_ok(const Group& grp, int phase, const void* south, const void* north,
                 const void* west, const void* east, const int64_t* strips,
                 const int64_t* lows) {
  const Geom& g = grp.f[0].g;
  const bool block = g.n_x > 1;
  if (block ? phase != kInner && phase != kOuter
            : phase != kAll && phase != kWrap && phase != kNoWrap)
    return false;
  const bool rows = phase == kAll || phase == kNoWrap || phase == kInner;
  const bool cols = phase == kOuter;
  if ((south != nullptr) != (rows && g.recv_south()) ||
      (north != nullptr) != (rows && g.recv_north()) || (west != nullptr) != cols ||
      (east != nullptr) != cols)
    return false;
  const bool fold = block && phase == kInner && g.fold();
  bool low = false;
  for (int i = 0; i < grp.n; ++i) low = low || grp.f[i].g.Ny == grp.f[i].g.Hy;
  low = low && fold;
  if ((strips != nullptr) != fold || (lows != nullptr) != low) return false;
  if (fold)  // the strips of the blocks the mirror columns of this block lie in
    for (int c = 0; c < g.Nx; ++c) {
      const int ig = g.ix * g.Nx + c;
      for (int face = 0; face < 2; ++face) {
        const int q = (face ? (g.nx_g - ig) % g.nx_g : g.nx_g - 1 - ig) / g.Nx;
        if (strips[q] == 0 || (low && lows[q] == 0)) return false;
      }
    }
  return true;
}

template <typename T>
int launch_group(const int64_t* table, int n, void* saved, int save, const void* south,
                 const void* north, const void* west, const void* east,
                 const int64_t* strips, const int64_t* lows, int phase, void* stream) {
  Group grp;
  Parts parts;
  const int blocks = make_group(table, n, grp, parts);
  if (blocks == 0 || (save && saved == nullptr) ||
      !receives_ok(grp, phase, south, north, west, east, strips, lows))
    return (int)cudaErrorInvalidValue;
  grp.phase = phase;
  for (int q = 0; q < grp.f[0].g.n_x; ++q) {
    if (strips != nullptr) grp.strips[q] = (const void*)strips[q];
    if (lows != nullptr) grp.lows[q] = (const void*)lows[q];
  }
  if (save)
    group_fill_kernel<T, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        grp, (T*)saved, (const T*)south, (const T*)north, (const T*)west,
        (const T*)east);
  else
    group_fill_kernel<T, false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        grp, nullptr, (const T*)south, (const T*)north, (const T*)west,
        (const T*)east);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pack(const int64_t* table, int n, void* send, int kind, void* stream) {
  Group grp;
  Parts parts;
  if (make_group(table, n, grp, parts) == 0 || send == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool block = grp.f[0].g.n_x > 1;
  // a y-partitioned rank packs rows unless it is the only one; an x-block packs
  // rows with its fold strip, and columns
  if (kind == kPackRows ? !block && grp.f[0].g.role == kSingle
                        : kind != kPackCols || !block)
    return (int)cudaErrorInvalidValue;
  int64_t most = 0;
  for (int i = 0; i < n; ++i) {
    const Geom& g = grp.f[i].g;
    const int64_t plane = kind == kPackCols ? (int64_t)g.Yb * g.Hx
                                            : (int64_t)(g.Hy + 1) * g.Xb;
    const int64_t len = grp.f[i].K * plane;
    most = len > most ? len : most;
  }
  const int64_t bx = (most + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(bx < 1024 ? bx : 1024), n,
                  kind == kPackRows && block ? 3 : 2);
  group_pack_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      grp, (T*)send, kind, kind == kPackCols ? parts.cols : parts.rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_restore(const int64_t* table, int n, const void* saved, int phase,
                   void* stream) {
  Group grp;
  Parts parts;
  const int blocks = make_group(table, n, grp, parts);
  if (blocks == 0 || saved == nullptr || phase < kAll || phase > kOuter)
    return (int)cudaErrorInvalidValue;
  grp.phase = phase;
  group_restore_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      grp, (const T*)saved);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_copy(const void* A, void* B, int K, int Yb, int Xb, int Nx, int Ny, int Hx,
                int Hy, int face_x, int face_y, int sign, void* stream) {
  const Geom g{Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, kSingle, 1, 0, Nx};
  const dim3 block(128, 4);
  const dim3 grid((Xb + block.x - 1) / block.x, (Yb + block.y - 1) / block.y, K);
  halo_fill_copy_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)A, (T*)B, g, T(sign));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int osg_halo_fill_group_f32(const int64_t* table, int n, void* saved,
                                       int save, const void* south, const void* north,
                                       const void* west, const void* east,
                                       const int64_t* strips, const int64_t* lows,
                                       int phase, void* stream) {
  return launch_group<float>(table, n, saved, save, south, north, west, east, strips,
                             lows, phase, stream);
}

extern "C" int osg_halo_fill_group_f64(const int64_t* table, int n, void* saved,
                                       int save, const void* south, const void* north,
                                       const void* west, const void* east,
                                       const int64_t* strips, const int64_t* lows,
                                       int phase, void* stream) {
  return launch_group<double>(table, n, saved, save, south, north, west, east, strips,
                              lows, phase, stream);
}

extern "C" int osg_halo_pack_group_f32(const int64_t* table, int n, void* send, int kind,
                                       void* stream) {
  return launch_pack<float>(table, n, send, kind, stream);
}

extern "C" int osg_halo_pack_group_f64(const int64_t* table, int n, void* send, int kind,
                                       void* stream) {
  return launch_pack<double>(table, n, send, kind, stream);
}

extern "C" int osg_halo_restore_group_f32(const int64_t* table, int n,
                                          const void* saved, int phase, void* stream) {
  return launch_restore<float>(table, n, saved, phase, stream);
}

extern "C" int osg_halo_restore_group_f64(const int64_t* table, int n,
                                          const void* saved, int phase, void* stream) {
  return launch_restore<double>(table, n, saved, phase, stream);
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
