"""The 2-D (x, y) block fills (``ops/spmd2d.py``, ``kernels/halo_fill.py`` in a
``BlockRole``, ``csrc/halo_fill.cu``) at float64 on the CPU.

- the port's ``fill_halos_spmd2d_groups`` and ``fill_halos_spmd2d_batch`` against
  the JAX package's under ``shard_map`` on the 8 virtual devices, bitwise, in both
  fold modes, every location and sign, on (2, 4), (4, 2), (8, 1) and (3, 1) meshes
  (an odd x-partition, whose middle block straddles the fold's middle column);
- a replay of the kernel's index map (``cell_of``, ``in_phase``, ``filled_value``
  with the receive buffers and the fold strips) for every block role of the plan,
  phase by phase: every written cell is written once, no thread reads a cell its
  launch writes, the two phases tile the saved buffer, the replayed fill and save
  are the plain version's bits, and the restore (of all, or of the first phase)
  gives the fields back; the same for a y-partitioned rank's wrap and the rest;
- the pack kernel's index map (rows with the fold strip, and columns) against
  ``pack_strips_plain``;
- ``ops/zipper.fill_halos_batch`` and ``fold_north_batch`` against the JAX
  package's;
- the blocks of a field filled through the 2-D route against the serial fill;
- the refusals.

The kernels are held against these plain versions on a card by
``tests/test_torch_cuda.py``.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu.ops import spmd2d as jspmd2d  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import CC as JCC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import CF as JCF  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import FC as JFC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import FF as JFF  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops import spmd2d, zipper  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC, FF  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.parallel import make_mesh2d  # noqa: E402

torch.set_num_threads(1)

LOCS = [(CC, JCC, 1), (FC, JFC, -1), (CF, JCF, -1), (FF, JFF, 1), (FC, JFC, 1),
        (CF, JCF, 1)]


def _field(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


def _run_blocks(n_x, n_y, fn):
    """``fn(block)`` on every block of one (n_x, n_y) ``LocalExchange``, each in its
    thread and its turn; ``block`` is the block's ``Spmd2D`` without a fold mode
    (``fn`` sets it)."""
    mesh = make_mesh2d(n_x, n_y)

    def run(k):
        with mesh.turn(k):
            return fn((k % n_x, k // n_x, mesh))

    with ThreadPoolExecutor(n_x * n_y) as pool:
        futures = [pool.submit(run, k) for k in range(n_x * n_y)]
        return [f.result(timeout=60) for f in futures]


# ----------------------------------------------------------------------------------
# against the JAX package, bitwise
# ----------------------------------------------------------------------------------

NX_G, HX, HY = 24, 2, 3


@pytest.mark.parametrize("mode", ["gather", "mirror"])
@pytest.mark.parametrize("mesh", [(2, 4, 16), (4, 2, 16), (8, 1, 16), (3, 1, 16),
                                  (2, 4, 12)])
@pytest.mark.parametrize("form", ["batch", "groups"])
def test_block_fills_match_jax(form, mesh, mode):
    """The port's 2-D fills on every block against the JAX package's under
    ``shard_map``, bitwise: the batch of six planes (each its own location and sign)
    and three groups of two planes each; on 16 rows, and on 12 rows of 4 y-ranks,
    where the top blocks' fold strips reach a received south row (ny = Hy)."""
    n_x, n_y, NY_G = mesh
    nxl, nyl = NX_G // n_x, NY_G // n_y
    S = np.random.default_rng(n_x + 10 * n_y).standard_normal(
        (len(LOCS), NY_G + 2 * HY, NX_G + 2 * HX))
    jmesh = Mesh(np.asarray(jax.devices()[:n_x * n_y]).reshape(n_y, n_x), ("y", "x"))
    jsp = jspmd2d.Spmd2D(n_x=n_x, n_y=n_y, nx_global=NX_G, fold_mode=mode)
    glocs = [LOCS[0], LOCS[1], LOCS[2]]

    def jfill(Sg):
        iy, ix = jax.lax.axis_index("y"), jax.lax.axis_index("x")
        blk = jax.lax.dynamic_slice(Sg, (jnp.int32(0), iy * nyl, ix * nxl),
                                    (len(LOCS), nyl + 2 * HY, nxl + 2 * HX))
        if form == "batch":
            return jspmd2d.fill_halos_spmd2d_batch(
                blk, [j for _, j, _ in LOCS], [s for *_, s in LOCS], nxl, nyl, HX, HY,
                jsp)
        return jnp.concatenate(jspmd2d.fill_halos_spmd2d_groups(
            [blk[0:2], blk[2:4], blk[4:6]], [j for _, j, _ in glocs],
            [s for *_, s in glocs], nxl, nyl, HX, HY, jsp))

    want = np.asarray(jax.jit(jax.shard_map(jfill, mesh=jmesh, in_specs=P(),
                                            out_specs=P(None, "y", "x")))(jnp.asarray(S)))

    def tfill(b):
        ix, iy, ex = b
        sp = spmd2d.Spmd2D(ix, iy, n_x, n_y, NX_G, ex, mode)
        blk = torch.from_numpy(S[:, iy * nyl:iy * nyl + nyl + 2 * HY,
                                 ix * nxl:ix * nxl + nxl + 2 * HX].copy())
        if form == "batch":
            return spmd2d.fill_halos_spmd2d_batch(blk, [t for t, _, _ in LOCS],
                                                  [s for *_, s in LOCS], nxl, nyl, HX,
                                                  HY, sp)
        return torch.cat(spmd2d.fill_halos_spmd2d_groups(
            [blk[0:2], blk[2:4], blk[4:6]], [t for t, _, _ in glocs],
            [s for *_, s in glocs], nxl, nyl, HX, HY, sp))

    got = _run_blocks(n_x, n_y, tfill)
    br, bc = nyl + 2 * HY, nxl + 2 * HX
    for k, g in enumerate(got):
        iy, ix = divmod(k, n_x)
        np.testing.assert_array_equal(
            g.numpy(), want[:, iy * br:(iy + 1) * br, ix * bc:(ix + 1) * bc],
            err_msg=f"block ({ix}, {iy})")


@pytest.mark.parametrize("kind", ["torch", "numpy"])
@pytest.mark.parametrize("ny", [3, 4, 9])
def test_batch_fills_match_jax(ny, kind):
    """``ops/zipper.fill_halos_batch`` and ``fold_north_batch`` (a stack whose planes
    have their own location and sign) against the JAX package's, bitwise, also
    where the fold window reaches the south rows (ny = 3 at Hy = 3)."""
    from orthogonalsphericalshellgrids_tpu.ops import zipper as jzipper

    S = np.random.default_rng(ny).standard_normal((len(LOCS), ny + 2 * HY, 16 + 2 * HX))
    A = torch.from_numpy(S) if kind == "torch" else S
    tl, jl, signs = ([x[i] for x in LOCS] for i in range(3))
    for name in ("fill_halos_batch", "fold_north_batch"):
        want = np.asarray(getattr(jzipper, name)(jnp.asarray(S), jl, signs, 16, ny, HX, HY,
                                                 xp=jnp))
        got = getattr(zipper, name)(A, tl, signs, 16, ny, HX, HY)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
    np.testing.assert_array_equal(np.asarray(A), S)  # the input is left as it was


def test_fold_modes():
    """``"auto"`` is the gather up to four x-ranks and the mirror beyond; an unknown
    mode is refused; the mirror reads two x-ranks' strips, the gather all."""
    mesh = make_mesh2d(8, 1)
    assert spmd2d.Spmd2D(0, 0, 4, 1, 48, mesh).resolved_fold_mode == "gather"
    assert spmd2d.Spmd2D(0, 0, 8, 1, 48, mesh).resolved_fold_mode == "mirror"
    with pytest.raises(ValueError):
        spmd2d.Spmd2D(0, 0, 2, 1, 48, mesh, "scatter")
    assert spmd2d.Spmd2D(2, 0, 8, 1, 48, mesh).fold_sources == (5, 6)
    assert spmd2d.Spmd2D(0, 0, 8, 1, 48, mesh).fold_sources == (0, 7)
    assert spmd2d.Spmd2D(1, 0, 3, 2, 48, mesh, "gather").fold_sources == ()
    assert spmd2d.Spmd2D(1, 1, 3, 2, 48, mesh, "gather").fold_sources == (0, 1, 2)


# ----------------------------------------------------------------------------------
# the kernel's index map, replayed
# ----------------------------------------------------------------------------------

def _groups(nx, ny, K=2):
    """The Bickley and gyre groups of one block of ``ny`` x ``nx``: base fields at
    halo 5 and the extended η, U, V at halo 7, views of one buffer."""
    out = {}
    for name, stacks in (("bickley", [(None, FC, -1), (None, CF, -1), (None, CC, 1)]),
                         ("gyre", [(K, FC, -1), (K, CF, -1), (2 * K, CC, 1)])):
        fields = [(_field((ny + 10, nx + 10) if k is None else (k, ny + 10, nx + 10),
                          seed=i), loc, sign, nx, ny, 5, 5)
                  for i, (k, loc, sign) in enumerate(stacks)]
        ext = _field((3, ny + 14, nx + 14), seed=99)
        fields += [(ext[0], CC, 1, nx, ny, 7, 7), (ext[1], FC, -1, nx, ny, 7, 7),
                   (ext[2], CF, -1, nx, ny, 7, 7)]
        out[name] = (fields, ext)
    return out


def _geom_fields(g):
    K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, role = g
    y, n_x, ix, nx_g = halo_fill._split(role, Nx)
    return K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, y, n_x, ix, nx_g


def _y0_kept(g):
    """csrc/halo_fill.cu:Geom::y0 and kept."""
    K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, y, n_x, ix, nx_g = _geom_fields(g)
    if fy or y not in (halo_fill.SINGLE, halo_fill.TOP):
        return Hy + Ny, 0
    return Hy + Ny - 1, min(max(nx_g // 2 - ix * Nx, 0), Nx)


def _cell_of(m, g):
    """csrc/halo_fill.cu:cell_of, statement for statement."""
    K, Yb, Xb, Nx, Ny, Hx, Hy, *_ = _geom_fields(g)
    y0, kept = _y0_kept(g)
    if m < Hy * Xb:
        return m // Xb, m % Xb
    m -= Hy * Xb
    n_fold = (Yb - y0) * Xb - kept
    if m < n_fold:
        first = Xb - kept
        if m < first:
            return y0, (m if m < Hx else m + kept)
        m -= first
        return y0 + 1 + m // Xb, m % Xb
    m -= n_fold
    c = m % (2 * Hx)
    return Hy + m // (2 * Hx), (c if c < Hx else Nx + c)


def _in_phase(phase, g, y, x):
    """csrc/halo_fill.cu:in_phase."""
    Nx, Hx, Hy = g[3], g[5], g[6]
    outer = x < Hx or x >= Hx + Nx
    wrap = outer and Hy <= y < _y0_kept(g)[0]
    return {halo_fill.ALL: True, halo_fill.WRAP: wrap, halo_fill.NO_WRAP: not wrap,
            halo_fill.INNER: not outer, halo_fill.OUTER: outer}[phase]


def _source(y, x, g, sign):
    """csrc/halo_fill.cu:filled_value: (the buffer it reads, the index there or (row,
    column) of the plane, the factor it applies)."""
    K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, yr, n_x, ix, nx_g = _geom_fields(g)
    recv_south, recv_north = halo_fill.receives(yr)
    if n_x > 1:
        if x < Hx:
            return "west", y * Hx + x, 1
        if x >= Hx + Nx:
            return "east", y * Hx + x - Hx - Nx, 1
    i0 = (x + Nx if x < Hx else (x - Nx if x >= Hx + Nx else x)) - Hx
    y0, _ = _y0_kept(g)
    if y < Hy:
        return ("south", y * Xb + Hx + i0, 1) if recv_south else ("a", (Hy, Hx + i0), 1)
    if y < y0:
        return "a", (y, Hx + i0), 1
    if recv_north:
        return "north", (y - y0) * Xb + Hx + i0, 1
    r = y - y0
    if n_x > 1:
        ig = ix * Nx + i0
        mir = (nx_g - ig) % nx_g if fx else nx_g - 1 - ig
        s = abs(sign) if (fx and ig == 0) else sign
        if not fy and r == 0 and ig < nx_g // 2:
            return "a", (y0, Hx + i0), 1
        if r == Hy and Ny == Hy:
            return ("low", mir // Nx), (Hy - 1) * Xb + Hx + mir % Nx, s
        return ("strip", mir // Nx), (Hy - r) * Nx + mir % Nx, s
    mir = (Nx - i0) % Nx if fx else Nx - 1 - i0
    s = abs(sign) if (fx and i0 == 0) else sign
    if not fy and r == 0:
        return ("a", (y0, Hx + i0), 1) if i0 < Nx // 2 else ("a", (y0, Hx + mir), s)
    src = (y0 - 1 - r) if fy else (y0 - r)
    if src < Hy:
        return "south", src * Xb + Hx + mir, s
    return "a", (src, Hx + mir), s


def _expected_writes(g):
    """Every cell a fill writes, from the geometry and role alone: the halo, and for
    a center-y fold the cells of row Ny at global columns from nx_g // 2 on."""
    K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, *_ = _geom_fields(g)
    m = np.ones((Yb, Xb), bool)
    m[Hy:Hy + Ny, Hx:Hx + Nx] = False
    y0, kept = _y0_kept(g)
    if y0 == Hy + Ny - 1:
        m[y0, Hx + kept:Hx + Nx] = True
    return np.flatnonzero(m)


def _replay(fields, ext, role, phases, recv):
    """Replay the launches of ``phases`` as the kernel runs them, on the plain
    version's buffers: returns (writes, reads, slots, replayed) with element
    addresses (each stack its own allocation, the extended planes views of one
    buffer, then the receive buffers)."""
    geoms = tuple(halo_fill._geometry("t", *f[:2], *f[3:], role) for f in fields)
    plan = halo_fill.group_plan(geoms)
    addr, top, ext_at = [], 0, None
    for A, *_ in fields:
        if A.untyped_storage().data_ptr() == ext.untyped_storage().data_ptr():
            if ext_at is None:
                ext_at, top = top, top + ext.numel() + 1000
            addr.append(ext_at + A.storage_offset())
        else:
            addr.append(top)
            top += A.numel() + 1000
    bufs = {n: recv[n] for n in ("south", "north", "west", "east")}
    bufs.update({f"strip{q}": st for q, st in enumerate(recv["strips"] or ())})
    bufs.update({f"low{q}": st for q, st in enumerate(recv.get("lows") or ())})
    base = {}
    for name, buf in bufs.items():
        base[name] = top
        top += (0 if buf is None else buf.numel()) + 1000
    out = {p: ([], [], [], []) for p in phases}
    for phase in phases:
        writes, reads, slots, replayed = out[phase]
        for b in range(plan.blocks):
            i = max(j for j in range(len(fields)) if b >= plan.block0[j])
            g = geoms[i]
            K, Yb, Xb, Nx, Ny, Hx, Hy = g[:7]
            n = plan.cells[i]
            old = fields[i][0].numpy().reshape(-1)
            for th in range(halo_fill.THREADS):
                t = (b - plan.block0[i]) * halo_fill.THREADS + th
                if t >= K * n:
                    continue
                k = t // n
                y, x = _cell_of(t - k * n, g)
                if not _in_phase(phase, g, y, x):
                    continue
                buf, at_src, s = _source(y, x, g, fields[i][2])
                at = k * Yb * Xb + y * Xb + x
                if buf == "a":
                    sy, sx = at_src
                    src_addr = addr[i] + k * Yb * Xb + sy * Xb + sx
                    value = old[k * Yb * Xb + sy * Xb + sx]
                else:
                    if buf in ("south", "north"):
                        off = plan.xoff[i] + k * Hy * Xb + at_src
                    elif buf in ("west", "east"):
                        off = plan.cols[i] + k * Yb * Hx + at_src
                    elif buf[0] == "low":
                        off = plan.xoff[i] + k * Hy * Xb + at_src
                        buf = f"low{buf[1]}"
                    else:
                        off = plan.fold[i] + k * (Hy + 1) * Nx + at_src
                        buf = f"strip{buf[1]}"
                    src_addr, value = base[buf] + off, bufs[buf].numpy()[off]
                writes.append(addr[i] + at)
                reads.append((addr[i] + at, src_addr))
                slots.append(plan.strip[i] + t)
                replayed.append((i, at, plan.strip[i] + t, old[at], s * value))
    return geoms, plan, addr, out


def _block_recv(fields, role, mode, seed):
    """Random receive buffers of a block's plan: its rows, its columns and the fold
    strips it reads (None where it reads none)."""
    geoms = tuple(halo_fill._geometry("t", *f[:2], *f[3:], role) for f in fields)
    plan = halo_fill.group_plan(geoms)
    r = np.random.default_rng(seed)

    def buf(n):
        return torch.as_tensor(r.standard_normal(n))

    s, n = halo_fill.receives(role)
    src = spmd2d.fold_sources(role, mode)
    strips = [buf(plan.fold_len) if q in src else None
              for q in range(role.n_x)] if src else None
    lows = None
    if src and any(g[4] == g[6] for g in geoms):
        lows = [buf(plan.part_len) if q in src else None for q in range(role.n_x)]
    return dict(south=buf(plan.part_len) if s else None,
                north=buf(plan.part_len) if n else None, strips=strips, lows=lows,
                west=buf(plan.col_len), east=buf(plan.col_len))


@pytest.mark.parametrize("mesh,mode,ny", [((3, 2), "gather", 9), ((4, 1), "mirror", 9),
                                          ((2, 3), "mirror", 9), ((3, 2), "mirror", 7)])
@pytest.mark.parametrize("path", ["bickley", "gyre"])
def test_block_index_map_replay(path, mesh, mode, ny):
    """Every thread of a block's inner and outer launches, as the kernel runs them,
    for every block of the mesh: the two phases together write each cell of the
    fill exactly once; no thread reads a cell its launch writes; their slots tile
    the saved buffer; the replayed fill and save are the plain version's bits, and
    the plain restore (of the outer phase alone, then of both) gives the fields
    back. At ny = 7 the extended fields have Ny = Hy, and the top blocks' folds
    read the rows of the blocks below their strips."""
    n_x, n_y = mesh
    nx = 12
    for iy in range(n_y):
        for ix in range(n_x):
            role = halo_fill.block_role(ix, iy, n_x, n_y, n_x * nx)
            fields, ext = _groups(nx, ny)[path]
            recv = _block_recv(fields, role, mode, seed=ix + 7 * iy)
            geoms, plan, addr, out = _replay(fields, ext, role,
                                             (halo_fill.INNER, halo_fill.OUTER), recv)
            expect = [addr[i] + k * g[1] * g[2] + c for i, g in enumerate(geoms)
                      for k in range(g[0]) for c in _expected_writes(g)]
            writes = out[halo_fill.INNER][0] + out[halo_fill.OUTER][0]
            assert sorted(writes) == sorted(expect), (ix, iy)
            for phase in (halo_fill.INNER, halo_fill.OUTER):
                w, reads = out[phase][0], out[phase][1]
                assert all(r == a or r not in set(w) for a, r in reads), (ix, iy, phase)
            slots = out[halo_fill.INNER][2] + out[halo_fill.OUTER][2]
            assert sorted(slots) == list(range(plan.n_saved)), (ix, iy)
            before = [f[0].clone() for f in fields]
            _, saved = halo_fill.fill_halos_group_plain(
                fields, save=True, role=role, south=recv["south"], north=recv["north"],
                phase=halo_fill.INNER, strips=recv["strips"], lows=recv["lows"])
            mid = [f[0].clone() for f in fields]
            halo_fill.fill_halos_group_plain(fields, save=True, role=role,
                                             phase=halo_fill.OUTER, west=recv["west"],
                                             east=recv["east"], saved=saved)
            flat = [f[0].numpy().reshape(-1) for f in fields]
            for i, at, slot, old, new in out[halo_fill.INNER][3] + out[halo_fill.OUTER][3]:
                assert saved[slot].item() == old and flat[i][at] == new, (ix, iy)
            halo_fill.restore_strips_group_plain(fields, saved, role=role,
                                                 phase=halo_fill.OUTER)
            assert all(torch.equal(f[0], m) for f, m in zip(fields, mid)), (ix, iy)
            halo_fill.restore_strips_group_plain(fields, saved, role=role)
            assert all(torch.equal(f[0], b) for f, b in zip(fields, before)), (ix, iy)


@pytest.mark.parametrize("role", ["bottom", "middle", "top"])
@pytest.mark.parametrize("path", ["bickley", "gyre"])
def test_wrap_then_rest_is_the_fill(path, role):
    """A y-partitioned rank's wrap (the local x-wrap of the rows between its strips)
    and then the rest of its fill, as the kernel runs them: each writes cells the
    other does not, together the cells of the whole fill, into one saved buffer;
    the result and the buffer are the one-launch fill's bits, and the restore of
    the wrap alone undoes the wrap."""
    role = {"bottom": halo_fill.BOTTOM, "middle": halo_fill.MIDDLE,
            "top": halo_fill.TOP}[role]
    fields, ext = _groups(48, 9)[path]
    geoms = tuple(halo_fill._geometry("t", *f[:2], *f[3:], role) for f in fields)
    part = halo_fill.group_plan(geoms).part_len
    r = np.random.default_rng(3)
    s, n = halo_fill.receives(role)
    recv = dict(south=torch.as_tensor(r.standard_normal(part)) if s else None,
                north=torch.as_tensor(r.standard_normal(part)) if n else None)
    _, _, addr, out = _replay(fields, ext, role, (halo_fill.WRAP, halo_fill.NO_WRAP,
                                                  halo_fill.ALL),
                              dict(recv, strips=None, west=None, east=None))
    assert sorted(out[halo_fill.WRAP][0] + out[halo_fill.NO_WRAP][0]) == \
        sorted(out[halo_fill.ALL][0])
    before = [f[0].clone() for f in fields]
    plain = [(f[0].clone(),) + f[1:] for f in fields]
    want, want_saved = halo_fill.fill_halos_group_plain(plain, save=True, role=role,
                                                        **recv)
    saved = halo_fill.wrap_halos_group(fields, role)
    wrapped = [f[0].clone() for f in fields]
    halo_fill.fill_halos_group(fields, save=True, role=role, phase=halo_fill.NO_WRAP,
                               saved=saved, **recv)
    assert all(torch.equal(f[0], w) for f, w in zip(fields, want))
    assert torch.equal(saved, want_saved)
    for f, w in zip(fields, wrapped):
        f[0].copy_(w)
    halo_fill.restore_strips_group(fields, saved, role=role, phase=halo_fill.WRAP)
    assert all(torch.equal(f[0], b) for f, b in zip(fields, before))


@pytest.mark.parametrize("path", ["bickley", "gyre"])
def test_block_pack_layout_replay(path):
    """The pack kernel's index map (csrc/halo_fill.cu:group_pack_kernel: part,
    field, element, its rectangle of the plane) gives ``pack_strips_plain``'s
    buffers, rows with the fold strip and columns, and ``pack_strips`` on the CPU is
    that plain version (no launch)."""
    fields, _ = _groups(12, 9)[path]
    role = halo_fill.block_role(1, 1, 3, 2, 36)
    geoms = tuple(halo_fill._geometry("t", *f[:2], *f[3:], role) for f in fields)
    plan = halo_fill.group_plan(geoms)
    for kind, n_parts, part_len in ((halo_fill.ROWS, 3, plan.part_len),
                                    (halo_fill.COLUMNS, 2, plan.col_len)):
        size = 2 * part_len + (plan.fold_len if kind == halo_fill.ROWS else 0)
        send = np.full(size, np.nan)
        for z in range(n_parts):
            for f, g, xoff, foff, coff in zip(fields, geoms, plan.xoff, plan.fold,
                                              plan.cols):
                K, Yb, Xb, Nx, Ny, Hx, Hy = g[:7]
                if kind == halo_fill.COLUMNS:
                    r0, c0, h, w, off = 0, (Nx if z == 0 else Hx), Yb, Hx, z * part_len + coff
                elif z < 2:
                    r0, c0, h, w, off = (Ny if z == 0 else Hy), 0, Hy, Xb, z * part_len + xoff
                else:
                    r0, c0, h, w, off = Ny - 1, Hx, Hy + 1, Nx, 2 * part_len + foff
                a = f[0].numpy().reshape(-1)
                for e in range(K * h * w):
                    k, m = divmod(e, h * w)
                    rr, cc = divmod(m, w)
                    send[off + e] = a[k * Yb * Xb + (r0 + rr) * Xb + c0 + cc]
        kernels.reset_launch_counts()
        np.testing.assert_array_equal(halo_fill.pack_strips(fields, role, kind).numpy(),
                                      send)
        np.testing.assert_array_equal(
            halo_fill.pack_strips_plain(fields, role, kind).numpy(), send)
        assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


# ----------------------------------------------------------------------------------
# blocks against the serial fill
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,mode", [((2, 2), "gather"), ((3, 2), "mirror"),
                                       ((4, 1), "mirror"), ((6, 1), "gather")])
@pytest.mark.parametrize("loc,sign", [(CC, 1), (FC, -1), (CF, -1), (FF, 1)])
def test_blocks_fill_as_the_serial_field(mesh, mode, loc, sign):
    """A field split into the blocks of a mesh, each filled through the 2-D route
    (``Spmd2D.fill`` over one ``LocalExchange``): every block holds the serial
    fill's values on all of its cells."""
    n_x, n_y = mesh
    H, nx, ny = 5, 12, 7
    Nx, Ny = n_x * nx, n_y * ny
    A = _field((2, Ny + 2 * H, Nx + 2 * H), seed=3)
    want = zipper.fill_halos(A, loc, sign, Nx, Ny, H, H)

    def fill(b):
        ix, iy, ex = b
        blk = A[:, iy * ny:iy * ny + ny + 2 * H, ix * nx:ix * nx + nx + 2 * H].clone()
        spmd2d.Spmd2D(ix, iy, n_x, n_y, Nx, ex, mode).fill([(blk, loc, sign, nx, ny, H, H)])
        return blk

    for k, blk in enumerate(_run_blocks(n_x, n_y, fill)):
        iy, ix = divmod(k, n_x)
        w = want[:, iy * ny:iy * ny + ny + 2 * H, ix * nx:ix * nx + nx + 2 * H]
        assert torch.equal(blk, w), f"block ({ix}, {iy})"


# ----------------------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "inner without strips", "inner of a lower block with strips", "outer without east",
    "outer with south", "all on a block", "wrap on a block", "inner on a y-rank",
    "strip of another length", "a missing mirror strip", "fold strip below the halo",
    "columns of a y-rank", "block narrower than its halo", "too many x-ranks",
    "blocks of another width"])
def test_block_refusals(case):
    nx, ny = 12, 9
    role = halo_fill.block_role(1, 1, 3, 2, 36)  # top
    low = halo_fill.block_role(1, 0, 3, 2, 36)   # bottom
    f = (_field((2, ny + 10, nx + 10), seed=1), CC, 1, nx, ny, 5, 5)
    geoms = (halo_fill._geometry("t", *f[:2], *f[3:], role),)
    plan = halo_fill.group_plan(geoms)
    rows, cols, fold = (_field(n, seed=2) for n in (plan.part_len, plan.col_len,
                                                    plan.fold_len))
    strips = [fold, fold, fold]
    fill = halo_fill.fill_halos_group
    calls = {
        "inner without strips": lambda: fill([f], role=role, south=rows,
                                             phase=halo_fill.INNER),
        "inner of a lower block with strips": lambda: fill(
            [f], role=low, north=rows, phase=halo_fill.INNER, strips=strips),
        "outer without east": lambda: fill([f], role=role, phase=halo_fill.OUTER,
                                           west=cols),
        "outer with south": lambda: fill([f], role=role, south=rows,
                                         phase=halo_fill.OUTER, west=cols, east=cols),
        "all on a block": lambda: fill([f], role=role, south=rows, strips=strips),
        "wrap on a block": lambda: fill([f], role=role, phase=halo_fill.WRAP),
        "inner on a y-rank": lambda: fill([f], role=halo_fill.TOP, south=rows,
                                          phase=halo_fill.INNER),
        "strip of another length": lambda: fill(
            [f], role=role, south=rows, phase=halo_fill.INNER,
            strips=[fold[:-1].clone()] * 3),
        "a missing mirror strip": lambda: fill(
            [f], role=role, south=rows, phase=halo_fill.INNER, strips=[fold, None, None]),
        "fold strip below the halo": lambda: fill(
            [(_field((2, 5 + 10, nx + 10), seed=3), CC, 1, nx, 5, 5, 5)], role=role,
            south=rows, phase=halo_fill.INNER, strips=strips),
        "columns of a y-rank": lambda: halo_fill.pack_strips([f], halo_fill.MIDDLE,
                                                             halo_fill.COLUMNS),
        "block narrower than its halo": lambda: halo_fill.pack_strips(
            [(_field((2, ny + 10, 4 + 10), seed=3), CC, 1, 4, ny, 5, 5)],
            halo_fill.block_role(1, 1, 3, 2, 12)),
        "too many x-ranks": lambda: halo_fill.pack_strips(
            [f], halo_fill.block_role(1, 1, 33, 2, 33 * nx)),
        "blocks of another width": lambda: halo_fill.pack_strips(
            [f], halo_fill.block_role(1, 1, 3, 2, 40)),
    }
    snapshot = f[0].clone()
    with pytest.raises(ValueError):
        calls[case]()
    assert torch.equal(f[0], snapshot)
