"""The shard-aware group fill (``kernels/halo_fill.py`` with a role,
``csrc/halo_fill.cu``) on the CPU.

- a replay of the CUDA kernel's index map for each role (``cell_of``,
  ``filled_value`` with the receive buffers, the block search), from the host plan,
  over the Bickley, front and gyre groups at ny > Hy + 1 and at ny = Hy: every
  written cell is written once, no thread reads a cell the launch writes, the strips
  tile the saved buffer, and the replayed fill and save are the plain version's
  bits; the restore gives the fields back;
- the pack kernel's layout replayed against ``pack_strips_plain``;
- the shards of a field, filled in their roles with their neighbours' rows, against
  the serial fill of the whole field;
- the refusals: buffers the role does not take, geometries per role.

The kernels are held against these plain versions on a card by
``tests/test_torch_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops import zipper  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC, FF  # noqa: E402

torch.set_num_threads(1)

NX = 48
ROLES = {"single": halo_fill.SINGLE, "bottom": halo_fill.BOTTOM,
         "middle": halo_fill.MIDDLE, "top": halo_fill.TOP}


def _field(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


def _groups(ny):
    """The three paths' groups on one rank of ``ny`` rows: base fields at halo 5,
    the extended η, U, V at halo ``he`` (views of one buffer): 7, or ``ny`` where
    that is less. ny = 5 is the least shard the JAX package takes with both halos 5,
    ny = 7 the least with an extended halo of 7."""
    he = min(7, ny)
    out = {}
    for name, stacks in (("bickley", [(None, FC, -1), (None, CF, -1), (None, CC, 1)]),
                         ("front", [(3, FC, -1), (3, CF, -1), (3, CC, 1), (3, CC, 1)]),
                         ("gyre", [(3, FC, -1), (3, CF, -1), (6, CC, 1)])):
        fields = []
        for i, (K, loc, sign) in enumerate(stacks):
            plane = (ny + 10, NX + 10)
            fields.append((_field(plane if K is None else (K,) + plane, seed=i), loc,
                           sign, NX, ny, 5, 5))
        ext = _field((3, ny + 2 * he, NX + 2 * he), seed=99)
        fields += [(ext[0], CC, 1, NX, ny, he, he), (ext[1], FC, -1, NX, ny, he, he),
                   (ext[2], CF, -1, NX, ny, he, he)]
        out[name] = (fields, ext)
    return out


def _receive(fields, role, seed):
    """Random receive buffers of the group's plan for the role (None where the role
    receives nothing)."""
    geoms = tuple(halo_fill._geometry("t", *f[:2], *f[3:], role) for f in fields)
    n = halo_fill.group_plan(geoms).part_len
    r = np.random.default_rng(seed)
    s, nn = halo_fill.receives(role)
    return (torch.as_tensor(r.standard_normal(n)) if s else None,
            torch.as_tensor(r.standard_normal(n)) if nn else None)


# ----------------------------------------------------------------------------------
# the kernel's index map, replayed
# ----------------------------------------------------------------------------------

def _y0_kept(Nx, Ny, Hy, fy, role):
    """csrc/halo_fill.cu:Geom::y0 and kept."""
    fold = role in (halo_fill.SINGLE, halo_fill.TOP)
    if fy or not fold:
        return Hy + Ny, 0
    return Hy + Ny - 1, Nx // 2


def _cell_of(m, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, role):
    """csrc/halo_fill.cu:cell_of, statement for statement."""
    y0, kept = _y0_kept(Nx, Ny, Hy, fy, role)
    n_south = Hy * Xb
    if m < n_south:
        return m // Xb, m % Xb
    m -= n_south
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


def _source(y, x, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, role, sign):
    """csrc/halo_fill.cu:filled_value: (the buffer it reads, the row and column
    there, the factor it applies); "a" is the field's plane, "south" and "north" the
    plane's rows in the receive buffers."""
    recv_south, recv_north = halo_fill.receives(role)
    i0 = (x + Nx if x < Hx else (x - Nx if x >= Hx + Nx else x)) - Hx
    y0, _ = _y0_kept(Nx, Ny, Hy, fy, role)
    if y < Hy:
        return ("south", y, Hx + i0, 1) if recv_south else ("a", Hy, Hx + i0, 1)
    if y < y0:
        return "a", y, Hx + i0, 1
    if recv_north:
        return "north", y - y0, Hx + i0, 1
    mir = (Nx - i0) % Nx if fx else Nx - 1 - i0
    s = abs(sign) if (fx and i0 == 0) else sign
    r = y - y0
    if not fy and r == 0:
        if i0 < Nx // 2:
            return "a", y0, Hx + i0, 1
        return "a", y0, Hx + mir, s
    src = (y0 - 1 - r) if fy else (y0 - r)
    if src < Hy:
        return "south", src, Hx + mir, s
    return "a", src, Hx + mir, s


def _expected_writes(geom):
    """Every cell a fill writes, from the geometry and role alone: the halo, and for
    a center-y fold (single, top) the redundant half of row Ny."""
    K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, role = geom
    m = np.ones((Yb, Xb), bool)
    m[Hy:Hy + Ny, Hx:Hx + Nx] = False
    if not fy and role in (halo_fill.SINGLE, halo_fill.TOP):
        m[Hy + Ny - 1, Hx + Nx // 2:Hx + Nx] = True
    return np.flatnonzero(m)


@pytest.mark.parametrize("role,ny", [(r, ny) for r in ("bottom", "middle", "top")
                                     for ny in (5, 7, 12)] + [("single", 12)])
@pytest.mark.parametrize("path", ["bickley", "front", "gyre"])
def test_kernel_index_map_replay(path, role, ny):
    """Every thread of the group launch in a role, as the kernel runs it: each
    written cell is visited exactly once; no thread reads a cell that any thread of
    the launch writes (its own cell aside); the strip offsets tile the saved buffer;
    the replayed fill and save are the plain version's bits; the plain restore gives
    the fields back."""
    role = ROLES[role]
    fields, ext = _groups(ny)[path]
    south, north = _receive(fields, role, seed=ny)
    geoms = tuple(halo_fill._geometry("t", *f[:2], *f[3:], role) for f in fields)
    plan = halo_fill.group_plan(geoms)
    # element addresses: each stack its own allocation, the extended planes views of
    # one buffer back to back, then the two receive buffers
    addr, top, ext_at = [], 0, None
    for A, *_ in fields:
        if A.untyped_storage().data_ptr() == ext.untyped_storage().data_ptr():
            if ext_at is None:
                ext_at, top = top, top + ext.numel() + 1000
            addr.append(ext_at + A.storage_offset())
        else:
            addr.append(top)
            top += A.numel() + 1000
    base = {"south": top, "north": top + plan.part_len + 1000}

    writes, reads, slots, replayed = [], [], [], []
    bufs = {"south": None if south is None else south.numpy(),
            "north": None if north is None else north.numpy()}
    for b in range(plan.blocks):
        i = 0
        for j in range(1, len(fields)):
            if b >= plan.block0[j]:
                i = j
        K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, rl = geoms[i]
        n = plan.cells[i]
        old = fields[i][0].numpy().reshape(-1)
        for th in range(halo_fill.THREADS):
            t = (b - plan.block0[i]) * halo_fill.THREADS + th
            if t >= K * n:
                continue
            k = t // n
            y, x = _cell_of(t - k * n, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, rl)
            buf, sy, sx, s = _source(y, x, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, rl,
                                     fields[i][2])
            at = k * Yb * Xb + y * Xb + x
            if buf == "a":
                src_addr = addr[i] + k * Yb * Xb + sy * Xb + sx
                value = old[k * Yb * Xb + sy * Xb + sx]
            else:
                off = plan.xoff[i] + k * Hy * Xb + sy * Xb + sx
                src_addr, value = base[buf] + off, bufs[buf][off]
            writes.append(addr[i] + at)
            reads.append((addr[i] + at, src_addr))
            slots.append(plan.strip[i] + t)
            replayed.append((i, at, plan.strip[i] + t, old[at], s * value))

    expect = [addr[i] + k * g[1] * g[2] + c for i, g in enumerate(geoms)
              for k in range(g[0]) for c in _expected_writes(g)]
    assert sorted(writes) == sorted(expect)
    assert len(set(writes)) == len(writes)
    written = set(writes)
    assert all(r == w or r not in written for w, r in reads)
    assert sorted(slots) == list(range(plan.n_saved))
    before = [f[0].clone() for f in fields]
    _, saved = halo_fill.fill_halos_group_plain(fields, save=True, role=role,
                                                south=south, north=north)
    flat = [f[0].numpy().reshape(-1) for f in fields]
    for i, at, slot, old, new in replayed:
        assert saved[slot].item() == old and flat[i][at] == new
    halo_fill.restore_strips_group_plain(fields, saved, role=role)
    assert all(torch.equal(f[0], b) for f, b in zip(fields, before))


@pytest.mark.parametrize("ny", [5, 12])
@pytest.mark.parametrize("path", ["bickley", "gyre"])
def test_pack_layout_replay(path, ny):
    """The pack kernel's index map (csrc/halo_fill.cu:group_pack_kernel: part, field,
    element) gives ``pack_strips_plain``'s buffer, and ``pack_strips`` on the CPU is
    that plain version (no launch)."""
    fields, _ = _groups(ny)[path]
    role = halo_fill.MIDDLE
    geoms = tuple(halo_fill._geometry("t", *f[:2], *f[3:], role) for f in fields)
    plan = halo_fill.group_plan(geoms)
    send = np.full(2 * plan.part_len, np.nan)
    for part in (0, 1):
        for f, g, xoff in zip(fields, geoms, plan.xoff):
            K, Yb, Xb, Ny, Hy = g[0], g[1], g[2], g[4], g[6]
            a = f[0].numpy().reshape(-1)
            strip = Hy * Xb
            row0 = (Ny if part == 0 else Hy) * Xb
            for e in range(K * strip):
                k = e // strip
                send[part * plan.part_len + xoff + e] = a[k * Yb * Xb + row0 + e - k * strip]
    kernels.reset_launch_counts()
    got = halo_fill.pack_strips(fields, role)
    np.testing.assert_array_equal(got.numpy(), send)
    np.testing.assert_array_equal(halo_fill.pack_strips_plain(fields, role).numpy(), send)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


# ----------------------------------------------------------------------------------
# shards against the serial fill
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("n,ny", [(2, 12), (4, 5), (3, 6)])
@pytest.mark.parametrize("loc,sign", [(CC, 1), (FC, -1), (CF, -1), (FF, 1)])
def test_shards_fill_as_the_serial_field(n, ny, loc, sign):
    """A field split into ``n`` ranks, each filled in its role with the rows its
    neighbours pack: every shard holds the serial fill's values at its rows, but
    where a shard's north halo reaches row Ny of the last rank (ny = Hy), which it
    receives before the fold rewrites its redundant half, as in the JAX package."""
    H = 5
    Ny = n * ny
    A = _field((2, Ny + 2 * H, NX + 2 * H), seed=3)
    want = zipper.fill_halos(A, loc, sign, NX, Ny, H, H)
    shards = [A[:, k * ny:k * ny + ny + 2 * H].clone() for k in range(n)]
    roles = [halo_fill.role_of(k, n) for k in range(n)]
    sends = [halo_fill.pack_strips([(s, loc, sign, NX, ny, H, H)], r)
             for s, r in zip(shards, roles)]
    part = sends[0].numel() // 2
    for k, (s, r) in enumerate(zip(shards, roles)):
        south = sends[k - 1][:part] if k > 0 else None
        north = sends[k + 1][part:] if k + 1 < n else None
        halo_fill.fill_halos_group([(s, loc, sign, NX, ny, H, H)], role=r, south=south,
                                   north=north)
    row_ny = H + Ny - 1  # row Ny in the halo-inclusive rows
    for k, s in enumerate(shards):
        w = want[:, k * ny:k * ny + ny + 2 * H].clone()
        if k < n - 1 and k * ny <= row_ny < k * ny + ny + 2 * H:
            w[:, row_ny - k * ny] = zipper.wrap_x(A[:, row_ny:row_ny + 1].clone(), NX,
                                                  H)[:, 0]
        assert torch.equal(s, w), f"shard {k}"


# ----------------------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["middle without north", "bottom with south",
                                  "top with north", "single with south",
                                  "buffer of another length", "shard below its halo",
                                  "single at ny = Hy + 1", "pack of a single field"])
def test_shard_refusals(case):
    f = (_field((2, 12 + 10, NX + 10), seed=1), CC, 1, NX, 12, 5, 5)
    buf = _field(2 * 5 * (NX + 10), seed=2)
    calls = {
        "middle without north": lambda: halo_fill.fill_halos_group(
            [f], role=halo_fill.MIDDLE, south=buf),
        "bottom with south": lambda: halo_fill.fill_halos_group(
            [f], role=halo_fill.BOTTOM, south=buf, north=buf),
        "top with north": lambda: halo_fill.fill_halos_group(
            [f], role=halo_fill.TOP, south=buf, north=buf),
        "single with south": lambda: halo_fill.fill_halos_group([f], south=buf),
        "buffer of another length": lambda: halo_fill.fill_halos_group(
            [f], role=halo_fill.TOP, south=buf[:-1].clone()),
        "shard below its halo": lambda: halo_fill.fill_halos_group(
            [(_field((4 + 10, NX + 10), seed=3), CC, 1, NX, 4, 5, 5)],
            role=halo_fill.MIDDLE, south=buf[:5 * (NX + 10)].clone(),
            north=buf[:5 * (NX + 10)].clone()),
        "single at ny = Hy + 1": lambda: halo_fill.fill_halos_group(
            [(_field((6 + 10, NX + 10), seed=3), CC, 1, NX, 6, 5, 5)]),
        "pack of a single field": lambda: halo_fill.pack_strips([f], halo_fill.SINGLE),
    }
    snapshot = f[0].clone()
    with pytest.raises(ValueError):
        calls[case]()
    assert torch.equal(f[0], snapshot)
