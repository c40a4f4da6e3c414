"""The group halo fill with save and the group restore (``kernels/halo_fill.py``):
their plain versions against the JAX package's ``fill_halos_pallas(save=True)`` and
``restore_strips_pallas`` in interpret mode, bitwise; a replay of the CUDA kernel's
index map (``csrc/halo_fill.cu:cell_of``, ``filled_value`` and the block search)
from the shared host plan over the Bickley, front and gyre groups; and the
wrappers' refusals. The kernels themselves are held against the plain versions on
a card by ``tests/test_torch_cuda.py``.

Sizes: 48 x 40 planes at halo 5 (base) and 22 (extended), K <= 3 (6 for the gyre's
two tracers).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC, FF  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_fill import (  # noqa: E402
    extract_strips, fill_halos_pallas, restore_strips_pallas)
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops import zipper  # noqa: E402

torch.set_num_threads(1)

NX, NY = 48, 40
LOCS = [(CC, 1), (FC, -1), (CF, -1), (FF, 1), (CC, -1), (FC, 1), (CF, 1), (FF, -1)]


def _field(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


def _plane(H):
    return (NY + 2 * H, NX + 2 * H)


# ----------------------------------------------------------------------------------
# against the Pallas pair in interpret mode
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("H", [5, 22])
@pytest.mark.parametrize("loc,sign", LOCS)
def test_group_fill_save_matches_pallas(H, loc, sign):
    """Filled fields bitwise; the saved buffer holds, cell for cell, what the Pallas
    fill's saved strips hold at the cells the fill writes."""
    A = _field((2,) + _plane(H), seed=H)
    A0 = A.numpy().copy()
    want, strips = fill_halos_pallas(jnp.asarray(A0), loc, sign, NX, NY, H, H,
                                     interpret=True, save=True)
    (got,), saved = halo_fill.fill_halos_group_plain([(A, loc, sign, NX, NY, H, H)],
                                                     save=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the Pallas strips put back where they came from
    south, fold, west, east = (np.asarray(s) for s in strips)
    pre = np.full(A0.shape, np.nan)
    y0 = A0.shape[1] - fold.shape[1]
    pre[:, :H] = south
    pre[:, y0:] = fold
    pre[:, H:y0, :H] = west
    pre[:, H:y0, -H:] = east
    y, x = halo_fill.plane_cells(*halo_fill._geometry("t", A, loc, NX, NY, H, H)[1:])
    np.testing.assert_array_equal(saved.numpy(), pre[:, y, x].reshape(-1))
    # extract_strips covers the same regions
    for s, e in zip(strips, extract_strips(jnp.asarray(A0), loc, NX, NY, H, H)):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(e))


@pytest.mark.parametrize("H", [5, 22])
@pytest.mark.parametrize("loc,sign", LOCS[:4])
def test_group_restore_matches_pallas(H, loc, sign):
    """``restore_strips_pallas`` and the port's restore both give the input back,
    bitwise, from the filled field."""
    A = _field((3,) + _plane(H), seed=10 + H)
    A0 = A.numpy().copy()
    filled, strips = fill_halos_pallas(jnp.asarray(A0), loc, sign, NX, NY, H, H,
                                       interpret=True, save=True)
    back = restore_strips_pallas(filled, strips, loc, NX, NY, H, H, interpret=True)
    np.testing.assert_array_equal(np.asarray(back), A0)
    field = (A, loc, sign, NX, NY, H, H)
    _, saved = halo_fill.fill_halos_group([field], save=True)
    np.testing.assert_array_equal(A.numpy(), np.asarray(filled))
    halo_fill.restore_strips_group([field], saved)
    np.testing.assert_array_equal(A.numpy(), A0)


def _groups():
    """The three paths' fill groups at small geometry: {path: (fields, the extended
    buffer)}. η, U and V are views of one (3, Ye, Xe) buffer, as the barotropic
    kernel returns them."""
    out = {}
    for name, stacks in (("bickley", [(None, FC, -1), (None, CF, -1), (None, CC, 1)]),
                         ("front", [(3, FC, -1), (3, CF, -1), (3, CC, 1), (3, CC, 1)]),
                         ("gyre", [(3, FC, -1), (3, CF, -1), (6, CC, 1)])):
        fields = []
        for i, (K, loc, sign) in enumerate(stacks):
            shape = _plane(5) if K is None else (K,) + _plane(5)
            fields.append((_field(shape, seed=i), loc, sign, NX, NY, 5, 5))
        ext = _field((3,) + _plane(22), seed=99)
        fields += [(ext[0], CC, 1, NX, NY, 22, 22), (ext[1], FC, -1, NX, NY, 22, 22),
                   (ext[2], CF, -1, NX, NY, 22, 22)]
        out[name] = (fields, ext)
    return out


@pytest.mark.parametrize("path", ["bickley", "front", "gyre"])
def test_group_of_a_path_fills_and_restores(path):
    """One group fill equals the per-field fills; the restore gives every field back."""
    fields, _ = _groups()[path]
    before = [f[0].clone() for f in fields]
    want = [zipper.fill_halos(f[0].clone(), *f[1:], inplace=True) for f in fields]
    kernels.reset_launch_counts()
    got, saved = halo_fill.fill_halos_group(fields, save=True)
    for g, w, f in zip(got, want, fields):
        assert g is f[0] and torch.equal(g, w)
    assert saved.numel() == halo_fill.group_plan(
        tuple(halo_fill._geometry("t", *f[:2], *f[3:]) for f in fields)).n_saved
    halo_fill.restore_strips_group(fields, saved)
    for f, b in zip(fields, before):
        assert torch.equal(f[0], b)
    # without save, the same fill and no buffer
    got, none = halo_fill.fill_halos_group(fields)
    assert none is None and all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}  # plain route


# ----------------------------------------------------------------------------------
# a replay of the kernel's index map from the host plan
# ----------------------------------------------------------------------------------

def _cell_of(m, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy):
    """csrc/halo_fill.cu:cell_of, statement for statement."""
    y0 = Hy + Ny if fy else Hy + Ny - 1
    n_south = Hy * Xb
    if m < n_south:
        return m // Xb, m % Xb
    m -= n_south
    kept = 0 if fy else Nx // 2
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


def _source(y, x, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, sign):
    """csrc/halo_fill.cu:filled_value: (the cell it reads, the factor it applies)."""
    i0 = (x + Nx if x < Hx else (x - Nx if x >= Hx + Nx else x)) - Hx
    y0 = Hy + Ny if fy else Hy + Ny - 1
    if y < Hy:
        return (Hy, Hx + i0), 1
    if y < y0:
        return (y, Hx + i0), 1
    mir = (Nx - i0) % Nx if fx else Nx - 1 - i0
    s = abs(sign) if (fx and i0 == 0) else sign
    r = y - y0
    if not fy and r == 0:
        if i0 < Nx // 2:
            return (y0, Hx + i0), 1
        return (y0, Hx + mir), s
    return ((y0 - 1 - r) if fy else (y0 - r), Hx + mir), s


@pytest.mark.parametrize("path", ["bickley", "front", "gyre"])
def test_kernel_index_map_replay(path):
    """Every thread of the group launch, as the kernel runs it: every written cell is
    visited exactly once; no thread reads a cell that any thread of the launch
    writes (its own cell aside), across fields; the strip offsets tile the saved
    buffer exactly; and the replayed fill and save are the plain version's bits."""
    fields, ext = _groups()[path]
    geoms = tuple(halo_fill._geometry("t", *f[:2], *f[3:]) for f in fields)
    plan = halo_fill.group_plan(geoms)
    # element addresses: each stack its own allocation, the extended planes views of
    # one buffer, back to back
    addr, top, ext_at = [], 0, None
    for A, *_ in fields:
        if A.untyped_storage().data_ptr() == ext.untyped_storage().data_ptr():
            if ext_at is None:
                ext_at, top = top, top + ext.numel() + 1000
            addr.append(ext_at + A.storage_offset())
        else:
            addr.append(top)
            top += A.numel() + 1000

    writes, reads, slots, replayed = [], [], [], []
    for b in range(plan.blocks):
        i = 0
        for j in range(1, len(fields)):
            if b >= plan.block0[j]:
                i = j
        K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, _ = geoms[i]
        n = plan.cells[i]
        old = fields[i][0].numpy().reshape(-1)
        for th in range(halo_fill.THREADS):
            t = (b - plan.block0[i]) * halo_fill.THREADS + th
            if t >= K * n:
                continue
            k = t // n
            y, x = _cell_of(t - k * n, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy)
            (sy, sx), s = _source(y, x, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, fields[i][2])
            at, src = k * Yb * Xb + y * Xb + x, k * Yb * Xb + sy * Xb + sx
            writes.append(addr[i] + at)
            reads.append((addr[i] + at, addr[i] + src))
            slots.append(plan.strip[i] + t)
            replayed.append((i, at, plan.strip[i] + t, old[at], s * old[src]))

    # every cell a fill writes, from the geometry alone: the halo, and for a center-y
    # field the redundant half of row Ny (the columns i0 >= Nx/2)
    expect = []
    for i, (K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, _) in enumerate(geoms):
        m = np.ones((Yb, Xb), bool)
        m[Hy:Hy + Ny, Hx:Hx + Nx] = False
        if not fy:
            m[Hy + Ny - 1, Hx + Nx // 2:Hx + Nx] = True
        cells = np.flatnonzero(m)
        expect += [addr[i] + k * Yb * Xb + c for k in range(K) for c in cells]
    assert sorted(writes) == sorted(expect)
    assert len(set(writes)) == len(writes)
    written = set(writes)
    assert all(r == w or r not in written for w, r in reads)
    assert sorted(slots) == list(range(plan.n_saved))
    # the replayed save and fill are the plain version's bits
    before = [f[0].clone() for f in fields]
    _, saved = halo_fill.fill_halos_group_plain(fields, save=True)
    flat = [f[0].numpy().reshape(-1) for f in fields]
    for i, at, slot, old, new in replayed:
        assert saved[slot].item() == old and flat[i][at] == new
    halo_fill.restore_strips_group_plain(fields, saved)
    assert all(torch.equal(f[0], b) for f, b in zip(fields, before))


def test_plan_lays_fields_out_in_order():
    geoms = ((3,) + _plane(5) + (NX, NY, 5, 5, 1, 0),
             (1,) + _plane(22) + (NX, NY, 22, 22, 0, 0),
             (2,) + _plane(5) + (NX, NY, 5, 5, 0, 1))
    plan = halo_fill.group_plan(geoms)
    cells = [halo_fill.plane_cells(*g[1:])[0].size for g in geoms]
    assert list(plan.cells) == cells
    assert plan.strip == (0, 3 * cells[0], 3 * cells[0] + cells[1])
    assert plan.n_saved == 3 * cells[0] + cells[1] + 2 * cells[2]
    blocks = [-(-g[0] * n // halo_fill.THREADS) for g, n in zip(geoms, cells)]
    assert plan.block0 == (0, blocks[0], blocks[0] + blocks[1])
    assert plan.blocks == sum(blocks)
    # center-y: row Ny keeps Nx/2 cells; face-y keeps none
    H, (Yb, Xb) = 5, _plane(5)
    assert cells[0] == 2 * H * Xb + Xb - NX // 2 + (NY - 1) * 2 * H
    assert cells[2] == 2 * H * Xb + NY * 2 * H


# ----------------------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------------------

def _refusal(case):
    A = _field((3,) + _plane(5), seed=1)
    f = (A, CC, 1, NX, NY, 5, 5)
    if case == "overlap":
        buf = _field((4,) + _plane(5), seed=2)
        return halo_fill.fill_halos_group, ([(buf[0:2], CC, 1, NX, NY, 5, 5),
                                             (buf[1:3], FC, -1, NX, NY, 5, 5)],)
    if case == "same tensor twice":
        return halo_fill.fill_halos_group, ([f, (A, FC, -1, NX, NY, 5, 5)],)
    if case == "non-contiguous":
        B = _field((3, NX + 10, NY + 10), seed=3).transpose(1, 2)
        return halo_fill.fill_halos_group, ([f, (B, CC, 1, NX, NY, 5, 5)],)
    if case == "mixed dtypes":
        return halo_fill.fill_halos_group, ([f, (A[0].float().clone(), CC, 1, NX, NY,
                                                 5, 5)],)
    if case == "nine fields":
        return halo_fill.fill_halos_group, ([(_field(_plane(5), seed=i), CC, 1, NX, NY,
                                              5, 5) for i in range(9)],)
    if case == "saved of the wrong size":
        _, saved = halo_fill.fill_halos_group([f], save=True)
        return halo_fill.restore_strips_group, ([f], saved[:-1].clone())
    if case == "saved of another group":
        _, saved = halo_fill.fill_halos_group([f], save=True)
        return halo_fill.restore_strips_group, ([(A[:2], CC, 1, NX, NY, 5, 5)], saved)
    if case == "no saved buffer":
        return halo_fill.restore_strips_group, ([f], None)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["overlap", "same tensor twice", "non-contiguous",
                                  "mixed dtypes", "nine fields", "saved of the wrong size",
                                  "saved of another group", "no saved buffer"])
def test_group_refusals(case):
    fn, args = _refusal(case)
    snapshot = [f[0].clone() for f in args[0]]
    with pytest.raises((ValueError, TypeError)):
        fn(*args)
    # a refused call writes nothing
    assert all(torch.equal(f[0], s) for f, s in zip(args[0], snapshot))


def test_group_refuses_a_geometry_the_kernel_would_race_on():
    A = torch.zeros(_plane(5), dtype=torch.float64)
    with pytest.raises(ValueError):  # 2*Hx >= Nx
        halo_fill.fill_halos_group([(torch.zeros(NY + 50, NX + 48, dtype=torch.float64),
                                     CC, 1, NX, NY, 24, 25)])
    with pytest.raises(ValueError):  # wrong plane shape
        halo_fill.fill_halos_group([(A, CC, 1, NX, NY, 4, 5)])
