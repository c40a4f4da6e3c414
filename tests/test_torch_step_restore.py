"""The steps fill the incoming state's halos in place and restore the saved strips
before they return (``models/hydrostatic.py:step``, ``models/layered.py:layered_step``):

- a 3-step run whose state holds η, U and V as views of one buffer (as the barotropic
  kernel returns them) leaves each incoming state bitwise as it was;
- a step that raises mid-way (a forcing function's ``ValueError``, after the fill)
  leaves the state bitwise as it was;
- the steps are bitwise equal, at float64 on the CPU, to the route they replace:
  every prognostic field filled out of place, into a clone (``ops/zipper.fill_halos``),
  with the unfilled state read by the corrector.

Small sizes: 48 x 40 (x 3 layers) grids.
"""

import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch.kernels import corrector  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops import zipper  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC  # noqa: E402

torch.set_num_threads(1)


def _build(path, **kw):
    if path == "bickley":
        from examples.bickley_jet_torch import build

        return build(48, 40, dtype=torch.float64, substeps=12, device="cpu", **kw)
    if path == "front":
        from examples.baroclinic_front_torch import build

        return build(48, 40, 3, dtype=torch.float64, substeps=12, device="cpu")
    from examples.wind_driven_ts_gyre_torch import build

    return build(48, 40, 3, dtype=torch.float64, substeps=12, device="cpu", **kw)


def _step(path):
    return TH.step if path == "bickley" else TL.layered_step


def _snapshot(state):
    return {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}


def _assert_same(state, snap, what):
    for name, want in snap.items():
        assert torch.equal(getattr(state, name), want), f"{what}: state.{name} changed"


def _one_buffer(state):
    """``state`` with η, U and V moved into views of one (3, Ye, Xe) buffer."""
    buf = torch.stack([state.eta, state.U, state.V])
    return dataclasses.replace(state, eta=buf[0], U=buf[1], V=buf[2])


@pytest.mark.parametrize("path", ["bickley", "front", "gyre"])
def test_state_with_one_free_surface_buffer_is_unchanged(path):
    model, state = _build(path)
    step = _step(path)
    state = _one_buffer(state)
    for i in range(3):
        snap = _snapshot(state)
        new = step(model, state, 120.0)
        _assert_same(state, snap, f"step {i}")
        state = _one_buffer(new)
    assert all(bool(torch.isfinite(getattr(state, n)).all()) for n in ("u", "v", "eta"))


@pytest.mark.parametrize("path", ["bickley", "gyre"])
@pytest.mark.parametrize("target", ["u", "v"])
def test_step_that_raises_leaves_the_state_as_it_was(path, target):
    def boom(*args):
        raise ValueError("forcing failed")

    model, state = _build(path, forcing={target: boom})
    state = _one_buffer(state)
    snap = _snapshot(state)
    with pytest.raises(ValueError, match="forcing failed"):
        _step(path)(model, state, 120.0)
    _assert_same(state, snap, "raised step")


# ----------------------------------------------------------------------------------
# the route the steps replace: every prognostic field filled into a clone
# ----------------------------------------------------------------------------------

def _fill_clone(grid, A, loc, sign):
    return zipper.fill_halos(A.clone(), loc, sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy,
                             inplace=True)


def _fill_own(grid, A, loc, sign):
    return zipper.fill_halos(A, loc, sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy,
                             inplace=True)


def _step_on_clones(model, state, dt):
    g, ge, ib = model.grid, model.grid_ext, model.ib
    dt = torch.full((), float(dt), dtype=model.dtype, device=model.device)
    u = _fill_clone(g, state.u, FC, -1)
    v = _fill_clone(g, state.v, CF, -1)
    c = _fill_clone(g, state.c, CC, 1)
    eta_f = _fill_clone(ge, state.eta, CC, 1)
    U_f = _fill_clone(ge, state.U, FC, -1)
    V_f = _fill_clone(ge, state.V, CF, -1)
    first = state.iteration == 0
    w1 = torch.where(first, model.ab2[0], model.ab2[2])
    w2 = torch.where(first, model.ab2[1], model.ab2[3])
    Gu, Gv, Gc = TH.tendencies(model, u, v, c, t=state.t)
    Gu_s = w1 * Gu - w2 * state.Gu
    Gv_s = w1 * Gv - w2 * state.Gv
    Gc_s = w1 * Gc - w2 * state.Gc
    c_new = (state.c + dt * Gc_s) * ib.mask_c
    GU_f = _fill_own(ge, TH.embed_ext(g, ge, ib.h_u * Gu_s), FC, -1)
    GV_f = _fill_own(ge, TH.embed_ext(g, ge, ib.h_v * Gv_s), CF, -1)
    n_sub = model.weights.shape[0]
    eta_a, U_a, V_a = TH.barotropic_substeps(model, eta_f, U_f, V_f, GU_f, GV_f, dt,
                                             wrap_x_each_substep=ge.Hx < n_sub + 1)
    u_new = TH.crop_ext(g, ge, U_a) * model.inv_h_u * ib.mask_u
    v_new = TH.crop_ext(g, ge, V_a) * model.inv_h_v * ib.mask_v
    return TH.State(u=u_new, v=v_new, eta=eta_a, U=U_a, V=V_a, c=c_new, Gu=Gu, Gv=Gv,
                    Gc=Gc, t=state.t + dt, iteration=state.iteration + 1)


def _layered_step_on_clones(model, state, dt):
    g, ge, m = model.grid, model.grid_ext, model.baro
    dt = torch.full((), float(dt), dtype=model.dtype, device=model.device)
    u = _fill_clone(g, state.u, FC, -1)
    v = _fill_clone(g, state.v, CF, -1)
    c = _fill_clone(g, state.c, CC, 1)
    b = _fill_clone(g, state.b, CC, 1) if model.has_b else state.b
    eta_f = _fill_clone(ge, state.eta, CC, 1)
    U_f = _fill_clone(ge, state.U, FC, -1)
    V_f = _fill_clone(ge, state.V, CF, -1)
    Gu, Gv, Gc, Gb = TL.layered_tendencies(model, u, v, c, b, t=state.t)
    first = state.iteration == 0
    w1 = torch.where(first, m.ab2[0], m.ab2[2])
    w2 = torch.where(first, m.ab2[1], m.ab2[3])
    Gu_s = w1 * Gu - w2 * state.Gu
    Gv_s = w1 * Gv - w2 * state.Gv
    GU_f = _fill_own(ge, TH.embed_ext(g, ge, torch.sum(Gu_s * model.dzu, dim=0)), FC, -1)
    GV_f = _fill_own(ge, TH.embed_ext(g, ge, torch.sum(Gv_s * model.dzv, dim=0)), CF, -1)
    n_sub = m.weights.shape[0]
    eta_a, U_a, V_a = TH.barotropic_substeps(m, eta_f, U_f, V_f, GU_f, GV_f, dt,
                                             wrap_x_each_substep=ge.Hx < n_sub + 1)
    if model.vert_impl and (model.nu_v > 0.0 or model.kappa_v > 0.0):
        u_new, v_new, c_new, b_new = TL._implicit_update(model, state, Gu, Gv, Gc, Gb,
                                                         U_a, V_a, w1, w2, dt)
    else:
        u_new, v_new, c_new, b_new = corrector.corrector(
            state.u, Gu, state.Gu, state.v, Gv, state.Gv, state.c, Gc, state.Gc,
            model.dzu, model.dzv, model.mask_c3, model.inv_h_u, model.inv_h_v,
            TH.crop_ext(g, ge, U_a), TH.crop_ext(g, ge, V_a), w1, w2, dt,
            b=(state.b, Gb, state.Gb) if model.has_b else None)
        if not model.has_b:
            b_new = state.b
    return TL.LayeredState(
        u=u_new, v=v_new, eta=eta_a, U=U_a, V=V_a, c=c_new, b=b_new, Gu=Gu, Gv=Gv, Gc=Gc,
        Gb=Gb if model.has_b else state.Gb, t=state.t + dt,
        iteration=state.iteration + 1)


@pytest.mark.parametrize("path", ["bickley", "front", "gyre"])
def test_steps_bitwise_equal_to_the_route_on_clones(path):
    model, state = _build(path)
    on_clones = _step_on_clones if path == "bickley" else _layered_step_on_clones
    want, got = state, state
    for _ in range(3):
        want = on_clones(model, want, 120.0)
        got = _step(path)(model, got, 120.0)
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
