"""The PyTorch port's single-layer model against the JAX package at float64.

- make_model / initial_state: the port's arrays equal the JAX model's;
- step / multi_step: the port's plain path, built from the JAX model's own arrays
  (``from_jax_arrays``) so that step parity is tested apart from grid generation,
  against the jitted JAX step; XLA:CPU contracts multiply-adds where the port's
  eager PyTorch does not, so the band is rtol 1e-12 on the interior;
- the Bickley trajectory oracle (tests/data/bickley_oracle_180x90.npz) re-run through
  the port with ``tests/test_parity.py``'s tolerances.
"""

import dataclasses
import os
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from examples.bickley_jet import build as jax_build  # noqa: E402
from examples.bickley_jet_torch import build as torch_build  # noqa: E402
from examples.bickley_jet_torch import diagnostics  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.grids.tripolar import META_FIELDS  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(ROOT, "tests", "data")


def jax_model_numpy(jm):
    """(arrays, meta) of a JAX HydrostaticModel in ``from_jax_arrays``'s layout."""
    arrays = {}
    for f in JH._MODEL_ARRAYS:
        leaf = getattr(jm, f)
        if dataclasses.is_dataclass(leaf):
            for sf in dataclasses.fields(leaf):
                val = getattr(leaf, sf.name)
                if hasattr(val, "shape"):
                    arrays[f"{f}.{sf.name}"] = np.asarray(val)
        else:
            arrays[f] = np.asarray(leaf)
    meta = {k: getattr(jm, k) for k in JH._MODEL_META}
    for gname in ("grid", "grid_ext"):
        g = getattr(jm, gname)
        meta[gname] = {k: getattr(g, k) for k in META_FIELDS}
    return arrays, meta


def jax_state_numpy(js):
    return {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}


@pytest.fixture(scope="module")
def pair():
    """A 48 x 40 float64 Bickley jet (substeps 30: 21 weights, halo-22 free
    surface grid) as a JAX model and as the port's model built from its arrays."""
    jm, js = jax_build(nx=48, ny=40, dtype=jax.numpy.float64, substeps=30)
    arrays, meta = jax_model_numpy(jm)
    tm = TH.from_jax_arrays(arrays, meta, device="cpu")
    ts = TH.state_from_numpy(jax_state_numpy(js), device="cpu")
    return jm, js, tm, ts


def _interior(grid, a):
    return np.asarray(a)[..., grid.Hy:grid.Hy + grid.Ny, grid.Hx:grid.Hx + grid.Nx]


def _assert_states_close(jm, jout, tout, rtol):
    g, ge = jm.grid, jm.grid_ext
    for name in ("u", "v", "c", "Gu", "Gv", "Gc"):
        want = _interior(g, getattr(jout, name))
        got = _interior(g, getattr(tout, name).numpy())
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max(), err_msg=name)
    for name in ("eta", "U", "V"):
        want = _interior(ge, getattr(jout, name))
        got = _interior(ge, getattr(tout, name).numpy())
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max(), err_msg=name)
    assert float(tout.t) == pytest.approx(float(jout.t), rel=1e-15)
    assert int(tout.iteration) == int(jout.iteration)


def test_make_model_and_initial_state_exact():
    """The port's own make_model/initial_state give the JAX model's arrays."""
    jm, js = jax_build(nx=48, ny=40, dtype=jax.numpy.float64, substeps=30)
    tm, ts = torch_build(nx=48, ny=40, dtype=torch.float64, substeps=30, device="cpu")
    arrays, _ = jax_model_numpy(jm)
    for name in TH.DERIVED:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), arrays[name],
                                      err_msg=name)
    for sub in ("grid", "grid_ext", "ib"):
        for name, buf in getattr(tm, sub).named_buffers():
            np.testing.assert_array_equal(buf.numpy(), arrays[f"{sub}.{name}"],
                                          err_msg=f"{sub}.{name}")
    assert tm.grid_ext.halo[:2] == (22, 22)
    for name, want in jax_state_numpy(js).items():
        np.testing.assert_array_equal(getattr(ts, name).numpy(), want, err_msg=name)


@pytest.mark.parametrize("n_steps", [1, 5])
def test_step_matches_jax(pair, n_steps):
    jm, js, tm, ts = pair
    jout = jax.jit(partial(JH.multi_step, n_steps=n_steps))(jm, js, 120.0)
    before = {k: v.clone() for k, v in dataclasses.asdict(ts).items()}
    tout = TH.multi_step(tm, ts, 120.0, n_steps)
    _assert_states_close(jm, jout, tout, rtol=1e-12)
    for k, v in before.items():
        assert torch.equal(getattr(ts, k), v), f"step mutated state.{k}"


def test_tendencies_and_cfl_match_jax(pair):
    jm, js, tm, ts = pair
    g = jm.grid
    from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC

    u, v, c = (JH._fill(g, a, loc, s) for a, loc, s in
               ((js.u, FC, -1), (js.v, CF, -1), (js.c, CC, 1)))
    want = JH.tendencies(jm, u, v, c)
    got = TH.tendencies(tm, *(torch.from_numpy(np.array(a)) for a in (u, v, c)))
    for name, w, t in zip(("Gu", "Gv", "Gc"), want, got):
        w = _interior(g, w)
        np.testing.assert_allclose(_interior(g, t.numpy()), w, rtol=1e-13,
                                   atol=1e-13 * np.abs(w).max(), err_msg=name)
    assert float(TH.compute_cfl_dt(tm, ts)) == pytest.approx(
        float(JH.compute_cfl_dt(jm, js)), rel=1e-14)


def test_bickley_oracle_through_port():
    """20 steps of the 180 x 90 Bickley jet at float64 through the port's plain
    path reproduce the committed trajectory oracle (tests/test_parity.py:164-171)."""
    with np.load(os.path.join(DATA, "bickley_oracle_180x90.npz")) as data:
        nx, ny, dt, n_steps, every = data["meta"]
        ref = {k: data[k] for k in ("u.020", "v.020", "c.020", "eta.020")}
        ke_ref, ens_ref, cvar_ref = (data[k][:20] for k in ("ke", "ens", "cvar"))
    model, s = torch_build(int(nx), int(ny), dtype=torch.float64, device="cpu")
    ke, ens, cvar = [], [], []
    for _ in range(20):
        s = TH.step(model, s, float(dt))
        k_, e_, c_ = diagnostics(model, s)
        ke.append(k_)
        ens.append(e_)
        cvar.append(c_)
    g = model.grid
    for name, a in (("u", s.u), ("v", s.v), ("c", s.c)):
        np.testing.assert_allclose(a.numpy()[g.interior2d], ref[f"{name}.020"],
                                   rtol=1e-9, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(model.grid_ext.interior(s.eta).numpy(), ref["eta.020"],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ke, ke_ref, rtol=1e-10)
    np.testing.assert_allclose(ens, ens_ref, rtol=1e-10)
    np.testing.assert_allclose(cvar, cvar_ref, rtol=1e-10)


@pytest.mark.parametrize("kw", [dict(tracers=("T", "S")), dict(tracer_advection="weno7"),
                                dict(momentum_advection="vector_invariant")])
def test_deferred_model_options_raise(kw):
    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.models import SplitExplicitFreeSurface

    grid = TripolarGrid.make((16, 12, 1), halo=(5, 5, 5), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TH.make_model(grid, SplitExplicitFreeSurface(substeps=12), device="cpu", **kw)
