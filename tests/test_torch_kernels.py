"""The port's four kernel modules: plain versions against the JAX Pallas kernels,
wrapper dispatch and checks. The kernels themselves are held against the plain
versions on a CUDA card by tests/test_torch_cuda.py.

On the CPU each wrapper runs its plain PyTorch version; those are compared with the
JAX package's Pallas kernels run as its own tests run them, in interpret mode:

- halo fill: bitwise, against ``fill_halos_pallas(interpret=True)``;
- barotropic subcycle: against ``barotropic_substeps_pallas(interpret=True)`` on the
  interior, with ``tests/test_pallas.py:56``'s band at float32 (the Pallas kernel
  folds dtau into its factors) and 1e-12 at float64;
- momentum / tracer advection: against ``momentum_pallas`` / ``tracer_adv_pallas``
  (column mode) on cells at least 5 / 4 from the edge, with the bands of
  ``tests/test_pallas_mom.py`` (f32 2e-6, f64 1e-12 of the field's maximum).
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

from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC, FF  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_adv import (  # noqa: E402
    pack_adv_statics, tracer_adv_pallas)
from orthogonalsphericalshellgrids_tpu.ops.pallas_baro import (  # noqa: E402
    barotropic_substeps_pallas)
from orthogonalsphericalshellgrids_tpu.ops.pallas_fill import fill_halos_pallas  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_mom import momentum_pallas  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import (  # noqa: E402
    barotropic, halo_fill, momentum, tracer_adv)
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


# ----------------------------------------------------------------------------------
# plain versions against the JAX Pallas kernels (interpret mode)
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("H", [5, 22])
@pytest.mark.parametrize("loc,sign", [(CC, 1), (FC, -1), (CF, -1), (FF, 1), (CC, -1),
                                      (FC, 1)])
def test_fill_plain_matches_pallas_bitwise(H, loc, sign):
    Nx, Ny = 48, 40
    A = _rng(H).standard_normal((2, Ny + 2 * H, Nx + 2 * H))
    want = np.asarray(fill_halos_pallas(jnp.asarray(A), loc, sign, Nx, Ny, H, H,
                                        interpret=True))
    got = halo_fill.fill_halos_plain(torch.as_tensor(A.copy()), loc, sign, Nx, Ny, H, H)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("loc,sign", [(CC, 1), (FC, -1), (CF, -1), (FF, 1)])
def test_fill_out_of_place_matches_pallas_bitwise(loc, sign):
    """The out-of-place fill (the diagnostics' fill; the steps fill in place and
    restore, tests/test_torch_fill_group.py) leaves its input as it was and returns
    the filled field."""
    Nx, Ny, H = 48, 40, 22
    A = _rng(7).standard_normal((Ny + 2 * H, Nx + 2 * H))
    want = np.asarray(fill_halos_pallas(jnp.asarray(A), loc, sign, Nx, Ny, H, H,
                                        interpret=True))
    t = torch.as_tensor(A.copy())
    got = halo_fill.fill_halos(t, loc, sign, Nx, Ny, H, H, inplace=False)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), A)


def _small_pair(dtype):
    from examples.bickley_jet import build as jax_build
    from test_torch_model import jax_model_numpy, jax_state_numpy

    jm, js = jax_build(nx=48, ny=40, dtype=getattr(jnp, dtype), substeps=30)
    arrays, meta = jax_model_numpy(jm)
    return jm, js, TH.from_jax_arrays(arrays, meta, "cpu"), \
        TH.state_from_numpy(jax_state_numpy(js), "cpu")


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 2e-6, 1e-10),
                                             ("float64", 1e-12, 1e-20)])
@pytest.mark.parametrize("wrap", [False, True])
def test_barotropic_plain_matches_pallas(dtype, rtol, atol, wrap):
    jm, js, tm, ts = _small_pair(dtype)
    ge = jm.grid_ext
    eta = JH._fill(ge, js.eta, CC, 1)
    U = JH._fill(ge, js.U, FC, -1)
    V = JH._fill(ge, js.V, CF, -1)
    GU = JH._fill(ge, JH.embed_ext(jm.grid, ge, jm.ib.h_u * 1e-6), FC, -1)
    GV = JH._fill(ge, JH.embed_ext(jm.grid, ge, jm.ib.h_v * -2e-6), CF, -1)
    dt = 120.0
    dtau = jnp.asarray(dt, jm.dtype) * jm.fractional_dt
    want = barotropic_substeps_pallas(jm.baro_pack, eta, U, V, GU, GV, dtau, jm.weights,
                                      ge.Nx, ge.Hx, interpret=True,
                                      wrap_x_each_substep=wrap)
    t = [torch.as_tensor(np.array(a)) for a in (eta, U, V, GU, GV)]
    dtau_t = tm.fractional_dt * torch.as_tensor(dt, dtype=tm.dtype)
    got = barotropic.barotropic_substeps(tm.baro_pack, *t, dtau_t, tm.weights, ge.Nx,
                                         ge.Hx, wrap)
    for name, w, g in zip(("eta", "U", "V"), want, got):
        w = np.asarray(ge.interior(w))
        np.testing.assert_allclose(g.numpy()[ge.Hy:ge.Hy + ge.Ny, ge.Hx:ge.Hx + ge.Nx],
                                   w, rtol=rtol, atol=atol, err_msg=name)


def _mom_inputs(dtype, Yb=60, Xb=76, seed=0):
    r = np.random.default_rng(seed)
    u, v = r.standard_normal((2, Yb, Xb))
    static = 1.0 + r.random((10, Yb, Xb))
    static[3] = 0.1 * r.standard_normal((Yb, Xb))                   # f_ff
    static[8:] = (r.random((2, Yb, Xb)) > 0.15).astype(np.float64)  # masks
    return [a.astype(dtype) for a in (u, v, static)]


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-6), ("float64", 1e-12)])
def test_momentum_plain_matches_pallas(dtype, rtol):
    u, v, static = _mom_inputs(dtype)
    wu, wv = momentum_pallas(jnp.asarray(u)[None], jnp.asarray(v)[None],
                             jnp.asarray(static[:8]), jnp.asarray(static[8:]),
                             has_mask=True, interpret=True, block_rows=32)
    gu, gv = momentum.momentum(*(torch.as_tensor(a) for a in (u, v, static)))
    R = momentum.REACH
    I = (slice(R, -R), slice(R, -R))
    for want, got, nm in ((np.asarray(wu)[0], gu, "Gu"), (np.asarray(wv)[0], gv, "Gv")):
        np.testing.assert_allclose(got.numpy()[I], want[I], rtol=rtol,
                                   atol=rtol * np.abs(want[I]).max(), err_msg=nm)


def _adv_inputs(dtype, Yb=60, Xb=76, seed=3):
    r = np.random.default_rng(seed)
    c, u, v = r.standard_normal((3, Yb, Xb))
    static = 1.0 + r.random((5, Yb, Xb))
    return [a.astype(dtype) for a in (c, u, v, static)]


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-6), ("float64", 1e-12)])
def test_tracer_adv_plain_matches_pallas(dtype, rtol):
    c, u, v, static = _adv_inputs(dtype)
    h_u, dy_fc, h_v, dx_cf, iv = (jnp.asarray(p) for p in static)
    pack = pack_adv_statics((h_u * dy_fc)[None], (h_v * dx_cf)[None], iv[None])
    want = np.asarray(tracer_adv_pallas(jnp.asarray(c)[None], jnp.asarray(u)[None],
                                        jnp.asarray(v)[None], statics_packed=pack,
                                        interpret=True, block_rows=32))[0]
    got = tracer_adv.tracer_adv(*(torch.as_tensor(a) for a in (c, u, v, static)))
    R = tracer_adv.REACH
    I = (slice(R, -R), slice(R, -R))
    np.testing.assert_allclose(got.numpy()[I], want[I], rtol=rtol,
                               atol=rtol * np.abs(want[I]).max())


# ----------------------------------------------------------------------------------
# wrapper dispatch and checks (CPU)
# ----------------------------------------------------------------------------------

def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    kernels.reset_launch_counts()
    u, v, static = (torch.as_tensor(a) for a in _mom_inputs("float64"))
    gu, gv = momentum.momentum(u, v, static)
    pu, pv = momentum.momentum_plain(u, v, static)
    assert torch.equal(gu, pu) and torch.equal(gv, pv)
    c, u2, v2, st2 = (torch.as_tensor(a) for a in _adv_inputs("float64"))
    assert torch.equal(tracer_adv.tracer_adv(c, u2, v2, st2),
                       tracer_adv.tracer_adv_plain(c, u2, v2, st2))
    A = torch.as_tensor(_rng(1).standard_normal((50, 58)))
    B = A.clone()
    out = halo_fill.fill_halos(A, CF, -1, 48, 40, 5, 5)
    assert out is A and not torch.equal(A, B)  # filled in place
    assert torch.equal(A, halo_fill.fill_halos_plain(B, CF, -1, 48, 40, 5, 5))
    C = A.clone()
    out = halo_fill.fill_halos(B, FC, -1, 48, 40, 5, 5, inplace=False)
    assert out is not B and torch.equal(A, C)  # the input is left as it was
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_wrappers_reject_bad_operands():
    u, v, static = (torch.as_tensor(a) for a in _mom_inputs("float64"))
    with pytest.raises(TypeError):
        momentum.momentum(u.float(), v, static)
    with pytest.raises(ValueError):
        momentum.momentum(u, v, static[:8])
    with pytest.raises(ValueError):
        momentum.momentum(u.t().contiguous().t(), v, static)
    with pytest.raises(TypeError):
        tracer_adv.tracer_adv(u.to(torch.int64), u.to(torch.int64), v.to(torch.int64),
                              static[:5].to(torch.int64))
    A = torch.zeros(50, 58, dtype=torch.float64)
    with pytest.raises(ValueError):  # 2*Hx >= Nx: the kernel would race
        halo_fill.fill_halos(torch.zeros(40 + 50, 48 + 48, dtype=torch.float64), CC, 1,
                             48, 40, 24, 25)
    with pytest.raises(ValueError):  # wrong plane shape
        halo_fill.fill_halos(A, CC, 1, 48, 40, 4, 5)


def test_step_counts_no_launches_on_cpu():
    from examples.bickley_jet_torch import build

    model, state = build(24, 30, dtype=torch.float64, substeps=12, device="cpu")
    kernels.reset_launch_counts()
    TH.step(model, state, 60.0)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
