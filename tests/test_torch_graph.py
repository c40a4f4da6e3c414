"""The compiled step blocks of the PyTorch port (``utils/graph.py``) on the CPU, at a
small size: a 48 x 32 float64 Bickley jet (substeps 6) and the 48 x 32 x 3 check gyre
(``examples/wind_driven_ts_gyre_torch.py:build_check``), serial and as 2-member
ensembles.

On the CPU a block is the eager loop of the step; on a card it replays the model's
captured CUDA graphs of the step, whose cases (bitwise the eager loop, the launch
counts, no host synchronization, ``Simulation``'s kept state) are in
``tests/test_torch_cuda.py`` and skip here.

- ``multi_step``, ``layered_multi_step`` and ``ensemble_multi_step`` over n = 1, 2, 3
  and 10 steps, bitwise a loop of ``step`` / ``layered_step``, the input bitwise
  unchanged and no storage shared between the result and the input;
- dt as a number and as a 0-d tensor, a dt changed between two calls, and
  ``Simulation``'s blocks with its last step at its own dt;
- the cache: a second call reuses the first call's ``Block``, another layout (a member
  count) gets its own, and ``del model`` drops them;
- the launch record of a capture (``kernels.recording``) and its count at a replay
  (``kernels.add_launches``);
- the steps' ``out``: a step given a state of buffers writes the new state there,
  bitwise the step without it, for both models, their ensembles, a prognostic b and
  the options computed in torch; a buffer of another shape is refused;
- against the JAX package's jitted ``multi_step`` and ``layered_multi_step`` (the
  gyre's XLA path, ``use_pallas=False``) at float64, rtol 1e-12 of each field's
  maximum on the interior (the band of ``tests/test_torch_model.py``): the port
  follows the kernel path's order of operations, XLA on the CPU contracts
  multiply-adds, so the two agree to rounding and not bitwise.
"""

import dataclasses
import gc
import os
import sys
import weakref
from functools import partial

import numpy as np
import pytest
import torch

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (ROOT, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_gyre import _jax_gyre  # noqa: E402
from test_torch_layered import jax_layered_numpy  # noqa: E402
from test_torch_model import _assert_states_close, jax_model_numpy, jax_state_numpy  # noqa: E402

from examples.bickley_jet import build as jax_jet  # noqa: E402
from examples.bickley_jet_torch import build as jet  # noqa: E402
from examples.wind_driven_ts_gyre_torch import build_check  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import ensemble  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.utils import Simulation, graph  # noqa: E402

torch.set_num_threads(1)

PATHS = ("jet", "gyre", "jet_ensemble", "gyre_ensemble")


def _names(state):
    return [f.name for f in dataclasses.fields(state)]


def _scaled(state, s):
    return type(state)(**{n: getattr(state, n) * s if n not in ("t", "iteration")
                          else getattr(state, n) for n in _names(state)})


@pytest.fixture(scope="module")
def models():
    """{path: (block function, step function, model, state)}: the jet and the gyre,
    each serial and as 2 members (the state times 0.5 and, one step ahead, 1.25, so
    that the members' AB2 weights differ)."""
    jm, js = jet(48, 32, dtype=torch.float64, substeps=6, device="cpu")
    gm, gs = build_check(device="cpu")
    out = {"jet": (TH.multi_step, TH.step, jm, js),
           "gyre": (TL.layered_multi_step, TL.layered_step, gm, gs)}
    for name, (_, step, m, s) in list(out.items()):
        batch = ensemble.stack_members([_scaled(s, 0.5), step(m, _scaled(s, 1.25), 60.0)])
        out[f"{name}_ensemble"] = (ensemble.ensemble_multi_step, step, m, batch)
    return out


def _loop(step, model, state, dt, n):
    for _ in range(n):
        state = step(model, state, dt)
    return state


def _assert_equal(got, want, what):
    for n in _names(want):
        assert torch.equal(getattr(got, n), getattr(want, n)), (what, n)


def _storages(state):
    return {getattr(state, n).untyped_storage().data_ptr() for n in _names(state)}


@pytest.mark.parametrize("n_steps", [1, 2, 3, 10])
@pytest.mark.parametrize("path", PATHS)
def test_block_is_the_loop_of_step(models, path, n_steps):
    """A block of n steps is bitwise the loop of the step, leaves its input as it was
    and shares no storage with it."""
    block, step, model, state = models[path]
    before = {n: getattr(state, n).clone() for n in _names(state)}
    got = block(model, state, 60.0, n_steps)
    _assert_equal(state, type(state)(**before), "input")
    _assert_equal(got, _loop(step, model, state, 60.0, n_steps), "block")
    assert not _storages(got) & _storages(state)
    assert int(got.iteration.reshape(-1)[0]) == int(state.iteration.reshape(-1)[0]) + n_steps


@pytest.mark.parametrize("path", PATHS)
def test_block_takes_dt_as_a_number_or_a_tensor(models, path):
    """dt as a float, a 0-d float64 tensor and a 0-d float32 tensor (cast to the
    model's dtype, as the step casts it), and changed between two calls."""
    block, step, model, state = models[path]
    for dt in (60.0, torch.tensor(60.0, dtype=torch.float64),
               torch.tensor(45.5, dtype=torch.float32)):
        _assert_equal(block(model, state, dt, 2), _loop(step, model, state, dt, 2), dt)
    first = block(model, state, 60.0, 2)
    second = block(model, first, 30.0, 3)
    _assert_equal(second, _loop(step, model, _loop(step, model, state, 60.0, 2), 30.0, 3),
                  "dt changed between calls")


def test_block_of_no_steps_is_its_input(models):
    _, _, model, state = models["jet"]
    assert TH.multi_step(model, state, 60.0, 0) is state
    with pytest.raises(ValueError, match="n_steps"):
        TH.multi_step(model, state, 60.0, -1)


def test_blocks_are_cached_per_model_and_layout():
    """A second call reuses the first call's ``Block``, a second member count gets its
    own, a copy of the model starts with none, and ``del model`` drops them."""
    import copy

    model, state = jet(48, 32, dtype=torch.float64, substeps=6, device="cpu")
    assert graph.blocks(model) == {}
    TH.multi_step(model, state, 60.0, 2)
    (key, block), = graph.blocks(model).items()
    assert key == graph.layout(TH.step, state) and block.device == state.u.device
    TH.multi_step(model, state, 30.0, 3)
    assert graph.blocks(model) == {key: block}
    batch = ensemble.stack_members([state, state])
    ensemble.ensemble_multi_step(model, batch, 60.0, 1)
    assert len(graph.blocks(model)) == 2 and graph.blocks(model)[key] is block
    assert graph.blocks(copy.copy(model)) == {}
    # a CPU block captures nothing
    assert (block.graphs, block.buffers, block.pool_bytes) == (None, None, 0)
    ref = weakref.ref(block)
    del block, model
    gc.collect()
    assert ref() is None


def test_simulation_runs_its_blocks_and_last_step():
    """``Simulation`` with blocks of 4 and a stop time 10.5 steps in: two blocks, two
    single steps and a last half step at its own dt, the loop of ``step``."""
    model, state = jet(48, 32, dtype=torch.float64, substeps=6, device="cpu")
    sim = Simulation(model, state, dt=60.0, stop_time=60.0 * 10.5, steps_per_block=4,
                     nan_checker=False)
    out = sim.run()
    want = _loop(TH.step, model, state, 60.0, 10)
    want = TH.step(model, want, torch.tensor(30.0, dtype=torch.float64))
    _assert_equal(out, want, "simulation")
    assert sim.iteration == 11


def test_launches_recorded_at_a_capture_and_counted_at_a_replay():
    """Inside ``recording`` a wrapper's launch goes to the record only; ``add_launches``
    counts a record in ``LAUNCHES`` and in the thread's ``counting`` block."""
    kernels.reset_launch_counts()
    record = dict.fromkeys(kernels.LAUNCHES, 0)
    own = dict.fromkeys(kernels.LAUNCHES, 0)
    with kernels.counting(own):
        with kernels.recording(record):
            kernels.count("barotropic")
            kernels.count("halo_fill")
            kernels.count("halo_fill")
        assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCHES, 0)
        assert own == dict.fromkeys(kernels.LAUNCHES, 0)
        kernels.add_launches(record)
        kernels.add_launches(record)
        kernels.count("momentum")
    want = dict(dict.fromkeys(kernels.LAUNCHES, 0), barotropic=2, halo_fill=4, momentum=1)
    assert kernels.launch_counts() == want and own == want
    kernels.reset_launch_counts()


def _buffers(state, share=()):
    """A state of buffers laid out as a block's (η, U and V the views of one (3,) +
    η.shape buffer), holding ``state``'s own tensors for the fields ``share``."""
    avg = torch.empty((3,) + tuple(state.eta.shape), dtype=state.eta.dtype)
    fields = {n: torch.full_like(getattr(state, n), float("nan")) if
              getattr(state, n).is_floating_point() else torch.zeros_like(getattr(state, n))
              for n in _names(state)}
    fields.update(eta=avg[0], U=avg[1], V=avg[2], **{n: getattr(state, n) for n in share})
    return type(state)(**fields)


@pytest.fixture(scope="module")
def out_cases(models):
    """{case: (step function, model, state, fields the step hands through)}: the four
    paths, the front (a prognostic b: Gb from the tracer kernel, b from the
    corrector) and the jet with WENO-7 tracers and the centered momentum (tendencies
    that torch computes)."""
    from examples.baroclinic_front_torch import build as front

    cases = {path: (step, model, state, ("b", "Gb") if step is TL.layered_step else ())
             for path, (_, step, model, state) in models.items()}
    fm, fs = front(48, 32, 3, dtype=torch.float64, substeps=6, device="cpu")
    cases["front"] = (TL.layered_step, fm, TL.layered_step(fm, fs, 60.0), ())
    om, os_ = jet(48, 32, dtype=torch.float64, substeps=6, device="cpu",
                  tracer_advection="weno7", momentum_advection="vector_invariant")
    cases["jet_options"] = (TH.step, om, TH.step(om, os_, 60.0), ())
    return cases


@pytest.mark.parametrize("case", PATHS + ("front", "jet_options"))
def test_step_writes_into_out(out_cases, case):
    """A step given ``out`` returns ``out`` holding, bitwise, the state the step
    without it returns, and leaves its input as it was; the fields it hands through
    (b and Gb without a prognostic buoyancy) may be the input's own."""
    step, model, state, share = out_cases[case]
    before = {n: getattr(state, n).clone() for n in _names(state)}
    buf = _buffers(state, share)
    got = step(model, state, 60.0, out=buf)
    assert got is buf
    _assert_equal(got, step(model, state, 60.0), case)
    _assert_equal(state, type(state)(**before), "input")


def test_out_of_another_shape_is_refused(models):
    _, step, model, state = models["jet"]
    buf = _buffers(state)
    buf = dataclasses.replace(buf, Gu=buf.Gu[:-1])
    with pytest.raises(ValueError, match="out must be"):
        step(model, state, 60.0, out=buf)


@pytest.fixture(scope="module")
def jax_jet_pair():
    jm, js = jax_jet(nx=48, ny=32, dtype=jax.numpy.float64, substeps=6)
    arrays, meta = jax_model_numpy(jm)
    tm = TH.from_jax_arrays(arrays, meta, device="cpu")
    return jm, js, tm, TH.state_from_numpy(jax_state_numpy(js), device="cpu")


@pytest.fixture(scope="module")
def jax_gyre_pair():
    jm, js = _jax_gyre("gyre")
    arrays, meta = jax_layered_numpy(jm)
    tm = TL.layered_from_jax_arrays(arrays, meta, device="cpu")
    ts = TL.layered_state_from_numpy({n: np.asarray(getattr(js, n)) for n in _names(js)},
                                     device="cpu")
    return jm, js, tm, ts


@pytest.mark.parametrize("n_steps", [1, 3, 10])
def test_jet_block_matches_jax_multi_step(jax_jet_pair, n_steps):
    jm, js, tm, ts = jax_jet_pair
    jout = jax.jit(partial(JH.multi_step, n_steps=n_steps))(jm, js, 60.0)
    tout = TH.multi_step(tm, ts, 60.0, n_steps)
    assert int(tout.iteration) == int(jout.iteration) == n_steps
    _assert_states_close(jm, jout, tout, rtol=1e-12)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_gyre_block_matches_jax_layered_multi_step(jax_gyre_pair, n_steps):
    jm, js, tm, ts = jax_gyre_pair
    jout = jax.jit(partial(JL.layered_multi_step, n_steps=n_steps))(jm, js, 60.0)
    tout = TL.layered_multi_step(tm, ts, 60.0, n_steps)
    assert int(tout.iteration) == int(jout.iteration) == n_steps
    g, ge = jm.grid, jm.grid_ext
    for name in ("u", "v", "c", "b", "Gu", "Gv", "Gc", "Gb", "eta", "U", "V"):
        grid = ge if name in ("eta", "U", "V") else g
        want = np.asarray(getattr(jout, name))[..., grid.Hy:grid.Hy + grid.Ny,
                                                grid.Hx:grid.Hx + grid.Nx]
        got = getattr(tout, name).numpy()[..., grid.Hy:grid.Hy + grid.Ny,
                                           grid.Hx:grid.Hx + grid.Nx]
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(want).max(), 1e-30),
                                   err_msg=name)
    assert float(tout.t) == pytest.approx(float(jout.t), rel=1e-15)
