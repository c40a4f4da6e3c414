"""The benchmark's plain reference (``perfbench/reference/``) against the port's CPU
path (its plain versions of every kernel), in float64 at small sizes: the grid, the
initial state, a few steps, and the vorticity a run may write. Also: the reference's module
tree imports nothing of the program, of JAX or of the JAX package."""

from __future__ import annotations

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from perfbench.lib import check, program, scenario
from perfbench.reference import grid as rgrid
from perfbench.reference import model as ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "orthogonalsphericalshellgrids_tpu",
             "orthogonalsphericalshellgrids_tpu_torch"}


def small(name, **over):
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    cfg.update(dtype="float64", nx=48, ny=32, **over)
    return cfg


CASES = {"bickley_jet_q": small("bickley_jet_q")}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_reference_steps_as_the_port(name, seed):
    cfg = CASES[name]
    inp = scenario.inputs(cfg, seed)
    model, state = program.build(cfg, inp, "cpu")
    m = ref.build(cfg, inp, dtype=torch.float64, device="cpu", sample_dtype=torch.float64)
    s = ref.initial_state(m, inp["init"])
    H, He = cfg["halo"], m["He"]
    kind = program.kind(cfg)
    vorticity = program.entry("models.diagnostics.vertical_vorticity")
    for k in range(4):  # the initial state, then 3 steps (the first is forward Euler)
        for f in kind.FIELDS:
            h = He if f in kind.WIDE else H
            assert check.field_gap(getattr(state, f).numpy(), s[f].numpy(), h) < 1e-11, (k, f)
        assert check.field_gap(vorticity(model, state).numpy(),
                               ref.vertical_vorticity(m, s).numpy(), H) < 1e-11, k
        state = program.entry("models.multi_step")(model, state, cfg["dt"], 1)
        s = ref.step(m, s, cfg["dt"])


def test_reference_grid_is_the_ports():
    from orthogonalsphericalshellgrids_tpu_torch.grids.tripolar import build_tripolar_arrays

    for halo in (5, 22):
        want = build_tripolar_arrays((48, 32, 1), halo=(halo, halo, halo), backend="numpy",
                                     north_poles_latitude=25.0, first_pole_longitude=45.0)
        got = rgrid.tripolar(48, 32, halo, north_poles_latitude=25.0,
                             first_pole_longitude=45.0)
        for name in rgrid.COORDS + rgrid.METRICS:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-13, atol=0,
                                       err_msg=name)


def test_base_grid_is_the_crop_of_the_widened_one():
    H, He = 5, 22
    base = rgrid.tripolar(48, 32, H)
    ext = rgrid.tripolar(48, 32, He)
    d = He - H
    for name in base:
        np.testing.assert_array_equal(base[name], ext[name][d:d + 32 + 2 * H,
                                                            d:d + 48 + 2 * H], err_msg=name)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path) if name}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program_in_a_fresh_process():
    import subprocess
    import sys

    code = ("import sys; import perfbench.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
