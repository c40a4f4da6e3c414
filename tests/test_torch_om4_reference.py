"""The port's layered step at the options of the benchmark's OM4p25 configuration
(``perfbench/configs/om4p25_l75.json``: T and S through the linear equation of state,
Coriolis, the zonal wind on layer 0, quadratic drag, harmonic ν_h and κ_h, ν_v and
κ_v) against the benchmark's plain layered reference (``perfbench/reference/
layered.py``), on the CPU in float64 at 48 x 40 x 8 from the scenario's seeded fields,
over its land and a bottom that cuts the columns to 1-8 wet layers.

- The initial state and three steps (the first forward Euler), with implicit and
  with explicit vertical mixing, and with the reference's horizontal operators run
  over all 8 layers at once or in blocks of 3: every compared field within 1e-11 of
  its largest value at the interior points. The reference restates the step in its
  own order of operations (quotients of metrics, depth sums a block of layers at a
  time, the depth-mean correction as (U_a − Σ dzu u*)/H), so the two differ by
  float64 rounding alone: 1e-16 to 2e-15 measured over the three steps, where the
  WENO weights and the 30 substeps carry it; 1e-11 is the band of the port's other
  float64 comparisons of three layered steps (``tests/test_torch_gyre.py``), four
  orders of room for another platform's libm.
- The implicit solve: the port's ``_implicit_vertical_solve`` against the
  reference's column solve on random columns with random wet-layer counts, within
  1e-12 of the largest value, and Σ_k dz_k x_k = Σ_k dz_k q_k in every column.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from perfbench.lib import check, program, scenario  # noqa: E402
from perfbench.reference import layered as ref  # noqa: E402

BAND = 1e-11
SEED = 2 ** 33 + 19


def _config(mode="implicit", nz=8):
    with open(os.path.join(ROOT, "perfbench", "configs", "om4p25_l75.json")) as f:
        cfg = json.load(f)
    cfg.update(dtype="float64", nx=48, ny=40, nz=nz)
    cfg["physics"]["vertical_time_discretization"] = mode
    return cfg


def _inputs(cfg):
    """The scenario's inputs, its ocean's depths spread from 1 m to the full depth
    (at 48 x 40 the scenario's own shelves lie within a cell of the coast)."""
    inp = scenario.inputs(cfg, SEED)
    land, depth = inp["bottom"], cfg["vertical"]["depth_m"]

    def bottom(lam, phi):
        share = (0.5 + 0.5 * np.sin(np.deg2rad(3 * lam)) * np.cos(np.deg2rad(2 * phi))) ** 3
        return np.where(land(lam, phi) > 0, 1.0, -(1.0 + (depth - 1.0) * share))

    return dict(inp, bottom=bottom)


def _gaps(cfg, m, state, s):
    kind = program.kind(cfg)
    return {f: check.field_gap(getattr(state, f).numpy(), s[f].numpy(),
                               m["He"] if f in kind.WIDE else m["H"])
            for f in kind.FIELDS}


@pytest.mark.parametrize("layers_per_block", [None, 3])
@pytest.mark.parametrize("mode", ["implicit", "explicit"])
def test_layered_step_is_the_reference(mode, layers_per_block):
    cfg = _config(mode)
    inp = _inputs(cfg)
    model, state = program.build(cfg, inp, "cpu")
    m = ref.build(cfg, inp, dtype=torch.float64, device="cpu", sample_dtype=torch.float64)
    if layers_per_block:
        m["layers_per_block"] = layers_per_block
    s = ref.initial_state(m, inp["init"])
    wet = m["n_wet"][5:-5, 5:-5]
    assert int(wet[wet > 0].min()) == 1 and int(wet.max()) == 8  # columns of 1-8 layers
    assert torch.equal(model.n_wet.long(), m["n_wet"].long())
    start = dict(s)
    for k in range(4):  # the initial state, then 3 steps
        gaps = _gaps(cfg, m, state, s)
        assert max(gaps.values()) < BAND, (k, gaps)
        if k < 3:
            state = TL.layered_step(model, state, cfg["dt"])
            s = ref.step(m, s, cfg["dt"])
    moved = {f: check.field_gap(s[f].numpy(), start[f].numpy(), 5) for f in ("u", "v", "c")}
    assert min(moved.values()) > 1e6 * BAND, moved  # the steps moved every field


def test_implicit_solve_is_the_reference_solve():
    cfg = _config()
    inp = _inputs(cfg)
    m = ref.build(cfg, inp, dtype=torch.float64, device="cpu", sample_dtype=torch.float64)
    r = np.random.default_rng(4)
    nz = cfg["nz"]
    m["n_wet"] = torch.as_tensor(r.integers(0, nz + 1, size=m["n_wet"].shape))
    q = torch.as_tensor(r.standard_normal((nz,) + tuple(m["n_wet"].shape)))
    rr = torch.tensor(300.0 * 1e-3, dtype=torch.float64)
    dz = torch.tensor(m["dz"], dtype=torch.float64).view(-1, 1, 1)
    for which in range(3):
        mask = ref.masks(m, 0, nz)[which]
        got = TL._implicit_vertical_solve(q, rr, m["dz"], m["dzc"], mask)
        want = ref.implicit_solve(m, q, rr, which)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-12
        assert torch.allclose((want * dz).sum(0), (q * dz).sum(0), rtol=0, atol=1e-9)
        assert float((want - q).abs().max()) > 1e-3  # the solve moved the columns
