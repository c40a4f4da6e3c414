"""The layered cell's own pieces on the CPU: the counts of the layered stages under
what the reference performs, the readers of its per-layer metrics, and the check
that decides ``correct`` failing where it should, at 48 x 40 x 16 with the cell's
limits as committed.

Sixteen layers and not eight: under the 2 m top cell, eight layers over 6500 m are
2 m, then 48 m to 2271 m thick, and there κ_v = 1e-4 m²/s moves a tracer so little
in a block that the implicit tracer solve left out reads 0.0028-0.0042 at Δt = 60 s
(four seeds) and 0.0058 at 300 s, under the limit 0.01 (the program reads 6e-5 to
1.1e-4 there). With sixteen the upper layers are 2-23 m thick, as the
configuration's upper layers are, and it reads 0.023 (60 s) and 0.039 (300 s)."""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from perfbench import control
from perfbench.lib import cells, program, scenario
from perfbench.lib.shapes import of
from perfbench.reference import layered as ref
from perfbench.tests.test_perfbench_counts import count, tally

import perfbench.run as harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "om4p25_l75.blocks"


def small(nz=16):
    """The cell at 48 x 40 x ``nz``."""
    cell = cells.cell(CELL)
    cell.config.update(nx=48, ny=40, nz=nz)
    return cell


# ------------------------------------------------------------------------------------
# counts
# ------------------------------------------------------------------------------------

def _reference(nz=8):
    cfg = json.loads((ROOT / "configs" / "om4p25_l75.json").read_text())
    cfg.update(dtype="float64", nx=48, ny=32, nz=nz)
    inp = scenario.inputs(cfg, 3)
    m = ref.build(cfg, inp)
    s = ref.step(m, ref.initial_state(m, inp["init"]), cfg["dt"])  # a state with tendencies
    u, v, c = ref.fill_state(m, s)[:3]
    mc, mu, mv = ref.masks(m, 0, nz)
    dz = torch.tensor(m["dz"], dtype=torch.float64).view(-1, 1, 1)
    return cfg, m, s, (u, v, c, mc, mu, mv, dz)


REF = _reference()


def test_momentum_count_is_at_most_the_reference_tally():
    cfg, m, s, (u, v, c, mc, mu, mv, dz) = REF
    ops, nbytes = count("momentum_layered", cfg)
    assert 0 < ops <= tally(ref._momentum, m, u, v, mc, mu, mv, mu, mv, dz)
    assert nbytes > 0


def test_tracer_count_is_at_most_the_reference_tally():
    cfg, m, s, (u, v, c, mc, mu, mv, dz) = REF
    nz = cfg["nz"]
    ops, nbytes = count("tracer_layered", cfg)
    want = sum(tally(ref._tracer, m, c[i * nz:(i + 1) * nz], u, v, mc, mu, mv, dz)
               for i in range(2))
    assert 0 < ops <= want
    assert nbytes > 0


def test_vertical_count_is_at_most_the_reference_tally():
    cfg, m, s, (u, v, c, *_) = REF
    assert cfg["physics"]["vertical_time_discretization"] == "implicit"  # no ν_v, κ_v terms
    ops, nbytes = count("vertical", cfg)
    assert 0 < ops <= tally(ref._vertical, m, u, v, c)
    assert nbytes > 0


def test_layered_step_count_is_at_most_the_reference_tally_and_covers_its_stages():
    cfg, m, s, _ = REF
    ops, nbytes = count("layered_step", cfg)
    stages = sum(count(st, cfg)[0] for st in ("barotropic", "momentum_layered",
                                              "tracer_layered", "vertical"))
    assert stages < ops <= tally(ref.step, m, s, cfg["dt"])
    # the step's bytes: its state in and out, less than the stages' own
    assert 0 < nbytes < sum(count(st, cfg)[1] for st in ("momentum_layered",
                                                          "tracer_layered", "vertical"))


def _bytes_by_kind(stage, cfg):
    """(bytes a layer, bytes of the planes that do not repeat over the layers) of
    ``stage``: its count is linear in Nz."""
    b8, b16 = (count(stage, dict(cfg, nz=nz))[1] for nz in (8, 16))
    per_layer = (b16 - b8) // 8
    return per_layer, b8 - 8 * per_layer


# the planes a layer that each layered stage touches once: the step's own fields (the
# prognostic stacks and their tendencies, which the step reads and writes once each),
# and the vertical terms that the vertical kernel hands to the other two
TRACERS = ("T", "S")
TOUCHES = {"momentum_layered": (("u", "v", "Gu", "Gv"), ("dGu", "dGv")),
           "tracer_layered": (("u", "v") + TRACERS + tuple("G" + c for c in TRACERS),
                              tuple("dG" + c for c in TRACERS)),
           "vertical": (("u", "v") + TRACERS, ("dGu", "dGv") + tuple("dG" + c for c in TRACERS))}
STEP_FIELDS = ("u", "v", "Gu", "Gv") + TRACERS + tuple("G" + c for c in TRACERS)


@pytest.mark.parametrize("stage", ["barotropic"] + sorted(TOUCHES))
def test_a_stage_needs_no_more_bytes_than_the_step_charges(stage):
    """A stage's least time never comes from planes that the whole step does without
    (a closure pack or a mask made from the metrics and the wet-layer counts): a
    layer, it counts at most one plane of each of the step's fields it touches and
    of each vertical term, where the step reads and writes each of its fields once;
    its planes that do not repeat over the layers are at most the step's."""
    cfg = REF[0]
    plane = of(cfg).P * of(cfg).word
    assert tuple(cfg["physics"]["tracers"]) == TRACERS
    per_layer, once = _bytes_by_kind(stage, cfg)
    step_per_layer, step_once = _bytes_by_kind("layered_step", cfg)
    assert step_per_layer == 2 * len(STEP_FIELDS) * plane
    fields, terms = TOUCHES.get(stage, ((), ()))
    assert set(fields) <= set(STEP_FIELDS)
    assert per_layer == (len(fields) + len(terms)) * plane
    assert 0 < once <= step_once


# ------------------------------------------------------------------------------------
# readers
# ------------------------------------------------------------------------------------

KERNELS = {"void momentum_kernel<float, true>(...)": 0.02,
           "void tracer_adv_kernel<float, (Mode)3>(...)": 0.03,
           "void vertical_kernel<float>(Args)": 0.01,
           "void subcycle_kernel<float>(...)": 0.005,
           "void at::native::vectorized_elementwise_kernel<4, ...>(...)": 0.5,
           "void at::native::reduce_kernel<512, 1, ...>(...)": 0.1}


def _run(trace=True, steps=20):
    launches = {"halo_fill": 2 * steps, "vertical": steps, "momentum_closures": steps}
    t = dict(busy_s=1.9, window_s=2.0, kernels=dict(KERNELS), device_ops=[], idle_gaps=[])
    return dict(steps=steps, members=1, window_s=2.0, sim_seconds=300.0 * steps,
                launches=launches, capture_s=4.5, trace=t if trace else None)


def _read(name, run):
    return cells.metric_reader(name).read(run, cells.cell(CELL))


def test_the_blocks_readers_read_the_layered_cell():
    from perfbench.lib.readers import least_seconds

    cfg = cells.cell(CELL).config
    run = _run()
    assert _read("idle_share.blocks", run) == pytest.approx(5.0)
    assert _read("device_ms_per_step.blocks", run) == pytest.approx(1e3 * 1.9 / 20)
    assert _read("launches_per_step.blocks", run) == 4
    assert _read("capture_s", run) == 4.5
    assert _read("barotropic_roofline", run) == pytest.approx(
        100 * least_seconds("barotropic", cfg) / (0.005 / 20))


def test_the_trace_readers_read_their_kernels_and_nothing_without_a_trace():
    from perfbench.lib.readers import least_seconds

    cfg = cells.cell(CELL).config
    run = _run()
    assert _read("glue_ms_per_step.om4", run) == pytest.approx(1e3 * 0.6 / 20)
    assert _read("step_mfu.om4", run) == pytest.approx(
        100 * least_seconds("layered_step", cfg) / 0.1)
    for name, stage, seconds in (("momentum_roofline.om4", "momentum_layered", 0.02),
                                 ("tracer_roofline.om4", "tracer_layered", 0.03),
                                 ("vertical_roofline.om4", "vertical", 0.01)):
        assert _read(name, run) == pytest.approx(
            100 * least_seconds(stage, cfg) / (seconds / 20)), name
    for name in ("glue_ms_per_step.om4", "step_mfu.om4", "momentum_roofline.om4",
                 "tracer_roofline.om4", "vertical_roofline.om4"):
        assert _read(name, _run(trace=False)) is None, name
    run["trace"]["kernels"] = {"void subcycle_kernel<float>(...)": 0.005}
    assert _read("glue_ms_per_step.om4", run) is None
    assert _read("vertical_roofline.om4", run) is None


# ------------------------------------------------------------------------------------
# the check: the control and the program broken underneath
# ------------------------------------------------------------------------------------

def _execute(cell):
    out, rows, _ = harness.execute(cell, 2 ** 31 + 5, 0.5, 0, device="cpu")
    return out


def test_the_control_fails_where_the_program_passes():
    cell = small()
    got = control.readings(cell, 17, 0.5, True, device="cpu")
    assert all(got["program"][k] <= lim for k, lim in cell.limits.items()), got
    assert all(got["control"][k] > lim for k, lim in cell.limits.items()), got


def test_a_sound_run_is_correct():
    assert _execute(small())["correct"]


def _solve_dropped(dim):
    """The port's implicit solve left out for u and v (``dim`` 3) or for the tracer
    stack (4)."""
    from orthogonalsphericalshellgrids_tpu_torch.models import layered

    real = layered._implicit_vertical_solve

    def solve(q, r, dz, dzc, mask):
        return q if q.dim() == dim else real(q, r, dz, dzc, mask)

    return layered, "_implicit_vertical_solve", solve


def _tendency_dropped(block):
    """The tracer kernel's tendency (its horizontal and vertical terms) of tracer
    ``block`` (0 T, 1 S) set to 0."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv

    real = tracer_adv.tracer_adv

    def adv(c, u, v, *args, **kw):
        G = real(c, u, v, *args, **kw)
        nz = u.shape[-3]
        G[..., block * nz:(block + 1) * nz, :, :] = 0
        return G

    return tracer_adv, "tracer_adv", adv


def _state_returned():
    def entry(path):
        return lambda model, s, dt, n: s

    return program, "entry", entry


BROKEN = {"the implicit momentum solve dropped": lambda: _solve_dropped(3),
          "the implicit tracer solve dropped": lambda: _solve_dropped(4),
          "T's tendency dropped": lambda: _tendency_dropped(0),
          "S's tendency dropped": lambda: _tendency_dropped(1),
          "a step that returns its state": _state_returned}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_a_run_broken_underneath_is_not_correct(case, monkeypatch):
    monkeypatch.setattr(*BROKEN[case]())
    out = _execute(small())
    assert not out["correct"], out["checks"]
