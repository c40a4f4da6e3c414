"""The readers of the program's spans and counters (``lib/spans.py`` and the five
metrics of the driver layer that read it): None where the program records nothing,
the right number from a registry made by hand, and all five in the line of a traced
run of the small simulation cell on the CPU."""

from __future__ import annotations

import pytest

from perfbench.lib import cells, spans
from perfbench.tests.test_perfbench_control import small

NAMES = ("write_ms.sim", "output_copy_ms.sim", "callback_host_share.sim",
         "host_waits_per_step.sim", "clones_per_step.sim")
MS = 1_000_000  # ns
RUN = dict(window_s=1.0, steps=100)

# the simulation thread 1 and a writer thread 2: two cycles of wizard and progress,
# a copy with a child, a write on each thread, two clones and one span still open
SPANS = [
    ("osg.sim.clone", 0, 1 * MS, None, 10, 1),
    ("osg.sim.wizard", 2 * MS, 12 * MS, None, None, 1),
    ("osg.sim.progress", 10 * MS, 20 * MS, None, 10, 1),    # overlaps the wizard by 2
    ("osg.output.copy", 100 * MS, 130 * MS, None, 0, 1),
    ("user.output", 110 * MS, 120 * MS, 3, "zeta", 1),       # inside the copy
    ("osg.output.write", 130 * MS, 230 * MS, None, 0, 1),
    ("osg.output.write", 300 * MS, 600 * MS, None, 1, 2),    # the writer thread's
    ("osg.sim.clone", 700 * MS, 701 * MS, None, 20, 1),
    ("osg.sim.nan_check", 800 * MS, 805 * MS, None, 20, 1),
    ("osg.sim.progress", 900 * MS, None, None, 30, 1),       # open: not counted
]
COUNTS = {"wait.sim.wizard": 2, "wait.sim.progress": 2, "wait.output.copy": 4,
          "wait.sim.end": 1, "other": 7}
WANT = {"write_ms.sim": (100 + 300) / 2, "output_copy_ms.sim": 30.0,
        # clones 0-1 and 700-701, wizard and progress 2-20, copy and write 100-230,
        # NaN 800-805: 155 ms of 1 s
        "callback_host_share.sim": 15.5, "host_waits_per_step.sim": 0.09,
        "clones_per_step.sim": 0.02}


def read(name, run=RUN):
    return cells.metric_reader(name).read(dict(run), None)


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_finds_nothing_without_spans(name, monkeypatch):
    monkeypatch.setattr(spans, "registry", lambda: ([], {}))
    assert read(name) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_reads_a_registry(name, monkeypatch):
    monkeypatch.setattr(spans, "registry", lambda: (list(SPANS), dict(COUNTS)))
    assert read(name) == pytest.approx(WANT[name], rel=1e-12)


def test_the_registry_of_a_program_without_spans_is_empty(monkeypatch):
    from orthogonalsphericalshellgrids_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.registry() == ([], {})


def test_a_traced_run_of_the_simulation_cell_reports_all_five():
    import perfbench.run as harness
    from orthogonalsphericalshellgrids_tpu_torch.utils import profiling

    profiling.reset_spans()
    cell = small("bickley_jet_q.simulation")
    out, _, _ = harness.execute(cell, 2 ** 31 + 11, 0.3, 1, device="cpu")
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NAMES}
    assert set(got) == set(NAMES), out["metrics"]
    steps, it0 = out["attempted"], cell.traffic["warm_iterations"]

    def fired(every):  # the iterations of the window that a schedule every ``every`` hits
        return (it0 + steps) // every - it0 // every

    counts = profiling.counters()
    # wizard and progress every 10, the NaN check every 100, the four fields of each
    # write (every 30 steps), the run's end; the CPU loop makes no clone
    want = {"wait.sim.wizard": fired(10), "wait.sim.progress": fired(10),
            "wait.sim.nan_check": fired(100), "wait.output.copy": 4 * fired(30),
            "wait.sim.end": 1}
    assert counts == {k: n for k, n in want.items() if n}
    assert got["host_waits_per_step.sim"] == pytest.approx(sum(counts.values()) / steps)
    assert got["clones_per_step.sim"] == 0.0
    assert got["write_ms.sim"] > 0 and got["output_copy_ms.sim"] > 0
    assert 0 < got["callback_host_share.sim"] <= out["metrics"]["callback_share.sim"]["value"]
