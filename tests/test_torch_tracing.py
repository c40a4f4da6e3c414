"""The port's spans and wait counters (``utils/profiling.py``: ``span``, ``count``,
``spans``, ``counters``, ``reset_spans``), on the CPU.

A small Bickley ``Simulation`` (32 x 24, float64, as ``tests/test_torch_utils.py``
builds it) with the wizard and the progress line every 10 iterations, the NaN check
every 100 and an ``OutputWriter``: under a profiler it records the expected spans and
``wait.<site>`` counts, with their parents and keys, on the profiler's clock; with no
profiler it records nothing. The file imports no jax.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models.hydrostatic import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.utils import (  # noqa: E402
    IterationInterval, OutputWriter, Simulation, TimeStepWizard, profiling,
    progress_callback)

torch.set_num_threads(1)

INIT = dict(u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
            v=lambda lam, phi: 0.1 * np.cos(np.deg2rad(lam)),
            c=lambda lam, phi: np.sin(np.deg2rad(phi)))
STOP, EVERY, WRITE_EVERY = 200, 10, 50


def make(ny=24, nx=32):
    grid = TripolarGrid.make((nx, ny, 1), dtype=torch.float64, device="cpu")
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=8),
                          device="cpu")
    return model, TH.initial_state(model, **INIT)


@pytest.fixture(scope="module")
def built():
    return make()


def simulation(built, path, async_write=False, outputs=None):
    """The loop of the benchmark's simulation mix at a small size: a run of ``STOP``
    iterations, Simulation's own NaN check every 100, the writer every
    ``WRITE_EVERY`` iterations."""
    model, state = built
    sim = Simulation(model, state, dt=60.0, stop_iteration=STOP)
    wizard = TimeStepWizard(cfl=0.3, max_change=1.1, max_dt=60.0)

    def adapt(s):
        s.dt = wizard.update(s.model, s.state, s.dt)

    sim.add_callback(adapt, IterationInterval(EVERY))
    sim.add_callback(progress_callback(lambda line: None), IterationInterval(EVERY))
    outputs = outputs or {"u": lambda s: s.state.u, "c": lambda s: s.state.c}
    sim.add_callback(OutputWriter(path, outputs, async_write=async_write),
                     IterationInterval(WRITE_EVERY))
    return sim


def profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``, the registry cleared first; returns
    (the profiler, spans, counters)."""
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof, profiling.spans(), profiling.counters()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nothing_records_without_a_profiler(built, tmp_path):
    profiling.reset_spans()
    assert profiling.span("a") is profiling.span("b", key=3)
    with profiling.span("osg.test.off", key=1):
        profiling.count("wait.test.off")
    simulation(built, str(tmp_path / "off.npz")).run()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_a_simulation_records_its_spans_and_waits_by_site(built, tmp_path):
    _, spans, counts = profiled(lambda: simulation(built, str(tmp_path / "s.npz")).run())
    n = {name: len(v) for name, v in by_name(spans).items()}
    writes = STOP // WRITE_EVERY
    assert n == {"osg.sim.wizard": STOP // EVERY, "osg.sim.progress": STOP // EVERY,
                 "osg.sim.nan_check": STOP // 100, "osg.output.copy": writes,
                 "osg.output.write": writes}  # no clone: the CPU loop keeps no buffers
    assert counts == {"wait.sim.read_clock": 2, "wait.sim.wizard": STOP // EVERY,
                      "wait.sim.progress": STOP // EVERY, "wait.sim.nan_check": STOP // 100,
                      "wait.output.copy": 2 * writes, "wait.sim.end": 1}
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in spans)
    assert {s.thread for s in spans} == {threading.get_ident()}


def test_parents_and_keys(built, tmp_path):
    def zeta(s):  # an output function with a span of its own: a child of the copy
        with profiling.span("user.output", key="zeta"):
            return s.state.v

    def run():
        simulation(built, str(tmp_path / "k.npz"), outputs={"u": lambda s: s.state.u,
                                                            "zeta": zeta}).run()

    _, spans, _ = profiled(run)
    named = by_name(spans)
    assert [s.key for s in named["osg.sim.progress"]] == list(range(EVERY, STOP + 1, EVERY))
    assert [s.key for s in named["osg.sim.nan_check"]] == [100, 200]
    assert [s.key for s in named["osg.sim.wizard"]] == [None] * (STOP // EVERY)
    assert [s.key for s in named["osg.output.copy"]] == [0, 1, 2, 3]
    assert [s.key for s in named["osg.output.write"]] == [0, 1, 2, 3]
    for s in spans:
        if s.name == "user.output":
            parent = spans[s.parent]
            assert parent.name == "osg.output.copy" and s.key == "zeta"
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        else:
            assert s.parent is None, s
    # the write follows its own copy, after it
    for c, w in zip(named["osg.output.copy"], named["osg.output.write"]):
        assert c.end_ns <= w.start_ns


def test_the_async_writer_keys_its_writes_on_its_own_thread(built, tmp_path):
    _, spans, _ = profiled(lambda: simulation(built, str(tmp_path / "a.npz"),
                                              async_write=True).run())
    named = by_name(spans)
    writes, copies = named["osg.output.write"], named["osg.output.copy"]
    main = threading.get_ident()
    assert sorted(s.key for s in writes) == [0, 1, 2, 3]
    assert main not in {s.thread for s in writes}
    assert all(s.parent is None for s in writes)
    assert {s.thread for s in copies} == {main}
    for w in writes:  # each snapshot is written after its own copy
        assert copies[w.key].end_ns <= w.start_ns


def test_nested_spans_on_two_threads_keep_their_own_parents():
    def nest(tag):
        with profiling.span(f"outer.{tag}", key=tag):
            with profiling.span(f"inner.{tag}", key=tag):
                pass

    def both():
        t = threading.Thread(target=nest, args=("b",))
        with profiling.span("outer.a", key="a"):
            t.start()
            t.join(timeout=30)
            with profiling.span("inner.a", key="a"):
                pass
        assert not t.is_alive()

    _, spans, _ = profiled(both)
    assert sorted(s.name for s in spans) == ["inner.a", "inner.b", "outer.a", "outer.b"]
    for s in spans:
        tag = s.name.split(".")[1]
        assert s.key == tag
        if s.name.startswith("inner"):
            assert spans[s.parent].name == f"outer.{tag}"
            assert spans[s.parent].thread == s.thread
        else:
            assert s.parent is None


def test_spans_agree_with_the_profilers_events(built, tmp_path):
    prof, spans, _ = profiled(lambda: simulation(built, str(tmp_path / "p.npz")).run())
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("osg."):
            events.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.start_ns() + e.duration_ns()))
    named = by_name(spans)
    assert set(events) == set(named)
    for name, mine in named.items():
        theirs = sorted(events[name])
        assert len(theirs) == len(mine), name
        for s, (a, b) in zip(mine, theirs):
            assert abs(s.start_ns - a) < 1_000_000 and abs(s.end_ns - b) < 1_000_000, name
            assert s.start_ns <= a and b <= s.end_ns  # the span holds its range


def test_the_chrome_trace_holds_the_names(built, tmp_path):
    profiling.reset_spans()
    with profiling.trace(str(tmp_path / "trace")):
        simulation(built, str(tmp_path / "t.npz")).run()
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    want = {"osg.sim.wizard", "osg.sim.progress", "osg.sim.nan_check", "osg.output.copy",
            "osg.output.write"}
    assert want <= names
    assert {s.name for s in profiling.spans()} == want


def test_reset_clears_both_and_counts_add(built):
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("wait.test")
        profiling.count("wait.test", 3)
        with profiling.span("osg.test"):
            pass
    assert profiling.counters() == {"wait.test": 4}
    assert [s.name for s in profiling.spans()] == ["osg.test"]
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.counters() == {}
