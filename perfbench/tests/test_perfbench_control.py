"""The check that decides ``correct`` fails where it should, on the CPU at a small size,
each cell's limits as committed: the control (the reference put in the program's
place in bfloat16, the precision below the configuration's float32) fails a number
of every cell, while the program passes; and a run of each cell with its timed path
broken underneath comes out not correct: a step that returns its state unchanged, a
tracer left unchanged or its tendency dropped, an answer altered where it is produced
(a state field, a written snapshot), and in the ensemble half of the batch left
out."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import control
from perfbench.lib import cells, program

import perfbench.run as harness

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
BLOCKS = [n for n in CELLS if cells.cell(n).traffic["driver"] == "blocks"]
SIMULATION = [n for n in CELLS if cells.cell(n).traffic["driver"] == "simulation"]


def small(name):
    """The cell at 48 x 48, an ensemble of 6 members, a write every 30 steps."""
    cell = cells.cell(name)
    cell.config.update(nx=48, ny=48)
    tr = cell.traffic
    if "members" in tr:
        tr["members"] = 6
    if tr["driver"] == "simulation":
        tr["output"]["interval_s"] = cell.config["dt"] * 30
        tr["warm_iterations"] = 20
    return cell


def run(cell, seconds=0.5):
    out, rows, _ = harness.execute(cell, 2 ** 31 + 5, seconds, 0, device="cpu")
    return out


def broken(monkeypatch, change):
    """The entries of the port replaced by their result passed through
    ``change(input state, output state)``."""
    real = program.entry

    def entry(path):
        fn = real(path)

        def block(model, s, dt, n):
            return change(s, fn(model, s, dt, n))

        return block

    monkeypatch.setattr(program, "entry", entry)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    cell = small(name)
    got = control.readings(cell, 17, 0.5, True, device="cpu")
    assert all(got["program"][k] <= lim for k, lim in cell.limits.items()), got
    assert any(got["control"][k] > lim for k, lim in cell.limits.items()), got


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert run(small(name))["correct"]


@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_whose_step_returns_its_state_are_not_correct(name, monkeypatch):
    broken(monkeypatch, lambda s, out: s)
    assert not run(small(name))["correct"]


@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_that_leave_the_tracer_unchanged_are_not_correct(name, monkeypatch):
    broken(monkeypatch, lambda s, out: dataclasses.replace(out, c=s.c.clone()))
    out = run(small(name))
    assert not out["correct"] and out["checks"]["block_gap"]["value"] >= 0.99


@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_without_the_tracer_tendency_are_not_correct(name, monkeypatch):
    from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv

    def dropped(c, u, v, static, *args, out=None, **kw):
        return torch.zeros_like(c) if out is None else out.zero_()

    monkeypatch.setattr(tracer_adv, "tracer_adv", dropped)
    assert not run(small(name))["correct"]


@pytest.mark.parametrize("name", BLOCKS)
def test_blocks_with_an_altered_answer_are_not_correct(name, monkeypatch):
    def altered(s, out):
        out.eta[..., 30, 30] += float(out.eta.abs().max())
        return out

    broken(monkeypatch, altered)
    assert not run(small(name))["correct"]


@pytest.mark.parametrize("name", [n for n in BLOCKS if "members" in cells.cell(n).traffic])
def test_an_ensemble_with_half_its_members_left_out_is_not_correct(name, monkeypatch):
    def half(s, out):
        n = s.u.shape[0] // 2
        return type(out)(**{f.name: torch.cat([getattr(out, f.name)[:n],
                                               getattr(s, f.name)[n:]])
                            for f in dataclasses.fields(out)})

    broken(monkeypatch, half)
    assert not run(small(name))["correct"]


@pytest.mark.parametrize("name", SIMULATION)
def test_a_simulation_whose_step_returns_its_state_is_not_correct(name, monkeypatch):
    from orthogonalsphericalshellgrids_tpu_torch.utils import graph

    monkeypatch.setattr(graph, "run", lambda step, model, state, dt, n, keeper=None: state)
    assert not run(small(name))["correct"]


@pytest.mark.parametrize("name", SIMULATION)
def test_a_simulation_with_an_altered_snapshot_is_not_correct(name, monkeypatch):
    driver = cells.driver("simulation")
    real = driver.output

    def altered(spec):
        fn = real(spec)
        return lambda s: fn(s) * 1.1

    monkeypatch.setattr(driver, "output", altered)
    monkeypatch.setattr(cells, "driver", lambda name: driver)
    out = run(small(name))
    assert not out["correct"] and out["checks"]["write_gap"]["value"] > \
        out["checks"]["write_gap"]["limit"]
