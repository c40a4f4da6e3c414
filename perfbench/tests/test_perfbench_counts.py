"""The operation counts of ``perfbench/counts/`` against the operations the frozen
reference's plain version of each stage performs at the same shape, tallied by a
``TorchDispatchMode``: no count exceeds its tally, so no share of a roofline or of
the peak that the counts set can pass 100 % for counting too many operations."""

from __future__ import annotations

import importlib.util
import json
import pathlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench.lib import scenario
from perfbench.reference import model as ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
# one operation an output element; a reduction one an input element
ELEMENTWISE = {"add", "sub", "rsub", "mul", "div", "neg", "pow", "sqrt", "abs",
               "reciprocal", "exp", "sin", "cos", "maximum", "minimum", "addcmul",
               "addcdiv"}
REDUCTIONS = {"sum", "cumsum"}


class Tally(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in ELEMENTWISE and torch.is_tensor(out):
            self.ops += out.numel()
        elif name in REDUCTIONS:
            self.ops += args[0].numel()
        return out


def tally(fn, *args):
    with Tally() as t:
        fn(*args)
    return t.ops


def count(stage, cfg):
    spec = importlib.util.spec_from_file_location(f"count_{stage}",
                                                  ROOT / "counts" / f"{stage}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count(cfg)


def setup(name, **over):
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    cfg.update(dtype="float64", nx=48, ny=32, **over)
    inp = scenario.inputs(cfg, 3)
    m = ref.build(cfg, inp)
    s = ref.initial_state(m, inp["init"])
    s = ref.step(m, s, cfg["dt"])  # a state with tendencies
    return cfg, m, s


JET = setup("bickley_jet_q")


def test_barotropic_count_is_at_most_the_reference_tally():
    cfg, m, s = JET
    u, v, c, eta, U, V = ref.fill_state(m, s)
    dt = torch.tensor(cfg["dt"], dtype=torch.float64)
    ops, nbytes = count("barotropic", cfg)
    assert 0 < ops <= tally(ref.barotropic, m, eta, U, V, torch.zeros_like(U),
                            torch.zeros_like(V), dt)
    assert nbytes > 0


def test_step_count_is_at_most_the_reference_tally():
    cfg, m, s = JET
    ops, nbytes = count("step", cfg)
    assert 0 < ops <= tally(ref.step, m, s, cfg["dt"])
    assert nbytes > 0


@pytest.mark.parametrize("stage", ["momentum", "tracer"])
def test_step_count_covers_its_stages_under_their_tallies(stage):
    """The step's operations beyond the subcycle stay under what the reference's
    momentum and tracer tendencies perform."""
    cfg, m, s = JET
    u, v, c, eta, U, V = ref.fill_state(m, s)
    rest = count("step", cfg)[0] - count("barotropic", cfg)[0]
    tallies = {"momentum": tally(ref.momentum, m, u, v), "tracer": tally(ref.tracer, m, c, u, v)}
    assert 0 < rest <= sum(tallies.values())
    assert tallies[stage] > 0
