"""The simulation loop: run loop, callbacks, schedules, adaptive time stepping.

Counterpart: ``orthogonalsphericalshellgrids_tpu/utils/simulation.py``, the
Oceananigans simulation layer the reference examples use (``Simulation``, ``run!``,
``IterationInterval``, ``TimeInterval``, ``TimeStepWizard(cfl=0.3, max_change=1.1,
max_Δt)``; ``examples/bickley_jet.jl:73-89``), with the same names, schedules and
semantics.

The loop keeps the iteration and the model time as host counters: ``sim.iteration``
and ``sim.time`` never read the state, so the step chain stays queued on the card
between callbacks. Δt reaches ``step`` as one device scalar, rebuilt only when
``sim.dt`` changes (a fill launch, never a copy from the host). The card is waited
for only where a callback fires and reads a value (the wizard's CFL, the NaN check,
the progress line, an output's host copy, a checkpoint) and once when the run ends.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import re
import time
from typing import Any, Callable

import torch

from ..models.hydrostatic import compute_cfl_dt, multi_step, step
from ..models.layered import LayeredModel, layered_cfl_dt, layered_multi_step, layered_step
from .profiling import device_sync

__all__ = ["IterationInterval", "TimeInterval", "TimeStepWizard", "Simulation",
           "progress_callback", "NaNChecker", "Checkpointer"]


class IterationInterval:
    """Fires every N iterations (Oceananigans IterationInterval)."""

    def __init__(self, every: int):
        self.every = int(every)

    def __call__(self, iteration: int, t: float) -> bool:
        return iteration % self.every == 0


class TimeInterval:
    """Fires whenever simulated time crosses a multiple of ``interval`` seconds
    (Oceananigans TimeInterval)."""

    def __init__(self, interval: float):
        self.interval = float(interval)
        self._next = 0.0

    def __call__(self, iteration: int, t: float) -> bool:
        if t + 1e-9 >= self._next:
            self._next = (t // self.interval + 1) * self.interval
            return True
        return False

    def align(self, t: float) -> None:
        """Re-anchor to the model time ``t``, so that a resumed run does not fire an
        off-schedule event because ``_next`` started at 0."""
        self._next = (t // self.interval + 1) * self.interval if t > 0 else 0.0


@dataclasses.dataclass
class TimeStepWizard:
    """CFL-based Δt adaptation: new Δt = min(max_change·Δt, CFL-limited Δt, max_dt),
    at least min_change·Δt (``TimeStepWizard(cfl=0.3, max_change=1.1,
    max_Δt=3hours)``, examples/bickley_jet.jl:75). ``update`` reads the CFL Δt from
    the card."""

    cfl: float = 0.3
    max_change: float = 1.1
    min_change: float = 0.5
    max_dt: float = math.inf

    def update(self, model, state, old_dt: float) -> float:
        cfl_fn = layered_cfl_dt if isinstance(model, LayeredModel) else compute_cfl_dt
        cfl_dt = float(cfl_fn(model, state, cfl=self.cfl))
        new_dt = min(self.max_change * old_dt, cfl_dt)
        new_dt = max(new_dt, self.min_change * old_dt)
        return min(new_dt, self.max_dt)


def progress_callback(log=print):
    """The reference's progress line: iteration, time, Δt, max |u| and |v|
    (examples/bickley_jet.jl:84-87)."""

    def cb(sim: "Simulation"):
        s = sim.state
        # max |u| in one reduction (the inf-norm), both in one copy to the host: the
        # card idles while the host launches these, so they are few
        umax, vmax = torch.stack([torch.linalg.vector_norm(s.u, math.inf),
                                  torch.linalg.vector_norm(s.v, math.inf)]).tolist()
        log(f"iter {sim.iteration:6d}  t={sim.time / 86400.0:9.3f} d  "
            f"dt={sim.dt:8.1f} s  velocity: {umax:.2e} {vmax:.2e}")

    return cb


class NaNChecker:
    """Abort the run when a prognostic goes non-finite. ``Simulation`` installs one
    on ``u`` every 100 iterations, as Oceananigans does (``nan_checker=False``
    leaves it out)."""

    def __init__(self, fields=("u",)):
        self.fields = tuple(fields)

    def __call__(self, sim: "Simulation"):
        # the inf-norm (max |x|) is NaN or inf exactly when a value is, so one
        # reduction a field decides; every verdict in one copy to the host
        norms = torch.stack([torch.linalg.vector_norm(getattr(sim.state, name), math.inf)
                             for name in self.fields])
        finite = torch.isfinite(norms).tolist()
        for name, ok in zip(self.fields, finite):
            if not ok:
                raise RuntimeError(
                    f"time step aborted: non-finite values in '{name}' at "
                    f"iteration {sim.iteration}, t = {sim.time:.1f} s")


class Checkpointer:
    """Periodic checkpoint callback (the Oceananigans ``Checkpointer``): writes
    ``{prefix}_iteration{N}.npz``. ``Checkpointer.latest(prefix)`` finds the newest
    for ``Simulation.run(pickup=...)``. A checkpoint holds the state, not
    ``sim.dt``."""

    def __init__(self, prefix: str):
        self.prefix = str(prefix)

    def path_for(self, iteration: int) -> str:
        return f"{self.prefix}_iteration{iteration}.npz"

    def __call__(self, sim: "Simulation"):
        from .checkpoint import save_checkpoint

        save_checkpoint(self.path_for(sim.iteration), sim.state)

    @staticmethod
    def latest(prefix: str):
        """Newest checkpoint path for ``prefix`` (by iteration number), or None."""
        best, best_it = None, -1
        # glob metacharacters in the prefix are escaped; the iteration number is
        # anchored to the END of the name, so "_iteration<N>" elsewhere in the path
        # is ignored
        for p in glob.glob(glob.escape(prefix) + "_iteration*"):
            m = re.search(r"_iteration(\d+)(?:\.npz)?$", p)
            if m and int(m.group(1)) > best_it:
                best, best_it = p, int(m.group(1))
        return best


class Simulation:
    """The Python loop around ``step`` (``layered_step`` for a ``LayeredModel``).

    Callbacks are (schedule, fn) pairs: ``fn(sim)`` runs on the host after a step
    whose (iteration, time) the schedule accepts, and may read the state or set
    ``sim.dt`` (the TimeStepWizard). Output writers attach the same way. With
    ``steps_per_block > 1`` the loop takes that many steps between schedule checks
    (``multi_step``), so schedules fire at block boundaries.
    """

    def __init__(self, model, state, dt: float, stop_time: float = math.inf,
                 stop_iteration: int = 2**62, steps_per_block: int = 1,
                 nan_checker: bool = True):
        self.model = model
        self.state = state
        self.dt = float(dt)
        self.stop_time = float(stop_time)
        self.stop_iteration = int(stop_iteration)
        self.callbacks: list[tuple[Any, Callable]] = []
        if nan_checker:
            self.add_callback(NaNChecker(), IterationInterval(100))
        is_layered = isinstance(model, LayeredModel)
        self._step = layered_step if is_layered else step
        self._multi = layered_multi_step if is_layered else multi_step
        self.steps_per_block = int(steps_per_block)
        self._read_clock()
        self._dt_value = None
        self._dt_tensor = None
        self.wall_start = None

    def _read_clock(self):
        """Host counters from the state (waits for the card once)."""
        self._iteration = int(self.state.iteration)
        self._time = float(self.state.t)

    @property
    def iteration(self) -> int:
        return self._iteration

    @property
    def time(self) -> float:
        return self._time

    def add_callback(self, fn: Callable, schedule) -> None:
        self.callbacks.append((schedule, fn))

    def _device_dt(self, dt: float):
        """Δt as a device scalar, rebuilt only when its value changes."""
        if dt != self._dt_value:
            self._dt_value = dt
            self._dt_tensor = torch.full((), dt, dtype=self.model.dtype,
                                         device=self.model.device)
        return self._dt_tensor

    def run(self, pickup=None):
        """The reference's ``run!`` loop (examples/bickley_jet.jl:89); returns the
        final state.

        ``pickup``: a checkpoint path, or True for the newest one written by an
        attached ``Checkpointer``; the state is restored before stepping (the
        Oceananigans ``run!(sim, pickup=true)``)."""
        if pickup:
            from .checkpoint import load_checkpoint

            path = pickup
            if pickup is True:
                path = None
                for _, fn in self.callbacks:
                    if isinstance(fn, Checkpointer):
                        path = Checkpointer.latest(fn.prefix)
                        break
                if path is None:
                    raise ValueError("pickup=True needs an attached Checkpointer "
                                     "with at least one written checkpoint")
            self.state = load_checkpoint(path, self.state)
            self._read_clock()
            # time schedules re-anchored to the restored time, so that a resumed
            # run fires the events of an uninterrupted one
            for schedule, _ in self.callbacks:
                align = getattr(schedule, "align", None)
                if callable(align):
                    align(self.time)
        self.wall_start = time.time()
        it, t = self._iteration, self._time
        try:
            while t < self.stop_time and it < self.stop_iteration:
                nb = self.steps_per_block
                remaining = self.stop_time - t
                if nb > 1 and remaining >= nb * self.dt and it + nb <= self.stop_iteration:
                    self.state = self._multi(self.model, self.state,
                                             self._device_dt(self.dt), nb)
                    it += nb
                    t += nb * self.dt
                else:
                    # the last step does not overshoot stop_time
                    dt = (min(self.dt, max(remaining, 1e-12))
                          if self.stop_time < math.inf else self.dt)
                    self.state = self._step(self.model, self.state, self._device_dt(dt))
                    it += 1
                    t += dt
                self._iteration, self._time = it, t
                for schedule, fn in self.callbacks:
                    if schedule(it, t):
                        fn(self)
            device_sync(self.state)
        finally:
            # drain async output writers even on an exception or KeyboardInterrupt,
            # so that queued snapshots reach disk
            for _, fn in self.callbacks:
                close = getattr(fn, "close", None)
                if callable(close):
                    close()
        return self.state
