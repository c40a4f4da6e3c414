"""``utils.Simulation.run`` as users drive it: a ``TimeStepWizard`` capped at the
configuration's Δt, the progress line, the NaN check and an ``OutputWriter`` of the
mix's fields, written synchronously into ``TMPDIR``, each on the mix's schedule. The
harness registers every callback itself (``nan_checker=False`` and its own
``NaNChecker``) and times each by the host clock. The warm-up runs
``warm_iterations`` iterations (the capture, every callback once, the first
snapshot); the window then runs until the first write once ``--seconds`` have passed,
so that it holds whole cycles of steps and a write.

An output field is ``{"field": <state field>}`` or ``{"diagnostic": <function of
models.diagnostics>}``. The check follows the 10 steps (the wizard's interval) before
two writes, one drawn from the seed among the first ``sample_writes`` of the window and
the last, and compares the snapshots read back from the archive.
"""

from __future__ import annotations

import os
import time

from perfbench.lib import drive, program, trace


class _Timed:
    """A callback timed by the host clock (its close passed on). The card is waited
    for before the clock starts: every callback of the mix reads the card and would
    wait there for the steps queued before it, which are not its cost."""

    def __init__(self, fn, times, device):
        self.fn, self.times, self.device = fn, times, device

    def __call__(self, sim):
        drive.sync(self.device)
        t = time.perf_counter()
        self.fn(sim)
        self.times.append(time.perf_counter() - t)

    def close(self):
        close = getattr(self.fn, "close", None)
        if callable(close):
            close()


def output(spec):
    """The writer's function of one output field of the mix."""
    if "diagnostic" in spec:
        fn = program.entry("models.diagnostics." + spec["diagnostic"])
        return lambda s: fn(s.model, s.state)
    return lambda s: getattr(s.state, spec["field"])


def run(ctx):
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        IterationInterval, NaNChecker, OutputWriter, Simulation, TimeInterval,
        TimeStepWizard, progress_callback)

    cfg, tr = ctx.config, ctx.traffic
    dt = cfg["dt"]
    drive.sync(ctx.device)
    ctx.marks.append(("imports and card", time.time()))
    model, state = program.build(cfg, ctx.inputs, ctx.device, drive.marker(ctx))
    drive.sync(ctx.device)
    init = program.full_host_state(state)
    sim = Simulation(model, state, dt=dt, nan_checker=False)
    times = {name: [] for name in ("wizard", "progress", "nan", "writer")}
    wiz = tr["wizard"]
    wizard = TimeStepWizard(cfl=wiz["cfl"], max_change=wiz["max_change"], max_dt=dt)
    log = []
    out = os.path.join(ctx.tmpdir, "output.npz")
    writer = OutputWriter(out, {name: output(spec)
                                for name, spec in tr["output"]["fields"].items()})
    dts = []

    def adapt(s):
        s.dt = wizard.update(s.model, s.state, s.dt)
        dts.append(s.dt)

    dev = ctx.device
    sim.add_callback(_Timed(adapt, times["wizard"], dev), IterationInterval(wiz["interval"]))
    sim.add_callback(_Timed(progress_callback(log.append), times["progress"], dev),
                     IterationInterval(tr["progress_interval"]))
    sim.add_callback(_Timed(NaNChecker(), times["nan"], dev),
                     IterationInterval(tr["nan_interval"]))
    sim.add_callback(_Timed(writer, times["writer"], dev),
                     TimeInterval(tr["output"]["interval_s"]))
    # the check's states: the full state 10 iterations before a write and at it; the
    # run's stop: at the first write once the window has passed and the write drawn
    # from the seed is kept
    every = int(round(tr["output"]["interval_s"] / dt))
    n_back = wiz["interval"]
    k = 1 + drive.pick(ctx.seed, tr["sample_writes"])
    held, pairs = {}, {}
    window = [None]

    def keep(s):
        it = s.iteration
        if it % every == every - n_back:
            held[it + n_back] = (s.state, s.dt)
        elif it % every == 0 and it in held:
            pre, step_dt = held.pop(it)
            j = it // every
            if j == k or "last" not in pairs or pairs["last"][0] < j:
                pairs["sample" if j == k else "last"] = (j, pre, s.state, step_dt)
        if (window[0] is not None and it % every == 0 and "sample" in pairs
                and time.perf_counter() - window[0] >= drive.window(ctx)):
            s.stop_iteration = it

    sim.add_callback(keep, IterationInterval(n_back))
    sim.stop_iteration = tr["warm_iterations"]
    sim.run()  # the capture, every callback once, the first snapshot
    drive.sync(ctx.device)
    ctx.marks.append(("warm", time.time()))
    pairs.clear()
    dts.clear()
    it0, time0 = sim.iteration, sim.time
    ctx.marks.append(("window", time.time()))
    setup_s = ctx.marks[-1][1] - ctx.t_start
    before = drive.launches()
    for v in times.values():
        v.clear()
    prof = trace.profiler() if ctx.trace else None
    sim.stop_iteration = 2 ** 62
    window[0] = t0 = time.perf_counter()
    final = sim.run()
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    launches = drive.diff(drive.launches(), before)
    peak = drive.peak(ctx.device)
    checks = dict(inits=[("", ctx.inputs["init"], init)], pairs=[], snapshots=[],
                  archive=out, fields=tr["output"]["fields"])
    for label in ("sample", "last"):
        if label in pairs:
            j, pre, post, step_dt = pairs[label]
            checks["pairs"].append((f"write_{label}", program.full_host_state(pre),
                                    program.full_host_state(post), step_dt, n_back))
            checks["snapshots"].append((f"write_{label}", j))
    run = dict(setup_s=setup_s, window_s=window_s, steps=sim.iteration - it0, members=1,
               sim_seconds=sim.time - time0, memory_peak_bytes=peak, launches=launches,
               capture_s=drive.capture_seconds(model), callbacks=times,
               writes=len(times["writer"]), dt_min=min(dts, default=dt), checks=checks,
               trace=trace.summary(prof, window_s) if prof is not None else None)
    del model, state, sim, final, pairs, held
    return run
