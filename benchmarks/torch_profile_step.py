#!/usr/bin/env python3
"""Where a step of the PyTorch port's 1/4-degree Bickley jet spends its time, on one
CUDA card.

    python3 benchmarks/torch_profile_step.py [--steps 10] [--ahead-steps 4]
                                             [--windows 3] [--out FILE]

The model is ``examples/bickley_jet_torch.build(1440, 680, float32, substeps=30)`` at
dt = 60 s, run through ``models/hydrostatic.py:multi_step``. Two paths are measured,
their windows interleaved in one process (kernel, plain, plain, kernel, ...): the
kernel path, and the plain path, which is the same step with every kernel wrapper
replaced by its plain PyTorch version. For each window:

- ``ms_step``: CUDA events around ``--steps`` steps, as a user runs them;
- ``host_ms_step``: the host clock around the same calls, before the sync (the time
  to enqueue a step, or longer where the step waits for the card);
- ``ahead_ms_step``: ``--ahead-steps`` steps enqueued while a spin kernel holds the
  card, so that the card never waits for the host. ``ahead`` records that the host had
  enqueued every launch before the card reached the first one; when it had not (a
  step that synchronises, or more launches than the launch queue holds), the window
  did not measure device-bound time and is left out of the idle share.
- ``idle_share = 1 - ahead_ms_step / ms_step``: the share of a step, as run, in which
  the card waits for the host.

Then one ``torch.profiler`` window over ``--steps`` steps of the kernel path: device
time per kernel name, device operations per step, and the union of device activity
against the window's span (the profiler slows the host, so its idle share is an upper
bound on the unprofiled one).

Prints one line per measurement with the card's name and power limit, and as its last
line one JSON object holding all of them (also written to ``--out``). Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import smi_line  # noqa: E402


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain PyTorch version."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import (barotropic, halo_fill,
                                                                 momentum, tracer_adv)

    def fill(A, loc, sign, Nx, Ny, Hx, Hy, inplace=True):
        return halo_fill.fill_halos_plain(A if inplace else A.clone(), loc, sign, Nx, Ny,
                                          Hx, Hy)

    swaps = [(halo_fill, "fill_halos", fill),
             (halo_fill, "fill_halos_group", halo_fill.fill_halos_group_plain),
             (halo_fill, "restore_strips_group", halo_fill.restore_strips_group_plain),
             (momentum, "momentum", momentum.momentum_plain),
             (tracer_adv, "tracer_adv", tracer_adv.tracer_adv_plain),
             (barotropic, "barotropic_substeps", barotropic.barotropic_substeps_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def spin_cycles_per_ms():
    """Clock cycles per millisecond of ``torch.cuda._sleep``, from one timed spin."""
    import torch

    cycles = 20_000_000
    torch.cuda._sleep(cycles)  # first call may load the kernel
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def window(model, state, n, hold_cycles=0):
    """Run ``n`` steps; returns (state, ms/step on the card, host ms/step, ahead).
    With ``hold_cycles`` the card first spins that long, so the host can enqueue
    every step before the card starts on them."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_cycles:
        torch.cuda._sleep(hold_cycles)
    start.record()
    t0 = time.perf_counter()
    state = multi_step(model, state, 60.0, n)
    host = (time.perf_counter() - t0) * 1e3 / n
    ahead = bool(hold_cycles) and not start.query()
    end.record()
    end.synchronize()
    return state, start.elapsed_time(end) / n, host, ahead


def profile_window(model, state, n):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = multi_step(model, state, 60.0, n)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return state, None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    per_name = {}
    for e in dev:
        t, c = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:14]
    return state, dict(
        device_ops_per_step=len(dev) / n, busy_ms_step=busy / 1e3 / n,
        span_ms_step=span / 1e3 / n, idle_share=1.0 - busy / span,
        top=[dict(name=k[:90], us_per_step=t / n, calls_per_step=c / n)
             for k, (t, c) in top])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ahead-steps", type=int, default=4,
                    help="steps per host-ahead window; their launches must fit the "
                         "card's launch queue")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_step: no CUDA device available", file=sys.stderr)
        return 1
    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels

    card = smi_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"tree {ROOT}", flush=True)
    model, state = build(1440, 680, dtype=torch.float32, substeps=30, device="cuda")
    kernels.reset_launch_counts()
    state, *_ = window(model, state, 3)  # builds the kernels, warms the allocator
    with plain_kernels():
        state, *_ = window(model, state, 3)
    wrapper_calls = {k: v / 3 for k, v in kernels.launch_counts().items()}
    cyc_ms = spin_cycles_per_ms()

    n = args.steps
    result = {"card": card, "steps": n, "ahead_steps": args.ahead_steps,
              "wrapper_calls_per_step": wrapper_calls,
              "kernel": [], "plain": []}
    order = ["kernel", "plain", "plain", "kernel"] * ((args.windows + 1) // 2)
    for path in order[: 2 * args.windows]:
        ctx = plain_kernels() if path == "plain" else contextlib.nullcontext()
        with ctx:
            state, ms, host, _ = window(model, state, n)
            hold = int(cyc_ms * max(50.0, 3.0 * host * args.ahead_steps))
            state, ahead_ms, _, ahead = window(model, state, args.ahead_steps,
                                               hold_cycles=hold)
        rec = dict(ms_step=ms, host_ms_step=host, ahead_ms_step=ahead_ms, ahead=ahead,
                   idle_share=(1.0 - ahead_ms / ms) if ahead else None)
        result[path].append(rec)
        print(f"{path}: {ms:.4f} ms/step as run, host {host:.4f} ms/step, "
              f"{ahead_ms:.4f} ms/step with the host ahead (ahead={ahead}), idle share "
              f"{rec['idle_share']} [{card}]", flush=True)
    state, prof = profile_window(model, state, n)
    result["profile"] = prof
    if prof is None:
        print("profiler: no device activity recorded", flush=True)
    else:
        print(f"profiler (kernel path, {n} steps): {prof['device_ops_per_step']:.1f} "
              f"device ops/step, busy {prof['busy_ms_step']:.4f} of "
              f"{prof['span_ms_step']:.4f} ms/step, idle share "
              f"{prof['idle_share']:.4f} [{card}]", flush=True)
        for row in prof["top"]:
            print(f"  {row['us_per_step']:10.2f} us/step {row['calls_per_step']:6.1f} "
                  f"calls/step  {row['name']}", flush=True)
    if not bool(torch.isfinite(state.u).all()):
        raise RuntimeError("the profiled run produced non-finite velocities")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
