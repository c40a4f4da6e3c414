#!/usr/bin/env python3
"""Where the time of an ensemble's sharded step on one card goes: the 1/4-degree jet
(1440 x 680, float32, 30 substeps, dt = 60 s) or the 1/4-degree x 10 gyre (dt = 40 s)
as one member and as 4 (the base state times 0.5, 0.75, 1.0 and 1.25), serial and in
4 y-shards through ``LocalExchange``, with the overlap split and without.

    python3 benchmarks/torch_sharded_ensemble_host.py [--config gyre] [--steps 10]
        [--top 12] [--out FILE]

Each row is one window of ``--steps`` steps after 3 warm-up steps
(``torch_shard_host.window``): the host's clock over the window before the card is
waited for (``host_ms``, the time to enqueue a step) and the card's clock over it
(``run_ms``, the step as run); then 3 steps under ``torch.profiler``: device busy ms a
step (the union of device activity), the idle share of the window, and the ``--top``
host operations by self CPU time a step (calls and ms a step; the profiler records
the calling thread's operators, so the ranks' threads show as their CUDA runtime
calls, ``cudaLaunchKernel`` and the like). Prints one line per
row with the card's name and power limit, and one JSON object as its last line (also
written to ``--out``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks.torch_shard_host import card_line, window  # noqa: E402

SCALES = (0.5, 0.75, 1.0, 1.25)


def profile(fn, state, steps, top):
    """(device busy ms a step, idle share, [(op, calls a step, self CPU ms a step)])
    of ``steps`` calls ``state = fn(state)`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = fn(state)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    idle = 1.0 - busy / (spans[-1][1] - spans[0][0])
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:top]
    return (busy / 1e3 / steps, idle,
            [(a.key, a.count / steps, a.self_cpu_time_total / 1e3 / steps) for a in ops])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("jet", "gyre"), default="gyre")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("torch_sharded_ensemble_host: no CUDA device", file=sys.stderr)
        return 1
    from orthogonalsphericalshellgrids_tpu_torch import parallel
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble, layered_step
    from orthogonalsphericalshellgrids_tpu_torch.models import step as hydrostatic_step

    card = card_line()
    layered = args.config == "gyre"
    one_step = layered_step if layered else hydrostatic_step
    if layered:
        from examples.wind_driven_ts_gyre_torch import build

        model, state0 = build(1440, 680, 10, dtype=torch.float32, substeps=30,
                              device="cuda")
        dt, distribute, step_fn = (40.0, parallel.distribute_layered,
                                   parallel.sharded_layered_step_fn)
    else:
        from examples.bickley_jet_torch import build

        model, state0 = build(1440, 680, dtype=torch.float32, substeps=30, device="cuda")
        dt, distribute, step_fn = 60.0, parallel.distribute, parallel.sharded_step_fn

    def scaled(s):
        return type(state0)(**{f.name: getattr(state0, f.name) * s
                               if f.name not in ("t", "iteration")
                               else getattr(state0, f.name)
                               for f in dataclasses.fields(state0)})

    rows = []

    def report(name, host, run, busy, idle, ops):
        rows.append(dict(name=name, host_ms=host, run_ms=run, busy_ms=busy, idle=idle,
                         top_ops=ops))
        top = "; ".join(f"{k} x{n:g} {ms:.3f} ms" for k, n, ms in ops)
        print(f"{args.config} {name}: enqueue {host:.4f} ms/step, as run {run:.4f} "
              f"ms/step, device busy {busy:.4f} ms/step, idle share {idle:.3f}; host ops "
              f"by self CPU a step: {top} [{card}]", flush=True)

    for members in (1, len(SCALES)):
        state = state0 if members == 1 else ensemble.stack_members(
            [scaled(s) for s in SCALES])
        step = (lambda s: ensemble.ensemble_step(model, s, dt)) if members > 1 else (
            lambda s: one_step(model, s, dt))
        _, host, run = window(step, state, args.steps)
        report(f"{members} member(s) serial", host, run,
               *profile(step, state, 3, args.top))
        for overlap in (None, False):
            mesh = parallel.make_mesh(4)
            dist_model, dist_state = distribute(model, state, mesh)
            fn = step_fn(mesh, dist_model, overlap=overlap)
            dist_state, host, run = window(lambda s: fn(s, dt), dist_state, args.steps)
            split = "unsplit" if overlap is False else "split"
            report(f"{members} member(s) 4 y-shards {split}", host, run,
                   *profile(lambda s: fn(s, dt), dist_state, 3, args.top))
            fn.close()
            del dist_model, dist_state
        del state
        torch.cuda.empty_cache()
    out = {"card": card, "config": args.config, "steps": args.steps, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
