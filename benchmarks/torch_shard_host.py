#!/usr/bin/env python3
"""Where the host time of a y-partitioned step on one card goes: the 1/4-degree
Bickley jet (1440 x 680, halo 5, float32, 30 substeps, dt = 60 s) in n = 1, 2 and 4
shards.

    python3 benchmarks/torch_shard_host.py [--steps 20] [--rounds 2] [--out FILE]

Each row is one window of ``--steps`` steps after 3 warm-up steps: ``host_ms`` is the
host's clock over the window before the card is waited for (the time to enqueue a
step), ``run_ms`` the card's clock from the window's first launch to its last (CUDA
events; the step as run). The rows:

- ``serial``: ``models.step`` of the whole plane;
- ``threads n``: ``parallel.sharded_step_fn`` through ``LocalExchange`` (one thread a
  shard, taking turns), with a rank's host time a step waiting for its turn, at the
  start and at both exchanges (``wait_ms``), inside its step (``step_ms``, its
  exchanges included) and inside its exchanges (``exchange_ms``, their waits
  included): the rank's own work is ``step_ms`` less ``exchange_ms``;
- ``one thread n``: the same shard models stepped one after another in the calling
  thread with the serial fills and no exchange. This is not the sharded physics,
  only the host cost of n quarter-plane steps without threads or exchange.

Prints one line per row with the card's name and power limit, and one JSON object as
its last line (also written to ``--out``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def window(fn, state, steps, reset=None):
    """(state, host ms a step, run ms a step) of ``steps`` calls ``state = fn(state)``
    after 3 warm-up calls, ``reset()`` called just before the window."""
    import torch

    for _ in range(3):
        state = fn(state)
    torch.cuda.synchronize()
    if reset is not None:
        reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state = fn(state)
    end.record()
    host = (time.perf_counter() - t0) / steps * 1e3
    end.synchronize()
    return state, host, start.elapsed_time(end) / steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_shard_host: no CUDA device", file=sys.stderr)
        return 1
    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import parallel
    from orthogonalsphericalshellgrids_tpu_torch.models import step
    from orthogonalsphericalshellgrids_tpu_torch.parallel import distributed

    card = card_line()
    dt = 60.0
    model, state0 = build(1440, 680, dtype=torch.float32, substeps=30, device="cuda")

    class TimedExchange(distributed.LocalExchange):
        """``LocalExchange`` with each rank's time waiting for its turn, and inside
        its exchanges, summed."""

        waited = collections.defaultdict(float)
        exchanged = collections.defaultdict(float)

        def _wait_turn(self, rank):
            t0 = time.perf_counter()
            try:
                return super()._wait_turn(rank)
            finally:
                self.waited[rank] += time.perf_counter() - t0

        def __call__(self, rank, send, part_len):
            t0 = time.perf_counter()
            try:
                return super().__call__(rank, send, part_len)
            finally:
                self.exchanged[rank] += time.perf_counter() - t0

    stepped = collections.defaultdict(float)

    def timed_step(m, s, dt, spmd=None):
        t0 = time.perf_counter()
        try:
            return step(m, s, dt, spmd=spmd)
        finally:
            stepped[spmd.rank] += time.perf_counter() - t0

    rows = []

    def report(name, host, run, **extra):
        rows.append(dict(name=name, host_ms=host, run_ms=run, **extra))
        more = "".join(f"; {k} {v}" for k, v in extra.items())
        print(f"{name}: enqueue {host:.4f} ms/step, as run {run:.4f} ms/step{more} "
              f"[{card}]", flush=True)

    for r in range(args.rounds):
        _, host, run = window(lambda s: step(model, s, dt), state0, args.steps)
        report(f"round {r} serial", host, run)
        for n in (1, 2, 4):
            mesh = TimedExchange(n)
            dist_model, dist_state = parallel.distribute(model, state0, mesh)
            fn = distributed.ShardedStep(mesh, dist_model, timed_step)

            def reset():
                TimedExchange.waited.clear()
                TimedExchange.exchanged.clear()
                stepped.clear()

            dist_state, host, run = window(lambda s: fn(s, dt), dist_state, args.steps,
                                           reset)
            fn.close()

            def per_step(acc):
                return {k: round(acc[k] / args.steps * 1e3, 4) for k in range(n)}

            report(f"round {r} threads {n}", host, run,
                   wait_ms=per_step(TimedExchange.waited), step_ms=per_step(stepped),
                   exchange_ms=per_step(TimedExchange.exchanged))
            _, host, run = window(
                lambda ss: [step(m, x, dt) for m, x in zip(dist_model, ss)], dist_state,
                args.steps)
            report(f"round {r} one thread {n}", host, run)
            del dist_model, dist_state
    out = {"card": card, "steps": args.steps, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
