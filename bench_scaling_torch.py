#!/usr/bin/env python3
"""Weak-scaling harness of the PyTorch port: the y-sharded Bickley jet over N shards.

Counterpart: ``bench_scaling.py`` (the JAX package's), with its arguments, defaults,
configuration (``examples/bickley_jet_torch.py:build`` with the poles at 45 / 35
degrees) and JSON lines. BASELINE.md's scaling metric is weak-scaling efficiency (>=
80 % at N >= 2). The per-shard problem is fixed (``--ny-per-dev`` rows); efficiency
at N = T(1) / T(N) for the N-times-larger problem. Three exchanges
(``parallel/distributed.py``):

- ``--exchange local`` (the counterpart of XLA's virtual devices): N shards of this
  process through ``LocalExchange`` on one device (``--device``, a card by default);
  sizes 1, 2, 4 by default. N shards on one card measure the sharded path's
  correctness and its host cost, not scaling: the shards' threads take turns on one
  host and one card, so the efficiency target applies to runs with a card a rank.
- ``--exchange nccl``: one process a card (``parallel.spawn``, NCCL,
  ``ProcessGroupExchange``); sizes 1, 2, 4, 8 up to the cards present. NCCL refuses two
  ranks on one card, so N above the card count is refused, never wrapped.
- ``--exchange gloo``: one process a rank on the CPU.

Each run takes one step, then times ``--steps`` steps between CUDA events on a card
(the host clock on the CPU; a process group reports its slowest rank), and then holds
the interior rows of every shard bitwise against the serial ``multi_step`` of the
whole problem from the same state (``steps`` + 1 steps): it raises if one differs.

Prints one ``weak-scaling grid-points/s`` line per N and one ``weak-scaling
efficiency`` line per N > 1 (with N = 1 among the sizes); with ``--decompose`` the
``sharded-overhead decomposition`` rows instead (``bench_scaling.py:54-113``): the
unsharded step at the local size (``serial_local_ms``), the N-shard step unsplit
(``unsplit_ms``) and with the overlap split (``overlap_ms``), best of 3 windows, and
``overlap_per_shard_core_norm_ms`` = overlap_ms * min(N, W) / N, W being the workers
that run shards at once: 1 card for ``local`` on a card, the cores on the CPU, N
cards for ``nccl``. Every line carries ``exchange`` and ``device`` (the card's name
and power limit, or the host CPU).

Run:  python3 bench_scaling_torch.py [--exchange local|nccl|gloo] [--nx 1440
      --ny-per-dev 170 --sizes 1,2,4 --substeps 30 --dt 60] [--decompose]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FIELDS = ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc")


def _jet(nx, ny, substeps, device):
    from examples.bickley_jet_torch import build

    return build(nx, ny, substeps=substeps, first_pole_longitude=45.0,
                 north_poles_latitude=35.0, device=device)


def check_serial(model, serial, shards, ranks, n):
    """Raise unless the interior rows of each shard (rank ``ranks[i]`` of ``n``) are
    bitwise the serial state's rows of that rank."""
    import torch

    for rank, s in zip(ranks, shards):
        for name in FIELDS:
            g = model.grid_ext if name in ("eta", "U", "V") else model.grid
            ny = g.Ny // n
            got = getattr(s, name)[..., g.Hy:g.Hy + ny, g.Hx:g.Hx + g.Nx]
            want = getattr(serial, name)[..., g.Hy + rank * ny:g.Hy + (rank + 1) * ny,
                                         g.Hx:g.Hx + g.Nx]
            if not torch.equal(got, want):
                raise RuntimeError(f"shard {rank} of {n}: {name} is not bitwise the "
                                   "serial run's")


def _ms(fn, state, steps, repeats=1):
    """(ms a call, state): ``repeats`` windows of ``steps`` calls of ``fn(state)``, the
    best; CUDA events on a card, the host clock on the CPU (``time_steps``)."""
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import time_steps

    best = float("inf")
    for _ in range(repeats):
        ms, state = time_steps(lambda _m, s, _dt: fn(s), None, state, None, n=steps,
                               warmup=0)
        best = min(best, ms)
    return best, state


def scaling(mesh, n, nx, ny_per_dev, steps, dt, substeps, device):
    """ms a step of the N-shard jet over ``mesh`` (the shards this process holds),
    after one step; the shards checked bitwise against serial."""
    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step
    from orthogonalsphericalshellgrids_tpu_torch.parallel import distribute, sharded_step_fn

    model, state = _jet(nx, ny_per_dev * n, substeps, device)
    dist_model, dist_state = distribute(model, state, mesh)
    fn = sharded_step_fn(mesh, dist_model)
    try:
        s = fn(dist_state, dt)
        ms, s = _ms(lambda x: fn(x, dt), s, steps)
    finally:
        fn.close()
    check_serial(model, multi_step(model, state, dt, steps + 1), s, mesh.ranks, n)
    return ms


def decomposition(mesh, n, nx, ny_per_dev, steps, dt, substeps, device):
    """``bench_scaling.py:run_decomposed``'s ms a step: the serial step at the local
    size, the N-shard step unsplit and split; each one step, then best of 3."""
    from orthogonalsphericalshellgrids_tpu_torch.models import step
    from orthogonalsphericalshellgrids_tpu_torch.parallel import distribute, sharded_step_fn

    model1, state1 = _jet(nx, ny_per_dev, substeps, device)
    out = {"serial_local_ms": _ms(lambda s: step(model1, s, dt),
                                  step(model1, state1, dt), steps, 3)[0]}
    del model1, state1
    model, state = _jet(nx, ny_per_dev * n, substeps, device)
    dist_model, dist_state = distribute(model, state, mesh)
    # "overlap" is the default, the split where it is exact (one shard has no split;
    # the port refuses overlap=True there, where the JAX package splits one shard)
    for name, overlap in (("unsplit", False), ("overlap", None)):
        fn = sharded_step_fn(mesh, dist_model, overlap=overlap)
        try:
            out[f"{name}_ms"] = _ms(lambda x: fn(x, dt), fn(dist_state, dt), steps, 3)[0]
        finally:
            fn.close()
    return out


def _rank(rank, n, what, args):
    """One rank of a process group (``spawn``): ``scaling`` or ``decomposition`` of
    its shard through ``ProcessGroupExchange``."""
    import torch
    import torch.distributed as dist

    from orthogonalsphericalshellgrids_tpu_torch.parallel import ProcessGroupExchange

    device = f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" \
        else "cpu"
    return what(ProcessGroupExchange(), n, *args, device)


def _run(what, n, args, exchange, device):
    """``what`` at N = ``n`` on ``exchange``: one value, or each rank's."""
    from orthogonalsphericalshellgrids_tpu_torch.parallel import make_mesh, spawn

    if exchange == "local":
        return [what(make_mesh(n), n, *args, device)]
    return spawn(n, _rank, exchange, args=(what, args))


def parser():
    """The command line of ``bench_scaling.py`` with ``--exchange`` and ``--device``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--ny-per-dev", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dt", type=float, default=120.0)
    p.add_argument("--substeps", type=int, default=12)
    p.add_argument("--sizes", default=None, help="comma-separated numbers of shards")
    p.add_argument("--decompose", action="store_true",
                   help="per-N overhead decomposition (see the module docstring)")
    p.add_argument("--exchange", choices=["local", "nccl", "gloo"], default="local")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu, for --exchange "
                   "local; nccl runs on the cards, gloo on the CPU")
    return p


def main(argv=None):
    import torch

    from bench_layered_torch import device_line

    args = parser().parse_args(argv)

    cards = torch.cuda.device_count()
    cores = len(os.sched_getaffinity(0))
    device = {"local": args.device, "nccl": "cuda", "gloo": "cpu"}[args.exchange]
    if args.sizes:
        sizes = [int(x) for x in args.sizes.split(",")]
    elif args.exchange == "local":
        sizes = [1, 2, 4]
    else:
        sizes = [n for n in (1, 2, 4, 8) if n <= (cards if args.exchange == "nccl"
                                                  else cores)]
    if args.exchange == "nccl" and (not sizes or max(sizes) > cards):
        raise SystemExit(f"--exchange nccl needs one card a rank: sizes {sizes}, {cards} "
                         "cards (NCCL refuses two ranks on one GPU; use --exchange local "
                         "on one card)")
    tag = {"exchange": args.exchange, "device": device_line(device)}
    run_args = (args.nx, args.ny_per_dev, args.steps, args.dt, args.substeps)

    lines = []

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    if args.decompose:
        on_card = torch.device(device).type == "cuda"
        for n in sizes:
            ranks = _run(decomposition, n, run_args, args.exchange, device)
            row = {key: max(r[key] for r in ranks) for key in ranks[0]}
            workers = {"local": 1 if on_card else cores, "nccl": n,
                       "gloo": cores}[args.exchange]
            emit({"metric": "sharded-overhead decomposition", "devices": n, **row,
                  "overlap_per_shard_core_norm_ms":
                      row["overlap_ms"] * min(n, workers) / n,
                  "strip_recompute_tax":
                      (row["overlap_ms"] - row["unsplit_ms"]) / row["unsplit_ms"],
                  **tag})
        return lines

    results = {}
    for n in sizes:
        ms = max(_run(scaling, n, run_args, args.exchange, device))
        results[n] = args.nx * args.ny_per_dev * n / (ms * 1e-3)
        emit({"metric": "weak-scaling grid-points/s", "devices": n,
              "value": round(results[n], 1), "unit": "points/s", "ms_per_step": ms,
              **tag})
    if 1 in results and len(results) > 1:
        for n in sizes:
            if n != 1:
                emit({"metric": "weak-scaling efficiency", "devices": n,
                      "value": round(results[n] / (results[1] * n), 3), "unit": "ratio",
                      **tag})
    return lines


if __name__ == "__main__":
    main()
