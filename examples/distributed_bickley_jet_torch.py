"""Distributed Bickley jet through the PyTorch port: the reference's
``examples/distributed_bickley_jet.jl`` (320 x 240, y-partitioned over 4 ranks).

Mirrors ``examples/distributed_bickley_jet.py`` (its 1-D decomposition): the grid is
built whole and each rank takes a halo-inclusive band of rows
(``parallel/distributed.py``); the zipper fold runs on the last rank only and the
others exchange their halo rows. Three exchanges:

- ``--exchange local`` (the default): the ranks are shards of this process, stepped
  in threads on one device. This is how one card runs a real decomposition through
  the kernels: NCCL refuses two ranks on one GPU.
- ``--exchange nccl``: one process a rank, one card a rank (``--ranks`` cards).
- ``--exchange gloo``: one process a rank on the CPU.

With ``--output`` every rank writes its interior to ``<stem>.rank<k>.npz``
(``ShardedOutputWriter``); ``FieldTimeSeries(output, name)`` stitches them.

The fold-aware 2-D (x, y) decomposition, which the reference rejects
(``src/distributed_tripolar_grid.jl:30-31``), runs with ``--decomp 2d --ndev-x 2
--ranks 2`` (``parallel/distributed2d.py``: ``--ranks`` blocks along y, ``--ndev-x``
along x, as the JAX example's ``--ndev``/``--ndev-x``), through the local exchange
only; its per-rank output is the 1-D decomposition's and is refused.

Run:  python examples/distributed_bickley_jet_torch.py [--ranks 4 --steps 200
      --exchange local --device cuda] [--decomp 2d --ndev-x 2]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _max_speeds(models, states):
    """max |u| and max |v| over the interiors of the shards."""
    u = max(float(m.grid.interior(s.u).abs().max()) for m, s in zip(models, states))
    v = max(float(m.grid.interior(s.v).abs().max()) for m, s in zip(models, states))
    return u, v


def run(mesh, nx, ny, steps, dt, device, output=None, log=print):
    """Build the jet on ``device``, take the shards of ``mesh`` this process holds
    (the blocks of a 2-D mesh where its shape has several x-ranks), step them
    ``steps`` times at ``dt`` and report max |u|, |v| every 50 steps. Returns (max
    |u|, max |v|, seconds a step)."""
    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch.parallel import (
        distribute, distribute2d, sharded_step_fn, sharded_step_fn2d)
    from orthogonalsphericalshellgrids_tpu_torch.utils.output import ShardedOutputWriter

    model, state = build(nx, ny, first_pole_longitude=45.0, north_poles_latitude=35.0,
                         device=device)
    if mesh.shape[1] > 1:
        dist_model, s = distribute2d(model, state, mesh)
        fn = sharded_step_fn2d(mesh, dist_model, nx)
    else:
        dist_model, s = distribute(model, state, mesh)
        fn = sharded_step_fn(mesh, dist_model)
    del model, state
    writer = ShardedOutputWriter(output, dist_model) if output else None
    s = fn(s, dt)  # loads the kernels
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, steps):
        s = fn(s, dt)
        if (i + 1) % 50 == 0:
            umax, vmax = _max_speeds(dist_model, s)
            log(f"iter {i + 1}: velocity {umax:.2e} {vmax:.2e}")
            if writer is not None:
                writer.write((i + 1) * dt, {name: [getattr(x, name) for x in s]
                                            for name in ("u", "v", "c", "eta")})
    umax, vmax = _max_speeds(dist_model, s)
    seconds = (time.perf_counter() - t0) / max(steps - 1, 1)
    fn.close()
    return umax, vmax, seconds


def _rank(rank, n, nx, ny, steps, dt, output):
    """One rank of an NCCL or gloo process group (``spawn``)."""
    import torch.distributed as dist

    from orthogonalsphericalshellgrids_tpu_torch.parallel import ProcessGroupExchange

    device = f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" \
        else "cpu"
    return run(ProcessGroupExchange(), nx, ny, steps, dt, device, output,
               log=lambda msg: print(f"rank {rank}: {msg}", flush=True))


def main(argv=None, log=print):
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=320)
    p.add_argument("--ny", type=int, default=240)
    p.add_argument("--ranks", type=int, default=4, help="ranks along y")
    p.add_argument("--ndev-x", type=int, default=1,
                   help="ranks along x (the 2-D decomposition)")
    p.add_argument("--decomp", choices=["1d", "2d"], default="1d")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--dt", type=float, default=120.0)
    p.add_argument("--exchange", choices=["local", "nccl", "gloo"], default="local")
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu, for --exchange "
                   "local; nccl runs on the cards, gloo on the CPU")
    p.add_argument("--output", default=None,
                   help="base filename of the per-rank dumps (<stem>.rank<k>.npz)")
    args = p.parse_args(argv)

    if args.decomp == "2d":
        if args.exchange != "local":
            raise SystemExit("--decomp 2d runs through the local exchange")
        if args.output:
            raise SystemExit("--output per-rank dumps follow the 1-D decomposition")
        from orthogonalsphericalshellgrids_tpu_torch.parallel import make_mesh2d

        umax, vmax, sec = run(make_mesh2d(args.ndev_x, args.ranks), args.nx, args.ny,
                              args.steps, args.dt, args.device, log=log)
        where = f"{args.ndev_x} x {args.ranks} blocks on {args.device}"
    elif args.exchange == "local":
        from orthogonalsphericalshellgrids_tpu_torch.parallel import make_mesh

        umax, vmax, sec = run(make_mesh(args.ranks), args.nx, args.ny, args.steps, args.dt,
                              args.device, args.output, log=log)
        where = f"{args.ranks} shards on {args.device}"
    else:
        from orthogonalsphericalshellgrids_tpu_torch.parallel import spawn

        if args.exchange == "nccl" and args.ranks > torch.cuda.device_count():
            raise SystemExit(f"--exchange nccl needs one card a rank: {args.ranks} ranks, "
                             f"{torch.cuda.device_count()} cards (NCCL refuses two ranks "
                             "on one GPU; use --exchange local on one card)")
        out = spawn(args.ranks, _rank, args.exchange,
                    args=(args.nx, args.ny, args.steps, args.dt, args.output))
        umax, vmax = max(o[0] for o in out), max(o[1] for o in out)
        sec = max(o[2] for o in out)
        where = f"{args.ranks} {args.exchange} ranks"
    log(f"{args.steps} steps of the {args.nx} x {args.ny} jet on {where}: final "
        f"velocity {umax:.2e} {vmax:.2e}, {sec * 1e3:.3f} ms a step "
        f"({args.nx * args.ny / sec / 1e6:.1f} M grid-points/s)")


if __name__ == "__main__":
    main()
