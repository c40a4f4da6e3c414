#!/usr/bin/env python3
"""A step's halo fills on one card: this tree's group fill with save, GU/GV group fill
and group restore against another tree's fills, on the Bickley, front and gyre
paths' fields at 1/4 degree, float32.

    python3 benchmarks/torch_fill_ab.py [--parent DIR] [--rounds 2] [--out FILE]

The fields are made as a step holds them, from a seed: u, v, c (Bickley: one
(690, 1450) plane each; front: u, v, c, b at Nz = 10; gyre: u, v at Nz = 10 and T, S
as 20 planes) on the base grid at halo 5, and η, U, V as views of one
(3, 724, 1484) buffer at halo 22, and the forcing planes GU and GV (724, 1484). Each
row is the device time of one call (``device_ms``: the card spins while the host
enqueues a window of calls, so launch latency on the host is not counted), the
median of 5 windows of 20 calls; ``called`` rows are the same calls timed as the
host issues them.

- ``this``: ``fill_halos_group`` of the state's fields with save, the GU/GV group
  without save, and ``restore_strips_group``, each alone and the three together;
- with ``--parent DIR``, another checkout of the repo (for instance the parent
  commit, unpacked with ``git archive`` under ``_checkout/``), in a child process
  that imports that tree's package: its step's fills, each state field through
  ``fill_halos(..., inplace=False)`` and GU, GV through ``fill_halos`` in place;
- ``clone``: ``torch.Tensor.clone`` of the state's fields, the same bytes as the
  parent's copies, as a yardstick of what a copy costs (no single PyTorch call
  computes a fill).

Each tree's fills are first held bitwise against ``ops/zipper.fill_halos`` on clones.
Prints one line per number with the card's name and power limit, and one JSON object
as its last line (also written to ``--out``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("Bickley", "front", "gyre")
BASE, EXT = (1440, 680, 5, 5), (1440, 680, 22, 22)


def fields(path, seed=3):
    """(the state's fields, the forcing planes) of a path, each (A, loc, sign, Nx, Ny,
    Hx, Hy), float32 on the card."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    rng = np.random.default_rng(seed)

    def cu(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device="cuda")

    K = {"Bickley": (None, None, None), "front": (10, 10, 10, 10),
         "gyre": (10, 10, 20)}[path]
    locs = [(FC, -1), (CF, -1), (CC, 1), (CC, 1)]
    state = [(cu((690, 1450) if k is None else (k, 690, 1450)), *locs[i], *BASE)
             for i, k in enumerate(K)]
    buf = cu((3, 724, 1484))
    state += [(buf[0], CC, 1, *EXT), (buf[1], FC, -1, *EXT), (buf[2], CF, -1, *EXT)]
    forcing = [(cu((724, 1484)), FC, -1, *EXT), (cu((724, 1484)), CF, -1, *EXT)]
    return state, forcing


def device_ms(fn, n=20, reps=5, warm=3):
    """Device milliseconds per call of ``fn``: each window of ``n`` calls is enqueued
    while the card spins (``torch.cuda._sleep``), so the window times the card's work
    and not the host's enqueue; the median of ``reps`` windows. The script's own
    timer, so that both trees are timed alike: another tree's ``time_ms`` may lack
    its ``ahead`` mode."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    torch.cuda._sleep(cycles)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    per_ms = cycles / start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    hold = 2.0 * (time.perf_counter() - t0) * 1e3 + 0.2
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(int(hold * per_ms))
        start.record()
        for _ in range(n):
            fn()
        ahead = not start.query()
        end.record()
        end.synchronize()
        if not ahead:
            hold *= 2.0
            continue
        times.append(start.elapsed_time(end) / n)
    times.sort()
    return times[len(times) // 2]


def called_ms(fn, n=20, reps=5, warm=3):
    """Milliseconds per call of ``fn`` as the host issues the calls (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    times.sort()
    return times[len(times) // 2]


def held(filled, originals):
    """Each filled field bitwise ``ops/zipper.fill_halos`` of a clone of its original."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.ops import zipper

    for A, (A0, *spec) in zip(filled, originals):
        torch.cuda.synchronize()
        if not torch.equal(A, zipper.fill_halos(A0.clone(), *spec, inplace=True)):
            raise RuntimeError("a fill is off zipper.fill_halos")


def time_parent_tree(rounds):
    """Child mode: this process's package (another tree's) runs its step's fills, one
    out-of-place fill a state field and GU, GV in place; JSON."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill

    out = {}
    for path in PATHS:
        state, forcing = fields(path)

        def fills():
            return ([halo_fill.fill_halos(*f, inplace=False) for f in state] +
                    [halo_fill.fill_halos(*f) for f in forcing])

        originals = state + [(f[0].clone(),) + f[1:] for f in forcing]
        held(fills(), originals)
        out[path] = {"step_fills": [device_ms(fills) for _ in range(rounds)],
                     "copies": [device_ms(lambda: [halo_fill.fill_halos(*f, inplace=False)
                                                   for f in state])
                                for _ in range(rounds)],
                     "step_fills_called": [called_ms(fills) for _ in range(rounds)]}
    print(json.dumps(out))
    return 0


def other_tree(path, rounds):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree",
                           os.path.abspath(path), "--rounds", str(rounds)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the tree at {path} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def time_this_tree(res):
    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill

    for path in PATHS:
        state, forcing = fields(path)
        saved = halo_fill.fill_halos_group(state, save=True)[1]
        halo_fill.restore_strips_group(state, saved)

        def fills():
            s = halo_fill.fill_halos_group(state, save=True)[1]
            halo_fill.fill_halos_group(forcing)
            halo_fill.restore_strips_group(state, s)

        row = res[path]["this"]
        for key, fn in (("step_fills", fills),
                        ("fill_save", lambda: halo_fill.fill_halos_group(state, True)),
                        ("fill_gu_gv", lambda: halo_fill.fill_halos_group(forcing)),
                        ("restore", lambda: halo_fill.restore_strips_group(state, saved)),
                        ("clone", lambda: [f[0].clone() for f in state])):
            row.setdefault(key, []).append(device_ms(fn))
        row.setdefault("step_fills_called", []).append(called_ms(fills))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout of the repo, timed in turn")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, args.time_tree or ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_fill_ab: no CUDA device available", file=sys.stderr)
        return 1
    if args.time_tree:
        return time_parent_tree(args.rounds)

    from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import smi_line

    card = smi_line()
    res = {"card": card, "paths": {p: {"this": {}} for p in PATHS}}
    for path in PATHS:  # this tree's group fills against zipper, and the restore
        state, forcing = fields(path)
        originals = [(f[0].clone(),) + f[1:] for f in state + forcing]
        got, saved = halo_fill.fill_halos_group(state, save=True)
        held(got + halo_fill.fill_halos_group(forcing)[0], originals)
        halo_fill.restore_strips_group(state, saved)
        torch.cuda.synchronize()
        if not all(torch.equal(f[0], o[0]) for f, o in zip(state, originals)):
            raise RuntimeError(f"{path}: the restore did not give the fields back")
        print(f"{path}: group fills held bitwise, restore bitwise [{card}]", flush=True)
    for rnd in range(args.rounds):
        if args.parent and rnd % 2 == 0:
            other = other_tree(args.parent, 1)
            for path in PATHS:
                p = res["paths"][path].setdefault("parent", {})
                for key, val in other[path].items():
                    p.setdefault(key, []).extend(val)
        time_this_tree(res["paths"])
    if args.parent:
        other = other_tree(args.parent, 1)
        for path in PATHS:
            for key, val in other[path].items():
                res["paths"][path]["parent"][key].extend(val)
    for path, rows in res["paths"].items():
        for tree, row in rows.items():
            for key, val in row.items():
                print(f"{path} {tree} {key}: {', '.join(f'{t:.4f}' for t in val)} ms "
                      f"[{card}]", flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
