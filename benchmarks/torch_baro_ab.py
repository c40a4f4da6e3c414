#!/usr/bin/env python3
"""The barotropic subcycle's two Hopper designs, and another tree's kernel, on one card.

    python3 benchmarks/torch_baro_ab.py [--parent DIR] [--rounds 3] [--out FILE]

At the main paths' shape ((724, 1484), 21 SM05 substeps, float32, no per-substep
wrap), on seeded random inputs made as ``tests/test_torch_cuda.py`` makes them, it
times with CUDA events (``utils/profiling.py:time_ms``), in turns:

- A, the port's kernel: time tiles with trapezoidal halos, ``csrc/barotropic.cu`` run
  as ``kernels/barotropic.py:launch_plan`` says;
- B, one persistent cooperative launch, one CTA an SM owning a tile for all substeps,
  a grid barrier and an edge exchange every substep, the 9 static planes streamed
  from L2 (``benchmarks/baro_persistent.cu``, built here with the port's nvcc flags
  into ``benchmarks/_build/``; it is a measurement, not part of the port);
- with ``--parent DIR``, the kernel of another checkout of the repo (for instance the
  parent commit, unpacked with ``git archive`` under ``_checkout/``): this script
  re-runs itself with DIR first on the path, so that the other tree builds and times
  its own ``barotropic_substeps`` on the same inputs, between the rounds of A and B.

Each design is first held against ``barotropic_substeps_plain`` on the interior
(band 1e-5). Then B's time at 1, 7 and 21 substeps (its cost a substep), and the
substep probe's rate (``benchmarks/torch_roofline.py:baro_sol_rate``), over which the
call's 21 x 724 x 1484 point-substeps give the math bound and each design its
multiple of it. Prints one line per number with the card's name and power limit, and
one JSON object as its last line (also written to ``--out``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, SUBSTEPS, NX, HX = (724, 1484), 30, 1440, 22
B_SOURCE = os.path.join(ROOT, "benchmarks", "baro_persistent.cu")


def inputs(seed=2024):
    """Static planes 0.5 + U(0, 1) with 0/1 masks, eta, U, V ~ 0.01 N(0, 1), GU, GV ~
    1e-3 N(0, 1), dtau = 0.01 and the 21 SM05 weights, float32 on the card."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)

    rng = np.random.default_rng(seed)

    def cu(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    static = cu(rng.random((9, *SHAPE)) + 0.5)
    static[7:] = (static[7:] > 0.6).float()
    dyn = [cu(0.01 * rng.standard_normal(SHAPE)) for _ in range(3)]
    dyn += [cu(1e-3 * rng.standard_normal(SHAPE)) for _ in range(2)]
    return (static, *dyn, cu(0.01), cu(averaging_weights(SUBSTEPS)[1]))


def held(got, want):
    """max |got - want| / max |want| over the interior, of the three averages."""
    I = (slice(HX, -HX), slice(HX, -HX))
    return max(float((g[I] - w[I]).abs().max() / w[I].abs().max())
               for g, w in zip(got, want))


def time_tree(rounds):
    """Child mode: this tree's ``barotropic_substeps`` on the inputs; prints JSON."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import barotropic
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import time_ms

    args = (*inputs(), NX, HX, False)
    rel = held(barotropic.barotropic_substeps(*args),
               barotropic.barotropic_substeps_plain(*args))
    torch.cuda.synchronize()
    ms = [time_ms(lambda: barotropic.barotropic_substeps(*args)) for _ in range(rounds)]
    print(json.dumps({"ms": ms, "rel": rel}))
    return 0


def build_b():
    """Design B's library, built with the port's nvcc flags (cached by content)."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import _build

    lib = str(_build.standalone(B_SOURCE, os.path.join(ROOT, "benchmarks", "_build")))
    fn = ctypes.CDLL(lib).osg_barotropic_persistent_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def design_b(fn):
    import torch

    def run(static, eta, U, V, GU, GV, dtau, weights):
        pub = torch.empty((6, *SHAPE), device="cuda")  # every cell read is written first
        acc = torch.empty((3, *SHAPE), device="cuda")
        err = fn(static.data_ptr(), eta.data_ptr(), U.data_ptr(), V.data_ptr(),
                 GU.data_ptr(), GV.data_ptr(), pub.data_ptr(), acc.data_ptr(),
                 dtau.data_ptr(), weights.data_ptr(), int(weights.shape[0]), *SHAPE,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"design B: CUDA error {err} at launch")
        return acc[0], acc[1], acc[2]

    return run


def other_tree(path, rounds):
    """The other tree's times, from a child process of this script."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree",
                           os.path.abspath(path), "--rounds", str(rounds)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the tree at {path} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout of the repo, timed in turn")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, args.time_tree or ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_baro_ab: no CUDA device available", file=sys.stderr)
        return 1
    if args.time_tree:
        return time_tree(args.rounds)

    from benchmarks.torch_roofline import baro_sol_rate
    from orthogonalsphericalshellgrids_tpu_torch.kernels import barotropic
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import smi_line, time_ms

    card = smi_line()
    run_b = design_b(build_b())
    inp = inputs()
    a_args = (*inp, NX, HX, False)
    want = barotropic.barotropic_substeps_plain(*a_args)
    res = {"card": card, "A_rel": held(barotropic.barotropic_substeps(*a_args), want),
           "B_rel": held(run_b(*inp), want), "A_ms": [], "B_ms": [], "parent_ms": []}
    for name in ("A", "B"):
        if not res[f"{name}_rel"] <= 1e-5:
            raise RuntimeError(f"design {name} is off the plain version: "
                               f"{res[name + '_rel']:.3e}")
    print(f"held against the plain version: A {res['A_rel']:.3e}, B {res['B_rel']:.3e} "
          f"(band 1e-5) [{card}]", flush=True)
    for rnd in range(args.rounds):
        if args.parent and rnd % 2 == 0:
            other = other_tree(args.parent, 1)
            res["parent_ms"] += other["ms"]
            res["parent_rel"] = other["rel"]
        order = ("A", "B") if rnd % 2 == 0 else ("B", "A")
        for name in order:
            fn = (lambda: barotropic.barotropic_substeps(*a_args)) if name == "A" else \
                (lambda: run_b(*inp))
            res[f"{name}_ms"].append(time_ms(fn))
    if args.parent:
        other = other_tree(args.parent, 1)
        res["parent_ms"] += other["ms"]
    res["B_by_substeps"] = {n: time_ms(lambda: run_b(*inp[:7], inp[7][:n].contiguous()))
                            for n in (1, 7, 21)}
    rate, _ = baro_sol_rate()
    res["probe_pts_per_s"] = rate
    res["math_bound_ms"] = 21 * SHAPE[0] * SHAPE[1] / rate * 1e3
    plan = barotropic.launch_plan(*SHAPE, 21, torch.float32)
    res["A_plan"] = {"launches": plan.launches, "window": plan.window, "tile": plan.tile,
                     "grid": plan.grid}
    for name in ("parent", "A", "B"):
        if res[f"{name}_ms"]:
            ms = res[f"{name}_ms"]
            print(f"{name}: {', '.join(f'{t:.4f}' for t in ms)} ms, "
                  f"{min(ms) / res['math_bound_ms']:.2f}x the math bound [{card}]",
                  flush=True)
    by_n = ", ".join(f"{t:.4f}" for t in res["B_by_substeps"].values())
    print(f"B at 1, 7 and 21 substeps: {by_n} ms [{card}]", flush=True)
    print(f"substep probe {rate / 1e9:.2f} G point-substeps/s: math bound "
          f"{res['math_bound_ms']:.4f} ms; A's plan {res['A_plan']} [{card}]", flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
