#!/usr/bin/env python3
"""The momentum kernel against another tree's, and the tracer kernel's dGc fold
against another tree's kernel and add; on one card.

    python3 benchmarks/torch_mom_ab.py [--parent DIR] [--rounds 3] [--out FILE]

At the main paths' three shapes, float32, on seeded random inputs made as
``chip_smoke.py`` phase 2 makes them (each fused term 1e-1 to 1 of the tendency):

- ``one_layer``: one masked (690, 1450) layer, the Bickley jet's call;
- ``layered``: (10, 690, 1450) with ``acc`` (the vertical kernel's dGu, dGv) and
  ``mask_out``, the front's call;
- ``closures``: the same with the ν_h and quadratic-drag planes, the gyre's call;

it times with CUDA events (``utils/profiling.py:time_ms``), in turns:

- this tree's ``kernels/momentum.py:momentum``;
- with ``--parent DIR``, the kernel of another checkout of the repo (for instance the
  parent commit, unpacked with ``git archive`` under ``_checkout/``), in a child
  process that imports that tree's package: its ``momentum`` alone and, where this
  tree folds ``acc`` and ``mask_out`` into the kernel, its ``momentum`` followed by
  the torch adds and mask multiplies the fold replaces, so that the two compare like
  for like.

The layered tracer kernel too, at the front's (c, 10 planes, S = 1) and the gyre's
(T and S, 20 planes, S = 4, kappa_h) shapes over masked velocities: this tree's
``tracer_adv`` with ``acc`` (dGc) and without, and the other tree's without, then
with the add the fold replaces.

Each is first held against the plain version of its own tree (band 1e-5). Prints one
line per number with the card's name and power limit, and one JSON object as its last
line (also written to ``--out``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("one_layer", "layered", "closures")
YB, XB, NZ = 690, 1450, 10
BAND = 1e-5


def inputs(shape, seed=2024):
    """(u, v, static, keyword arguments) of one shape, float32 on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def cu(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    one = shape == "one_layer"
    dims = (YB, XB) if one else (NZ, YB, XB)
    u, v = cu(rng.standard_normal(dims)), cu(rng.standard_normal(dims))
    st = rng.random((10 if one else 8, YB, XB)) + 1.0
    st[3] = 0.1 * rng.standard_normal((YB, XB))
    if one:
        st[8:] = st[8:] > 1.15
        return u, v, cu(st), dict(has_mask=True)
    kw = dict(has_mask=False, acc=(cu(0.5 * rng.standard_normal(dims)),
                                   cu(0.5 * rng.standard_normal(dims))),
              mask_out=(cu(rng.random(dims) > 0.15), cu(rng.random(dims) > 0.15)))
    if shape == "closures":
        lay = rng.random((NZ, 8, YB, XB)) + 0.5
        lay[:, 6:] *= 0.1
        kw.update(lay=cu(lay.reshape(NZ * 8, YB, XB)), has_lap=True, has_drag=True)
    return u, v, cu(st), kw


TRACER_SHAPES = ("tracer_front", "tracer_gyre")


def tracer_inputs(shape, seed=7):
    """(args, acc) of one layered tracer call, float32 on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def cu(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    n_tr, S = (1, 1) if shape == "tracer_front" else (2, 4)
    mask = rng.random((NZ, YB, XB)) > 0.15
    pack = (mask[:, None] * (0.5 + rng.random((NZ, S, YB, XB)))).reshape(S * NZ, YB, XB)
    args = (cu(rng.standard_normal((n_tr * NZ, YB, XB))),
            cu(rng.standard_normal((NZ, YB, XB)) * mask),
            cu(rng.standard_normal((NZ, YB, XB)) * mask), cu(pack),
            cu(0.5 + rng.random((2, YB, XB))), cu(np.full(NZ, 100.0)))
    return args, cu(0.5 * rng.standard_normal((n_tr * NZ, YB, XB)))


def held(got, want, R=3):
    return max(float((g[..., R:-R, R:-R] - w[..., R:-R, R:-R]).abs().max()
                     / w[..., R:-R, R:-R].abs().max()) for g, w in zip(got, want))


def unfolded(kw):
    """The keywords without ``acc``/``mask_out``, and the torch glue that applies them
    after the kernel (the parent tree's models/layered.py)."""
    base = {k: a for k, a in kw.items() if k not in ("acc", "mask_out")}
    acc, mask = kw.get("acc"), kw.get("mask_out")

    def glue(Gu, Gv):
        if acc is not None:
            Gu, Gv = Gu + acc[0], Gv + acc[1]
        if mask is not None:
            Gu, Gv = Gu * mask[0], Gv * mask[1]
        return Gu, Gv

    return base, glue


def time_tree(rounds):
    """Child mode: this process's ``momentum`` (another tree's) with the glue; JSON."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import momentum
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import time_ms

    out = {}
    for shape in SHAPES:
        u, v, st, kw = inputs(shape)
        base, glue = unfolded(kw)
        rel = held(glue(*momentum.momentum(u, v, st, **base)),
                   glue(*momentum.momentum_plain(u, v, st, **base)))
        if not rel <= BAND:
            raise RuntimeError(f"{shape}: the tree's kernel is off its plain version: {rel}")
        out[shape] = {
            "rel": rel,
            "kernel_ms": [time_ms(lambda: momentum.momentum(u, v, st, **base))
                          for _ in range(rounds)],
            "with_glue_ms": [time_ms(lambda: glue(*momentum.momentum(u, v, st, **base)))
                             for _ in range(rounds)]}
    from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv

    for shape in TRACER_SHAPES:
        args, acc = tracer_inputs(shape)
        rel = held([tracer_adv.tracer_adv(*args) + acc],
                   [tracer_adv.tracer_adv_plain(*args) + acc])
        if not rel <= BAND:
            raise RuntimeError(f"{shape}: the tree's kernel is off its plain version: {rel}")
        out[shape] = {
            "rel": rel,
            "kernel_ms": [time_ms(lambda: tracer_adv.tracer_adv(*args))
                          for _ in range(rounds)],
            "with_glue_ms": [time_ms(lambda: tracer_adv.tracer_adv(*args) + acc)
                             for _ in range(rounds)]}
    print(json.dumps(out))
    return 0


def other_tree(path, rounds):
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
        print("torch_mom_ab: no CUDA device available", file=sys.stderr)
        return 1
    if args.time_tree:
        return time_tree(args.rounds)

    from orthogonalsphericalshellgrids_tpu_torch.kernels import momentum
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import smi_line, time_ms

    card = smi_line()
    res = {"card": card, "tile": momentum.TILE[torch.float32], "shapes": {}}
    data = {shape: inputs(shape) for shape in SHAPES}
    for shape, (u, v, st, kw) in data.items():
        rel = held(momentum.momentum(u, v, st, **kw), momentum.momentum_plain(u, v, st, **kw))
        if not rel <= BAND:
            raise RuntimeError(f"{shape}: off the plain version, {rel:.3e}")
        res["shapes"][shape] = {"this": {"rel": rel, "ms": []}}
        print(f"{shape}: held against the plain version, {rel:.2e} (band {BAND:g}) [{card}]",
              flush=True)
    from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv

    tracers = {shape: tracer_inputs(shape) for shape in TRACER_SHAPES}
    tracer_runs = {"this": lambda a, acc: tracer_adv.tracer_adv(*a, acc=acc),
                   "this_no_acc": lambda a, acc: tracer_adv.tracer_adv(*a)}
    for shape, (targs, tacc) in tracers.items():
        rel = held([tracer_adv.tracer_adv(*targs, acc=tacc)],
                   [tracer_adv.tracer_adv_plain(*targs, acc=tacc)])
        if not rel <= BAND:
            raise RuntimeError(f"{shape}: off the plain version, {rel:.3e}")
        res["shapes"][shape] = {name: {"rel": rel, "ms": []} for name in tracer_runs}
        print(f"{shape}: held against the plain version, {rel:.2e} (band {BAND:g}) "
              f"[{card}]", flush=True)
    for rnd in range(args.rounds):
        if args.parent and rnd % 2 == 0:
            other = other_tree(args.parent, 1)
            for shape in SHAPES + TRACER_SHAPES:
                p = res["shapes"][shape].setdefault(
                    "parent", {"rel": other[shape]["rel"], "kernel_ms": [],
                               "with_glue_ms": []})
                p["kernel_ms"] += other[shape]["kernel_ms"]
                p["with_glue_ms"] += other[shape]["with_glue_ms"]
        for shape, (u, v, st, kw) in data.items():
            res["shapes"][shape]["this"]["ms"].append(
                time_ms(lambda: momentum.momentum(u, v, st, **kw)))
        for shape, (targs, tacc) in tracers.items():
            for name, run in tracer_runs.items():
                res["shapes"][shape][name]["ms"].append(time_ms(lambda: run(targs, tacc)))
    if args.parent:
        other = other_tree(args.parent, 1)
        for shape in SHAPES + TRACER_SHAPES:
            p = res["shapes"][shape]["parent"]
            p["kernel_ms"] += other[shape]["kernel_ms"]
            p["with_glue_ms"] += other[shape]["with_glue_ms"]
    for shape, row in res["shapes"].items():
        for name, r in row.items():
            if name == "parent":
                print(f"{shape} parent: kernel {', '.join(f'{t:.4f}' for t in r['kernel_ms'])}"
                      f" ms; with the glue the fold replaces "
                      f"{', '.join(f'{t:.4f}' for t in r['with_glue_ms'])} ms [{card}]",
                      flush=True)
            else:
                print(f"{shape} {name}: {', '.join(f'{t:.4f}' for t in r['ms'])} ms [{card}]",
                      flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
