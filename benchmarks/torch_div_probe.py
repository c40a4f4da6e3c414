#!/usr/bin/env python3
"""Does IEEE division take its slow path on a zero dividend, and does the guard of
``csrc/weno5.cuh:div_nz`` avoid it? On one card.

    python3 benchmarks/torch_div_probe.py [--out FILE]

``benchmarks/div_probe.cu`` (built here with the port's nvcc flags into
``benchmarks/_build/``) runs the WENO-5 reconstruction ``ITER`` times a thread over
``N`` elements, the result shifting into the stencil, with the plain division and with
the guarded one, on all-zero inputs (every division's dividend is an exact zero), on
N(0, 1) inputs and on N(0, 1) inputs with 90 % of the values exactly 0 (land), at
float32 and float64. Each case is timed with CUDA events (``utils/profiling.py:
time_ms``) in turns (plain, guarded, guarded, plain) and reported in ms and G
reconstructions/s; the guarded results must equal the plain ones bit for bit. Where
the toolkit's ``cuobjdump`` is present, it also counts the ``FCHK`` instructions (the
range check of full-range division) and the subroutine calls in each instantiation.

Prints one line per number with the card's name and power limit, and one JSON object
as its last line (also written to ``--out``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "benchmarks", "div_probe.cu")
N, ITER = 4 * 2**20, 64


def build():
    """The probe's library and its path (cached by content)."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import _build

    lib = str(_build.standalone(SOURCE, os.path.join(ROOT, "benchmarks", "_build")))
    dll = ctypes.CDLL(lib)
    fns = {}
    for suffix in ("f32", "f64"):
        fn = getattr(dll, f"osg_div_probe_{suffix}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[suffix] = fn
    return fns, lib


def sass_counts(lib):
    """{kernel instantiation: (FCHK count, CALL count)} from cuobjdump, or None."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build._nvcc()),
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return None
    proc = subprocess.run([tool, "-sass", lib], capture_output=True, text=True)
    if proc.returncode != 0:
        return None
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += "FCHK" in line
            counts[name][1] += " CALL" in line
    return {k: tuple(v) for k, v in counts.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_div_probe: no CUDA device available", file=sys.stderr)
        return 1
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import smi_line, time_ms

    card = smi_line()
    fns, lib = build()
    rng = np.random.default_rng(0)
    data = {"zeros": np.zeros(N), "random": rng.standard_normal(N)}
    land = rng.standard_normal(N)
    land[rng.random(N) < 0.9] = 0.0
    data["land"] = land
    res = {"card": card, "n": N, "iters": ITER, "cases": {}}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        for kind, a in data.items():
            x = torch.as_tensor(a, dtype=dtype, device="cuda")
            outs = {g: torch.empty_like(x) for g in (0, 1)}

            def run(guarded):
                err = fns[suffix](x.data_ptr(), outs[guarded].data_ptr(), N, ITER, guarded,
                                  torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"div probe: CUDA error {err} at launch")

            run(0)
            run(1)
            torch.cuda.synchronize()
            itype = torch.int32 if dtype == torch.float32 else torch.int64
            same = torch.equal(outs[0].view(itype), outs[1].view(itype))
            finite = bool(torch.isfinite(outs[0]).all())
            if not (same and finite):
                raise RuntimeError(f"{suffix} {kind}: guarded bits equal {same}, finite "
                                   f"{finite}")
            ms = {0: [], 1: []}
            for g in (0, 1, 1, 0):
                ms[g].append(time_ms(lambda: run(g), n=10, reps=5))
            row = {"plain_ms": ms[0], "guarded_ms": ms[1],
                   "plain_g_recon_per_s": N * ITER / (min(ms[0]) * 1e-3) / 1e9,
                   "guarded_g_recon_per_s": N * ITER / (min(ms[1]) * 1e-3) / 1e9}
            res["cases"][f"{suffix}_{kind}"] = row
            print(f"{suffix} {kind}: plain {', '.join(f'{t:.4f}' for t in ms[0])} ms "
                  f"({row['plain_g_recon_per_s']:.1f} G reconstructions/s); guarded "
                  f"{', '.join(f'{t:.4f}' for t in ms[1])} ms "
                  f"({row['guarded_g_recon_per_s']:.1f} G/s); bits equal [{card}]",
                  flush=True)
    counts = sass_counts(lib)
    res["sass"] = counts
    if counts is not None:
        for name, (fchk, calls) in counts.items():
            print(f"sass {name}: FCHK {fchk}, CALL {calls}", flush=True)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
