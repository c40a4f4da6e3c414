#!/usr/bin/env python3
"""The readings that the limits of ``perfbench/limits/<cell>.json`` are set from, at
the cell's own size and load: for each seed, one run of the cell's traffic for a short
window and its compared numbers against the float64 reference (the lower readings);
for the first ``--control-seeds`` seeds also the control's: the reference put in the
program's place in bfloat16, the precision below the configuration's float32 (no
matrix product is involved, so TF32 does not apply), on the same inputs and block
inputs (the upper readings). One JSON line a seed on stdout and in ``--out``.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 3]
        [--seconds 3] [--out chiprun_out/readings.jsonl]

The benchmark's runs do not run it.
"""

import argparse
import gc
import json
import pathlib
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import cells, check, hygiene, scenario  # noqa: E402


def readings(cell, seed, seconds, control, device="cuda"):
    """{"seed", "program": {number: value}, "control": {...} or None} of one seed."""
    import torch

    with tempfile.TemporaryDirectory(prefix="perfbench_") as tmp:
        ctx = types.SimpleNamespace(
            config=cell.config, traffic=cell.traffic, seed=seed, seconds=seconds,
            trace=False, device=device, t_start=time.time(),
            inputs=scenario.inputs(cell.config, seed), tmpdir=tmp,
            marks=[])
        run = cells.driver(cell.traffic["driver"]).run(ctx)
        gc.collect()
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.empty_cache()
        ref_dev = "cuda:0" if on_card else "cpu"
        fields = {"program": {}, "control": {}}
        prog = check.readings(cell.config, cell.traffic, ctx.inputs, run["checks"], ref_dev,
                              detail=fields["program"])
        low = (check.readings(cell.config, cell.traffic, ctx.inputs, run["checks"], ref_dev,
                              dtype=torch.bfloat16, detail=fields["control"])
               if control else None)
    return dict(seed=seed, steps=run["steps"], program=prog, control=low, fields=fields)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = cells.cell(args.workload, root=ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        line = json.dumps(dict(workload=args.workload, **readings(
            cell, seed, args.seconds, i < args.control_seeds)))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        hygiene.stop_processes()
    sys.exit(rc)
