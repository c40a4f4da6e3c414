#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell of
``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's configuration through the port's API on the card(s) from inputs
drawn from ``--seed``, warms up every shape the cell's traffic uses, drives the
traffic for ``--seconds`` (the driver the mix names, ``drivers/<driver>.py``), checks the states the window
produced against the plain reference (``lib/check.py``), and prints the compared
numbers beside their limits as the last lines of standard error and, as the last
line of standard output, one JSON object: ``correct``, ``attempted`` (steps in the
window), ``failed`` (compared numbers over their limit), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``. Without the cards the cell asks
for, or with JAX or the JAX package loaded, it prints no result and exits non-zero.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import cells, check, hygiene, scenario  # noqa: E402


def execute(cell, seed, seconds, trace, device="cuda", t_start=None):
    """(result line dict, [(number, value, limit)], set-up marks) of one run of
    ``cell`` on ``device`` (the tests drive it on the CPU)."""
    import torch

    tmp = tempfile.mkdtemp(prefix="perfbench_")
    try:
        ctx = types.SimpleNamespace(
            config=cell.config, traffic=cell.traffic, seed=int(seed), seconds=float(seconds),
            trace=bool(trace), device=device, t_start=T_START if t_start is None else t_start,
            inputs=scenario.inputs(cell.config, seed), tmpdir=tmp,
            marks=[("start", T_START if t_start is None else t_start)])
        run = cells.driver(cell.traffic["driver"]).run(ctx)
        run["marks"] = ctx.marks
        ctx.marks.append(("window, copies and trace", time.time()))
        gc.collect()
        on_card = torch.device(device).type == "cuda"
        if on_card:
            torch.cuda.empty_cache()
        numbers = check.readings(cell.config, cell.traffic, ctx.inputs, run["checks"],
                                 "cuda:0" if on_card else "cpu")
        ctx.marks.append(("check", time.time()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct, rows = check.judge(numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"]).read(run, cell)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": run["memory_peak_bytes"]}
    out = dict(correct=bool(correct), attempted=int(run["steps"]),
               failed=sum(v > lim or v != v for _, v, lim in rows), metrics=metrics,
               device=dev)
    if trace and run.get("trace"):
        t = run["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    if run.get("dt_min", cell.config["dt"]) < cell.config["dt"]:
        print(f"perfbench: the wizard lowered dt to {run['dt_min']!r} s", file=sys.stderr)
    if "writes" in run:
        print(f"perfbench: {run['writes']} writes in the window", file=sys.stderr)
    return out, rows, run["marks"]


def card_line():
    """The card's name and power limit, for the log beside every number."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.cell(args.workload, root=ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    print(f"perfbench: {card_line()}; peaks 67 TFLOP/s f32, 3.35 TB/s (H100 SXM data "
          "sheet)", file=sys.stderr)
    out, rows, marks = execute(cell, args.seed, args.seconds, args.trace)
    loaded = hygiene.forbidden_loaded()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print("perfbench: set-up " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                                           for a, b in zip(marks, marks[1:])), file=sys.stderr)
    for name, value, limit in rows:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        hygiene.stop_processes()
    sys.stdout.flush()
    sys.exit(rc)
