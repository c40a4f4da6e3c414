#!/usr/bin/env python3
"""Where a step of the PyTorch port's layered engine spends its time, on one CUDA card:
the baroclinic front or the wind-driven T/S gyre at 1/4 degree with 10 layers.

    python3 benchmarks/torch_profile_layered.py [--config front|gyre] [--steps 10]
                                                [--ahead-steps 2] [--windows 3]
                                                [--out FILE]

The model is ``examples/baroclinic_front_torch.build`` (``--config front``, the
default) or ``examples/wind_driven_ts_gyre_torch.build`` (``--config gyre``), at
(1440, 680, 10), float32, substeps=30, dt = 40 s, run through
``models/layered.py:layered_multi_step``.
As ``benchmarks/torch_profile_step.py`` does for the Bickley jet, two paths are
measured with their windows interleaved in one process (kernel, plain, plain,
kernel, ...): the kernel path, and the plain path with every kernel wrapper replaced
by its plain PyTorch version. Each window gives ``ms_step`` (CUDA events),
``host_ms_step`` (the host's enqueue), ``ahead_ms_step`` (steps enqueued while a spin
kernel holds the card: the device-bound time) and ``idle_share``.

Then one ``torch.profiler`` window over ``--steps`` steps of the kernel path gives
device time per kernel name, and splits the step's device work in two: the port's
own CUDA kernels (``csrc/``) and everything else, the plain PyTorch glue between
them (AB2, the depth sums, the predictor and corrector, the masks, the dG adds,
embeds, crops and fills of constants). For each it reports launches and device
time per step.

Last, the layered tracer kernel alone on the step's own operands (the filled u, v
and the tracer stack c, which the front starts at 0, then b where it is
prognostic) and on random operands of the same shape, each timed with CUDA events
over back-to-back calls: its time depends on the data it is given. The same for the
momentum kernel: its call of the step (u, v zero on land, the closure pack, dGu and
dGv, the closing mask), then that call with random u and v of the same magnitude,
masked and not.

Prints one line per measurement with the card's name and power limit, and as its last
line one JSON object holding all of them (also written to ``--out``). Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks.torch_profile_step import plain_kernels, spin_cycles_per_ms  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import (  # noqa: E402
    smi_line, time_ms)

DT = 40.0
# the device kernels of csrc/ (names as the profiler reports them)
PORT_KERNELS = ("group_fill_kernel", "group_restore_kernel", "halo_fill_copy_kernel",
                "subcycle_kernel", "momentum_kernel", "tracer_adv_kernel", "vertical_kernel",
                "corrector_kernel")


@contextlib.contextmanager
def plain_layered():
    """Every kernel wrapper, the vertical one and the corrector included, on its plain
    version."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import corrector, vertical

    saved = vertical.vertical, corrector.corrector

    def vertical_plain(u, v, c, b, n_wet, g_pack, coef, **kw):
        s_pack = vertical.wet_pack(n_wet, u.shape[0], 3 if kw.get("viscous") else 1,
                                   u.dtype)
        return vertical.vertical_plain(u, v, c, b, s_pack, g_pack, coef, **kw)

    vertical.vertical = vertical_plain
    corrector.corrector = corrector.corrector_plain
    try:
        with plain_kernels():
            yield
    finally:
        vertical.vertical, corrector.corrector = saved


def window(model, state, n, hold_cycles=0):
    """Run ``n`` steps; returns (state, ms/step on the card, host ms/step, ahead)."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_cycles:
        torch.cuda._sleep(hold_cycles)
    start.record()
    t0 = time.perf_counter()
    state = layered_multi_step(model, state, DT, n)
    host = (time.perf_counter() - t0) * 1e3 / n
    ahead = bool(hold_cycles) and not start.query()
    end.record()
    end.synchronize()
    return state, start.elapsed_time(end) / n, host, ahead


def _union_us(spans):
    spans = sorted(spans)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def _is_port(name):
    return any(f"{k}<" in name or name.endswith(k) for k in PORT_KERNELS)


def profile_window(model, state, n):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = layered_multi_step(model, state, DT, n)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return state, None
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = _union_us(spans)
    span = max(s[1] for s in spans) - min(s[0] for s in spans)
    per_name = {}
    split = {"port_kernels": [0.0, 0], "glue": [0.0, 0]}
    for e in dev:
        dur = e.time_range.end - e.time_range.start
        t, c = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + dur, c + 1)
        part = split["port_kernels" if _is_port(e.name) else "glue"]
        part[0] += dur
        part[1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:24]
    return state, dict(
        device_ops_per_step=len(dev) / n, busy_ms_step=busy / 1e3 / n,
        span_ms_step=span / 1e3 / n, idle_share=1.0 - busy / span,
        split={k: dict(ms_step=t / 1e3 / n, launches_step=c / n)
               for k, (t, c) in split.items()},
        top=[dict(name=k[:100], us_per_step=t / n, calls_per_step=c / n)
             for k, (t, c) in top])


def tracer_operands(model, state, reps=20):
    """ms per layered tracer_adv call on the step's c and b stacks and on random
    stacks of the same shape (random velocities of the same magnitude, masked)."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv
    from orthogonalsphericalshellgrids_tpu_torch.models.hydrostatic import _fill
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    g = model.grid
    u, v = _fill(g, state.u, FC, -1), _fill(g, state.v, CF, -1)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand_like(a, scale):
        return scale * torch.randn(a.shape, generator=gen, device=a.device, dtype=a.dtype)

    ur = rand_like(u, float(u.abs().max())) * model.mask_u3
    vr = rand_like(v, float(v.abs().max())) * model.mask_v3
    cases = {"c (the step's tracer stack)": (_fill(g, state.c, CC, 1), u, v)}
    if model.has_b:
        cases["b (the step's buoyancy)"] = (_fill(g, state.b, CC, 1), u, v)
    cases.update({"random c, the step's u and v": (rand_like(state.c, 1.0), u, v),
                  "random c, u and v": (rand_like(state.c, 1.0), ur, vr)})
    out = {}
    for label, (c, uu, vv) in cases.items():
        args = (c, uu, vv, model.adv_pack, model.vert_g[3:5], model.dz_t)
        out[label] = dict(ms=time_ms(lambda: tracer_adv.tracer_adv(*args), n=reps),
                          zero_share=float((c == 0).double().mean()))
    return out


def momentum_operands(model, state, reps=20):
    """ms per momentum call with the step's own operands (caught from one
    ``layered_tendencies`` call) and with random u and v of the same magnitude, masked
    as the step's are and not."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import momentum
    from orthogonalsphericalshellgrids_tpu_torch.models import layered
    from orthogonalsphericalshellgrids_tpu_torch.models.hydrostatic import _fill
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    g = model.grid
    fields = (_fill(g, state.u, FC, -1), _fill(g, state.v, CF, -1),
              _fill(g, state.c, CC, 1), _fill(g, state.b, CC, 1) if model.has_b else state.b)
    calls, kernel = [], momentum.momentum

    def catch(*a, **kw):
        calls.append((a, kw))
        return kernel(*a, **kw)

    momentum.momentum = catch
    try:
        layered.layered_tendencies(model, *fields)
    finally:
        momentum.momentum = kernel
    (u, v, *rest), kw = calls[0]
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand_like(a):
        return float(a.abs().max()) * torch.randn(a.shape, generator=gen, device=a.device,
                                                  dtype=a.dtype)

    ur, vr = rand_like(u), rand_like(v)
    cases = {"the step's u and v (land zeros)": (u, v),
             "random u and v, masked": (ur * model.mask_u3, vr * model.mask_v3),
             "random u and v": (ur, vr)}
    return {label: dict(ms=time_ms(lambda: kernel(uu, vv, *rest, **kw), n=reps),
                        zero_share=float((uu == 0).double().mean()))
            for label, (uu, vv) in cases.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("front", "gyre"), default="front")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ahead-steps", type=int, default=2,
                    help="steps per host-ahead window; their launches must fit the "
                         "card's launch queue")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_layered: no CUDA device available", file=sys.stderr)
        return 1
    if args.config == "gyre":
        from examples.wind_driven_ts_gyre_torch import build
    else:
        from examples.baroclinic_front_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels

    card = smi_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"tree {ROOT}; config {args.config}", flush=True)
    model, state = build(1440, 680, 10, dtype=torch.float32, substeps=30, device="cuda")
    kernels.reset_launch_counts()
    state, *_ = window(model, state, 3)  # builds the kernels, warms the allocator
    with plain_layered():
        state, *_ = window(model, state, 2)
    wrapper_calls = {k: v / 3 for k, v in kernels.launch_counts().items()}
    cyc_ms = spin_cycles_per_ms()

    n = args.steps
    result = {"card": card, "config": args.config, "steps": n,
              "ahead_steps": args.ahead_steps,
              "wrapper_calls_per_step": wrapper_calls, "kernel": [], "plain": []}
    order = ["kernel", "plain", "plain", "kernel"] * ((args.windows + 1) // 2)
    for path in order[: 2 * args.windows]:
        ctx = plain_layered() if path == "plain" else contextlib.nullcontext()
        steps = n if path == "kernel" else max(2, n // 5)
        with ctx:
            state, ms, host, _ = window(model, state, steps)
            hold = int(cyc_ms * max(50.0, 3.0 * host * args.ahead_steps))
            state, ahead_ms, _, ahead = window(model, state, args.ahead_steps,
                                               hold_cycles=hold)
        rec = dict(ms_step=ms, host_ms_step=host, ahead_ms_step=ahead_ms, ahead=ahead,
                   idle_share=(1.0 - ahead_ms / ms) if ahead else None)
        result[path].append(rec)
        print(f"{path}: {ms:.4f} ms/step as run, host {host:.4f} ms/step, "
              f"{ahead_ms:.4f} ms/step with the host ahead (ahead={ahead}), idle share "
              f"{rec['idle_share']} [{card}]", flush=True)
    state, prof = profile_window(model, state, n)
    result["profile"] = prof
    if prof is None:
        print("profiler: no device activity recorded", flush=True)
    else:
        print(f"profiler (kernel path, {n} steps): {prof['device_ops_per_step']:.1f} "
              f"device ops/step, busy {prof['busy_ms_step']:.4f} of "
              f"{prof['span_ms_step']:.4f} ms/step, idle share "
              f"{prof['idle_share']:.4f} [{card}]", flush=True)
        for part, rec in prof["split"].items():
            print(f"  {part}: {rec['launches_step']:.1f} launches/step, "
                  f"{rec['ms_step']:.4f} ms/step of device time", flush=True)
        for row in prof["top"]:
            print(f"  {row['us_per_step']:10.2f} us/step {row['calls_per_step']:6.1f} "
                  f"calls/step  {row['name']}", flush=True)
    result["tracer_operands"] = tracer_operands(model, state)
    for label, rec in result["tracer_operands"].items():
        print(f"tracer_adv_layered on {label}: {rec['ms']:.4f} ms per call (share of "
              f"exact zeros in c {rec['zero_share']:.3f}) [{card}]", flush=True)
    result["momentum_operands"] = momentum_operands(model, state)
    for label, rec in result["momentum_operands"].items():
        print(f"momentum on {label}: {rec['ms']:.4f} ms per call (share of exact zeros "
              f"in u {rec['zero_share']:.3f}) [{card}]", flush=True)
    if not bool(torch.isfinite(state.u).all()):
        raise RuntimeError("the profiled run produced non-finite velocities")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
