"""Chained blocks of ``block_steps`` steps of the entry the mix names (``multi_step``,
or ``ensemble_multi_step`` over ``members`` members: the CUDA graphs), at the
configuration's Δt, one after the other with no host read between them, until the
window has passed.

An ensemble's members start from their own inputs (``scenario.inputs`` of the seed
and the member) and share the model. The check follows ``sample_members`` members,
one drawn from the seed in each of as many equal ranges of the member axis, through
two blocks: one drawn from the seed among the first ``sample_blocks``, and the last;
a serial run's one state likewise.
"""

from __future__ import annotations

import dataclasses
import time

from perfbench.lib import drive, program, scenario, trace


def _members(tr, seed):
    """The members the check follows: one drawn in each of ``sample_members`` ranges."""
    n, k = tr["members"], tr["sample_members"]
    return [j * n // k + drive.pick(seed, (j + 1) * n // k - j * n // k, salt=1 + j)
            for j in range(k)]


def run(ctx):
    import torch

    cfg, tr = ctx.config, ctx.traffic
    kind = program.kind(cfg)
    drive.sync(ctx.device)
    ctx.marks.append(("imports and card", time.time()))
    mark = drive.marker(ctx)
    fn, n, dt = program.entry(tr["entry"]), tr["block_steps"], cfg["dt"]
    if "members" in tr:
        from orthogonalsphericalshellgrids_tpu_torch.models.ensemble import (
            member, stack_members)

        model, first = program.build(cfg, ctx.inputs, ctx.device, mark)
        followed = _members(tr, ctx.seed)
        states, inits, scen, kept = [], [], scenario.module(cfg), {}
        for i in range(tr["members"]):
            s = first if i == 0 else kind.initial_fields(
                model, scen.inputs(cfg, scenario.rng_of(ctx.seed, i), kept))
            if i in followed:
                inits.append((f".m{i}", scenario.inputs(cfg, ctx.seed, member=i)["init"]
                              if i else ctx.inputs["init"], program.full_host_state(s)))
            states.append(s)
        state = stack_members(states)
        del states, first, s, kept
        mark("members")

        def cut(batch):
            out = []
            for i in followed:
                one = member(batch, i)
                out.append((f".m{i}", type(one)(**{f.name: getattr(one, f.name).clone()
                                                   for f in dataclasses.fields(one)})))
            return out
    else:
        model, state = program.build(cfg, ctx.inputs, ctx.device, mark)
        inits = [("", ctx.inputs["init"], program.full_host_state(state))]

        def cut(s):
            return [("", s)]
    state = fn(model, state, dt, n)  # the capture and one block of replays
    drive.sync(ctx.device)
    ctx.marks.append(("warm", time.time()))
    k = drive.pick(ctx.seed, tr["sample_blocks"])
    window = drive.window(ctx)
    ctx.marks.append(("window", time.time()))
    setup_s = ctx.marks[-1][1] - ctx.t_start
    before = drive.launches()
    prof = trace.profiler() if ctx.trace else None
    t0 = time.perf_counter()
    done, prev, sample = 0, state, None
    while True:
        prev, state = state, fn(model, state, dt, n)
        if done == k:
            sample = (cut(prev), cut(state))
        done += 1
        if done > k and time.perf_counter() - t0 >= window:
            break
    drive.sync(ctx.device)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    launches = drive.diff(drive.launches(), before)
    peak = drive.peak(ctx.device)
    members = tr.get("members", 1)
    pairs = []
    for label, (a, b) in (("block_sample", sample), ("block_last", (cut(prev), cut(state)))):
        for (tag, x), (_, y) in zip(a, b):
            pairs.append((label + tag, program.full_host_state(x),
                          program.full_host_state(y), dt, n))
    run = dict(setup_s=setup_s, window_s=window_s, steps=done * n, members=members,
               sim_seconds=done * n * dt * members, memory_peak_bytes=peak,
               launches=launches, capture_s=drive.capture_seconds(model),
               checks=dict(inits=inits, pairs=pairs),
               trace=trace.summary(prof, window_s) if prof is not None else None)
    del model, state, prev, sample
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    return run
