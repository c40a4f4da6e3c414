"""The comparison that decides ``correct``: the program's states against the plain
reference that the configuration's model kind names (``perfbench/models/<model>.py``,
``reference()``), which works out the grid, the masks and the initial state again
from the same inputs and steps in float64.

A simulation's state after thousands of steps cannot be followed by the reference in
less time than the window (and chaos parts two runs of the turbulent jet within days
of model time), so the reference follows the program step by step from the program's
own state: for each pair of states the run kept (a block drawn from the seed and the
last; in an ensemble, for each member followed), it steps the program's input state as
many steps as the block and compares the result with the program's output. The
start, which this skips, is checked by itself: the program's initial state against
the reference's own.

Each number is the largest over the compared fields (the model kind's ``FIELDS``, at
the interior points) of a field's gap, the field's own scale in its denominator:

- ``init_gap``: max |program − reference| / max |reference| of the initial state;
- ``block_gap``: max |program − reference| / max |reference − input| of a block, the
  field's change over the block in the reference: a field that the block leaves
  unchanged reads 1 however slowly it moves, and rounding reads its share of the
  change;
- ``write_gap`` (a run with output): each written field read back from the archive
  against the reference's value at that iteration, over the reference's change of that
  field over the steps before it.
"""

from __future__ import annotations

import zipfile

import numpy as np

from . import program


def _interior(a, h):
    return a[..., h:a.shape[-2] - h, h:a.shape[-1] - h]


def _np(a):
    return a.detach().double().cpu().numpy() if hasattr(a, "detach") else np.asarray(a, np.float64)


def gap(p, r, scale):
    """max |p − r| / ``scale`` (p and r interior arrays)."""
    d = float(np.max(np.abs(_np(p) - _np(r))))
    if not np.isfinite(d):
        return float("inf")
    return d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))


def field_gap(p, r, h):
    """max |p − r| / max |r| over the interior points (halo ``h``)."""
    p, r = _interior(_np(p), h), _interior(_np(r), h)
    return gap(p, r, float(np.max(np.abs(r))))


def change_gap(p, r, before, h):
    """max |p − r| / max |r − before| over the interior points (halo ``h``)."""
    p, r, b = (_interior(_np(a), h) for a in (p, r, before))
    return gap(p, r, float(np.max(np.abs(r - b))))


def halo(kind, m, name):
    return m["He"] if name in kind.WIDE else m["H"]


def to_reference(m, host):
    """The reference's state of the program's host state ``host`` (numpy fields), in
    the reference model's dtype on its device."""
    import torch

    out = {}
    for name, a in host.items():
        if name == "iteration":
            out[name] = torch.tensor(int(a), dtype=torch.int64, device=m["device"])
        else:
            out[name] = torch.as_tensor(np.array(a)).to(device=m["device"], dtype=m["dtype"])
    return out


def _snapshot(archive, j):
    with zipfile.ZipFile(archive) as z:
        names = [n for n in z.namelist() if n.endswith(f".{j:06d}.npy")
                 and not n.startswith("times.")]
        out = {}
        for n in names:
            with z.open(n) as f:
                out[n.rsplit(".", 2)[0]] = np.lib.format.read_array(f)
    return out


def output(kind, ref, m, state, spec):
    """The reference's value of an output field ``spec`` of ``state``, cropped to its
    interior as the writer crops it."""
    if "diagnostic" in spec:
        return _interior(_np(getattr(ref, spec["diagnostic"])(m, state)), m["H"])
    return _interior(_np(state[spec["field"]]), halo(kind, m, spec["field"]))


def _host(state):
    return {k: (v.detach().float().cpu().numpy() if v.dim() else v.item())
            for k, v in state.items()}


def readings(cfg, traffic, inputs, checks, device, dtype=None, detail=None):
    """{number: value} of a run's ``checks`` (the driver's host states: ``inits``,
    ``pairs`` and, with output, ``snapshots``, ``archive`` and ``fields``) against the
    reference built on ``device`` in float64 from ``inputs`` (the bottom). With
    ``dtype``, the control: the reference put in the program's place in that lower
    precision, its states compared as the program's are. ``detail``, a dict, receives
    each state's gaps by field, and each pair's change by field as a share of the
    field's largest value (``<label>.change``)."""
    import torch

    kind = program.kind(cfg)
    ref = kind.reference()
    detail = {} if detail is None else detail
    m64 = ref.build(cfg, inputs, dtype=torch.float64, device=device,
                    sample_dtype=getattr(torch, cfg["dtype"]))
    lower = None if dtype is None else ref.build(cfg, inputs, dtype=dtype, device=device,
                                                  sample_dtype=dtype)
    out = {}
    inits = []
    for label, init_fns, host in checks["inits"]:
        r = ref.initial_state(m64, init_fns)
        p = host if lower is None else _host(ref.initial_state(lower, init_fns))
        detail["init" + label] = {f: field_gap(p[f], r[f], halo(kind, m64, f))
                                  for f in kind.FIELDS}
        inits.append(max(detail["init" + label].values()))
    out["init_gap"] = max(inits, default=float("inf"))
    refs_of, befores = {}, {}
    blocks = []
    for label, before, after, dt, n in checks["pairs"]:
        b = to_reference(m64, before)
        r = refs_of[label] = ref.run(m64, b, dt, n)
        befores[label] = b
        got = after if lower is None else _host(ref.run(lower, to_reference(lower, before),
                                                       dt, n))
        detail[label] = {f: change_gap(got[f], r[f], before[f], halo(kind, m64, f))
                         for f in kind.FIELDS}
        detail[label + ".change"] = {f: field_gap(before[f], r[f], halo(kind, m64, f))
                                     for f in kind.FIELDS}
        blocks.append(max(detail[label].values()))
        if lower is not None:
            refs_of[label + ".control"] = to_reference(m64, got)
    out["block_gap"] = max(blocks, default=float("inf"))
    if "snapshots" in checks:
        fields = checks["fields"]
        writes = []
        for label, j in checks["snapshots"]:
            if lower is None:
                snap = _snapshot(checks["archive"], j)
            else:
                snap = {name: output(kind, ref, m64, refs_of[label + ".control"], spec)
                        for name, spec in fields.items()}
            if not snap.keys() >= fields.keys():
                writes.append(float("inf"))
                continue
            gaps = {}
            for name, spec in fields.items():
                r = output(kind, ref, m64, refs_of[label], spec)
                b = output(kind, ref, m64, befores[label], spec)
                gaps[name] = gap(snap[name], r, float(np.max(np.abs(r - b))))
            detail[label + ".write"] = gaps
            writes.append(max(gaps.values()))
        out["write_gap"] = max(writes, default=float("inf"))
    return out


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its limit, and every
    limit's number present."""
    rows = [(name, numbers.get(name, float("inf")), limit) for name, limit in limits.items()]
    return all(np.isfinite(v) and v <= lim for _, v, lim in rows), rows
