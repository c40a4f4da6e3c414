"""The port's benchmark entry points (``bench_torch.py``, ``bench_layered_torch.py``,
``bench_scaling_torch.py``, ``benchmarks/torch_cpu_reference_proxy.py``) on the CPU,
at a small size: a 48 x 32 jet and a 48 x 32 x 3 gyre at substeps 6.

- The configuration: each bench's model, state, block and dt against the JAX bench's
  (``examples/bickley_jet.py:build`` through ``multi_step`` at ``bench.py``'s dt and
  block; ``examples/wind_driven_ts_gyre.py:build`` through ``layered_multi_step`` at
  ``bench_layered.py``'s), at float64 after one block, run on the CPU through the
  jitted XLA path as the JAX tests run it: rtol 1e-12 for the jet and 1e-11 for the
  gyre, the bands of ``tests/test_torch_model.py`` and ``tests/test_torch_layered.py``.
  The block and dt are read from the JAX benches' source.
- The lines: the JAX lines' keys, unit and metric string (read from the JAX source),
  one JSON line on stdout, the layered line and the collective smoke on stderr, a
  layered failure printed and not fatal.
- Scaling: one throughput line per N and one efficiency line through ``LocalExchange``
  and gloo, each run's shards bitwise the serial run (the bench raises otherwise; its
  check is shown to catch one ulp), the decomposition rows with the JAX keys, and
  ``--exchange nccl`` refused with more ranks than cards.
- The proxy's line, and that none of the four imports JAX or the JAX package.
"""

import ast
import json
import math
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_layered_torch  # noqa: E402
import bench_scaling_torch  # noqa: E402
import bench_torch  # noqa: E402
from benchmarks import torch_cpu_reference_proxy as proxy  # noqa: E402
from examples.bickley_jet import build as jax_jet  # noqa: E402
from examples.wind_driven_ts_gyre import build as jax_gyre  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import multi_step  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.parallel import distribute, make_mesh  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(nx=48, ny=32, substeps=6)
GYRE = dict(SMALL, nz=3)
RUN = dict(warmup=1, steps=2, probe=False, device="cpu")
ENTRY_POINTS = ("bench_torch.py", "bench_layered_torch.py", "bench_scaling_torch.py",
                "benchmarks/torch_cpu_reference_proxy.py")


def _jax_source(path, func):
    """The ``ast`` of function ``func`` in the JAX bench at ``path``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)


def _jax_constant(path, func, name):
    """The literal assigned to ``name`` in ``func`` of the JAX bench (block, dt)."""
    for node in ast.walk(_jax_source(path, func)):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError(f"{name} in {path}:{func}")


def _jax_line(path, func, dict_name, **names):
    """(keys, the metric string) of the dict literal assigned to ``dict_name`` in the
    JAX bench, the metric's f-string evaluated with ``names``."""
    for node in ast.walk(_jax_source(path, func)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == dict_name for t in node.targets):
            keys = [k.value for k in node.value.keys]
            metric = node.value.values[keys.index("metric")]
            expr = ast.Expression(metric)
            return keys, eval(compile(expr, path, "eval"), {}, names)
    raise LookupError(f"{dict_name} in {path}:{func}")


def _interior(g, a):
    return np.asarray(a)[..., g.Hy:g.Hy + g.Ny, g.Hx:g.Hx + g.Nx]


def _assert_close(jm, jout, tout, rtol, names):
    for name in names:
        grid = jm.grid_ext if name in ("eta", "U", "V") else jm.grid
        want = _interior(grid, getattr(jout, name))
        got = _interior(grid, getattr(tout, name).numpy())
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(),
                                   err_msg=name)
    assert float(tout.t) == pytest.approx(float(jout.t), rel=1e-15)


def test_block_and_dt_are_the_jax_benches():
    assert bench_torch.BLOCK == _jax_constant("bench.py", "main", "block")
    assert bench_torch.DT == _jax_constant("bench.py", "main", "dt")
    assert bench_layered_torch.BLOCK == _jax_constant("bench_layered.py", "run", "block")
    assert bench_layered_torch.DT == _jax_constant("bench_layered.py", "run", "dt")


def test_jet_block_matches_jax_bench():
    """One block of the jet bench at f64 against the JAX bench's configuration."""
    tm, ts = bench_torch.build(**SMALL, device="cpu", dtype=torch.float64)
    tout = bench_torch.block(tm, ts)
    jm, js = jax_jet(**SMALL, dtype=jnp.float64)
    jout = jax.jit(partial(JH.multi_step, n_steps=_jax_constant("bench.py", "main", "block")))(
        jm, js, _jax_constant("bench.py", "main", "dt"))
    assert int(tout.iteration) == int(jout.iteration) == bench_torch.BLOCK
    _assert_close(jm, jout, tout, 1e-12, ("u", "v", "c", "Gu", "Gv", "Gc", "eta", "U", "V"))


def test_gyre_block_matches_jax_bench():
    """One block of the layered bench at f64 against the JAX bench's configuration."""
    tm, ts = bench_layered_torch.build(**GYRE, device="cpu", dtype=torch.float64)
    tout = bench_layered_torch.block(tm, ts)
    jm, js = jax_gyre(**GYRE, dtype=jnp.float64)
    n = _jax_constant("bench_layered.py", "run", "block")
    jout = jax.jit(partial(JL.layered_multi_step, n_steps=n))(
        jm, js, _jax_constant("bench_layered.py", "run", "dt"))
    assert int(tout.iteration) == int(jout.iteration) == bench_layered_torch.BLOCK
    _assert_close(jm, jout, tout, 1e-11, ("u", "v", "c", "Gu", "Gv", "Gc", "eta", "U", "V"))


@pytest.fixture(scope="module")
def bench_run():
    """``bench_torch.main`` at the small sizes, with its stdout and stderr."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = bench_torch.main(**SMALL, **RUN, layered=dict(GYRE, warmup=1, steps=2))
    return result, out.getvalue(), err.getvalue()


def test_headline_line_has_the_jax_keys(bench_run):
    (headline, _, _), stdout, _ = bench_run
    keys, metric = _jax_line("bench.py", "main", "headline")
    assert set(keys) - {"window_sync_overhead_ms"} <= set(headline)
    assert headline["metric"] == metric == bench_torch.METRIC
    assert headline["unit"] == "grid-points/s/chip"
    assert math.isfinite(headline["value"]) and headline["value"] > 0
    assert headline["ms_per_step"] > 0 and headline["ms_per_step_host_ahead"] > 0
    assert headline["device"].startswith("cpu: ")
    # warm-up, 3 rounds of steps, host ahead: one block to warm, 5 windows of one
    assert headline["blocks"] == 1 + 3 * 2 + 1 + 5
    lines = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    assert lines == [headline]


def test_layered_line_and_collectives_on_stderr(bench_run):
    (_, layered, smoke), _, stderr = bench_run
    keys, metric = _jax_line("bench_layered.py", "run", "out", nz=3, substeps=6)
    assert set(keys) <= set(layered)
    assert layered["metric"] == metric
    assert layered["unit"] == "grid-points/s/chip" and math.isfinite(layered["value"])
    assert json.dumps(layered) in stderr.splitlines()
    assert smoke == "ok" and "cpu-gloo-smoke: ok" in stderr.splitlines()
    for i in range(3):
        assert any(x.startswith(f"bench round {i}: ") for x in stderr.splitlines())
        assert any(x.startswith(f"bench_layered round {i}: ") for x in stderr.splitlines())


def test_collectives_between_two_gloo_ranks():
    """The collective smoke's rank body with a peer to send to (one rank sends to
    itself only on NCCL)."""
    from orthogonalsphericalshellgrids_tpu_torch.parallel import spawn

    assert spawn(2, bench_torch._collective_rank, "gloo", timeout=120.0) == [None, None]


def test_layered_failure_is_not_fatal(monkeypatch, capsys):
    def broken(**kw):
        raise ValueError("no gyre")

    monkeypatch.setattr(bench_layered_torch, "run", broken)
    monkeypatch.setattr(bench_torch, "collectives", lambda device: "ok")
    headline, layered, _ = bench_torch.main(**SMALL, **RUN)
    out, err = capsys.readouterr()
    assert layered == "FAILED: ValueError: no gyre"
    assert "layered-bench: FAILED: ValueError: no gyre" in err.splitlines()
    assert [json.loads(x) for x in out.splitlines()] == [headline]


def test_layered_main_prints_one_line(capsys):
    out = bench_layered_torch.main(["--nx", "48", "--ny", "32", "--nz", "3", "--substeps",
                                    "6", "--warmup", "1", "--steps", "1", "--no-probe",
                                    "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert [json.loads(x) for x in printed] == [out]
    assert "stream_probe_gbps" not in out and out["blocks"] == 1 + 3 + 1 + 5


SCALING = ["--nx", "48", "--ny-per-dev", "16", "--steps", "2", "--substeps", "6",
           "--dt", "60"]


@pytest.mark.parametrize("exchange, sizes", [("local", "1,2"), ("gloo", "1,2")])
def test_scaling_lines(exchange, sizes, capsys):
    """One throughput line per N and one efficiency line; each run is held bitwise
    against the serial run inside the bench, which raises otherwise."""
    lines = bench_scaling_torch.main(SCALING + ["--exchange", exchange, "--sizes", sizes,
                                                "--device", "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines
    through = [x for x in lines if x["metric"] == "weak-scaling grid-points/s"]
    eff = [x for x in lines if x["metric"] == "weak-scaling efficiency"]
    assert [x["devices"] for x in through] == [1, 2] and [x["devices"] for x in eff] == [2]
    for x in lines:
        assert x["exchange"] == exchange and x["device"].startswith("cpu: ")
        assert math.isfinite(x["value"]) and x["value"] > 0
    assert {x["unit"] for x in through} == {"points/s"} and eff[0]["unit"] == "ratio"
    assert eff[0]["value"] == round(through[1]["value"] / (2 * through[0]["value"]), 3)


def test_scaling_decomposition_rows_have_the_jax_keys():
    rows = bench_scaling_torch.main(SCALING + ["--exchange", "local", "--sizes", "2",
                                               "--device", "cpu", "--decompose"])
    assert len(rows) == 1
    row = rows[0]
    # bench_scaling.py:104-112
    assert {"metric", "devices", "serial_local_ms", "unsplit_ms", "overlap_ms",
            "overlap_per_shard_core_norm_ms", "strip_recompute_tax"} <= set(row)
    assert row["metric"] == "sharded-overhead decomposition" and row["devices"] == 2
    assert all(row[k] > 0 for k in ("serial_local_ms", "unsplit_ms", "overlap_ms"))


def test_scaling_check_catches_one_ulp():
    model, state = bench_scaling_torch._jet(48, 32, 6, "cpu")
    mesh = make_mesh(2)
    dist_model, dist_state = distribute(model, state, mesh)
    serial = multi_step(model, state, 60.0, 0)
    bench_scaling_torch.check_serial(model, serial, dist_state, mesh.ranks, 2)
    g = model.grid
    u = dist_state[1].u
    u[g.Hy + 3, g.Hx + 7] = torch.nextafter(u[g.Hy + 3, g.Hx + 7], torch.tensor(1e9,
                                                                              dtype=u.dtype))
    with pytest.raises(RuntimeError, match="shard 1 of 2: u is not bitwise"):
        bench_scaling_torch.check_serial(model, serial, dist_state, mesh.ranks, 2)


@pytest.mark.parametrize("sizes", [None, "1", "2"])
def test_scaling_refuses_nccl_above_the_cards(sizes):
    argv = SCALING + ["--exchange", "nccl"] + (["--sizes", sizes] if sizes else [])
    with pytest.raises(SystemExit, match="one card a rank"):
        bench_scaling_torch.main(argv)


@pytest.mark.parametrize("layered", [0, 1])
def test_proxy_line(layered, capsys):
    kw = dict(nx=48, ny=32, substeps=6, blocks=1, layered=layered, nz=3)
    out = proxy.main(**kw)
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()] == [out]
    assert out["cpu_points_per_s"] > 0 and out["layered"] is bool(layered)
    assert out["nz"] == (3 if layered else 1) and out["cpu"].startswith("cpu: ")


@pytest.mark.parametrize("path", ENTRY_POINTS)
def test_entry_point_imports_no_jax(path):
    """No import of jax or of the JAX package in the file, and none at its import."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) else []
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "orthogonalsphericalshellgrids_tpu"), \
                f"{path} imports {name}"
    module = path[:-3].replace("/", ".")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'orthogonalsphericalshellgrids_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_entry_points_run_on_the_card_by_default():
    import inspect

    assert inspect.signature(bench_torch.main).parameters["device"].default == "cuda"
    assert inspect.signature(bench_layered_torch.run).parameters["device"].default == "cuda"
    assert bench_layered_torch.parser("", nx=1).parse_args([]).device == "cuda"
    args = bench_scaling_torch.parser().parse_args([])
    assert (args.device, args.exchange) == ("cuda", "local")
    assert (args.nx, args.ny_per_dev, args.steps, args.dt, args.substeps) == \
        (256, 64, 20, 120.0, 12)  # bench_scaling.py:118-122
