"""The harness on the CPU: every cell of ``BENCHMARK.json`` resolves its files by name;
a configuration with a scenario of its own, a traffic mix with a driver of its own, a
cell and a metric added as files and entries in a copy of the benchmark are picked up
and run without an edit of a file that is there; the result line
has the keys the benchmark's contract asks for; names, units and the file's shape
keep to the contract; and a run without a card fails rather than falling back."""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.lib import cells, program
from perfbench.tests.test_perfbench_control import small

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    c = cells.cell(cell)
    assert c.config and c.traffic and c.limits
    assert c.end_to_end and c.per_layer
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)
    assert callable(cells.driver(c.traffic["driver"]).run)
    assert program.kind(c.config).FIELDS and callable(program.kind(c.config).build)
    assert (cells.HERE / "scenarios" / f"{c.config['scenario']}.py").is_file()
    if "entry" in c.traffic:
        assert callable(program.entry(c.traffic["entry"]))


def test_the_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[part]]
    assert len(names) == len(set(names))
    for e in BENCH["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert e["file"].startswith("perfbench/") and (ROOT / e["file"]).is_file()
        assert json.loads((ROOT / e["file"]).read_text())["reduced"] == e["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        for w in m["workloads"]:
            reports = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
            assert w in reports.get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for part in ("end_to_end", "per_layer"):
        for m in BENCH[part]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_every_file_under_the_paths_is_named_from_name_characters():
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def _digest(tree):
    return {p.relative_to(tree).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


NEW_DRIVER = """
from perfbench.lib import cells, program


def run(ctx):  # the blocks driver, and the steps it ran counted twice
    out = cells.driver("blocks").run(ctx)
    out["twice"] = 2 * out["steps"]
    return out
"""


def test_a_new_config_mix_driver_cell_and_metric_are_files_and_entries_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "perfbench")
    base = tmp_path / "perfbench"
    cfg = json.loads((base / "configs" / "bickley_jet_q.json").read_text())
    cfg.update(nx=720, ny=340, scenario="calm_jet")
    (base / "configs" / "bickley_jet_h.json").write_text(json.dumps(cfg))
    (base / "scenarios" / "calm_jet.py").write_text(
        "from perfbench.lib import cells\n\n\ndef inputs(cfg, rng, kept):\n"
        "    out = cells.load_module(cells.HERE / 'scenarios' / 'bickley_jet.py')"
        ".inputs(cfg, rng, kept)\n    out['init']['eta'] = None\n    return out\n")
    (base / "drivers" / "twice.py").write_text(NEW_DRIVER)
    mix = json.loads((base / "traffic" / "blocks.json").read_text())
    mix.update(driver="twice", block_steps=20)
    (base / "traffic" / "twice20.json").write_text(json.dumps(mix))
    (base / "limits" / "bickley_jet_h.twice20.json").write_text(
        (base / "limits" / "bickley_jet_q.blocks.json").read_text())
    (base / "metrics" / "twice_per_s.twice20.py").write_text(
        "def read(run, cell):\n    return run['twice'] / run['window_s']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="bickley_jet_h",
                                 file="perfbench/configs/bickley_jet_h.json"))
    bench["workloads"].append(dict(name="bickley_jet_h.twice20", config="bickley_jet_h",
                                   traffic="twice20", chips=1, why="a half-degree jet"))
    bench["end_to_end"][0]["workloads"].append("bickley_jet_h.twice20")
    bench["per_layer"].append(dict(name="twice_per_s.twice20", unit="steps/s",
                                   better="higher", source="host_clock", layer="step",
                                   moves="sypd", workloads=["bickley_jet_h.twice20"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from perfbench.lib import cells; import perfbench.run as r; "
            "c = cells.cell('bickley_jet_h.twice20'); c.config.update(nx=48, ny=48); "
            "print(json.dumps([c.config['nx'], c.traffic['block_steps'], "
            "[m['name'] for m in c.per_layer], r.execute(c, 5, 0.3, 1, device='cpu')[0]]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    nx, steps, names, out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (nx, steps, names) == (48, 20, ["twice_per_s.twice20"])
    assert out["correct"] and out["attempted"] % 20 == 0
    assert out["metrics"]["twice_per_s.twice20"]["value"] > 0
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("trace", [0, 1])
def test_the_result_line_has_the_contract_keys(trace):
    import perfbench.run as harness

    cell = small("bickley_jet_q.blocks")
    out, rows, _ = harness.execute(cell, 12, 0.5, trace, device="cpu")
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(out) == want + ["checks"]
    assert set(out["checks"]) == set(cell.limits) == {r[0] for r in rows}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"sypd", "setup_s"}
    json.dumps(out)


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "bickley_jet_q.blocks", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


def test_a_checkout_of_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "bickley_jet_q.blocks", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout


def test_a_run_leaves_no_process_and_loads_no_jax():
    code = ("import perfbench.run as r, multiprocessing as mp, sys; "
            "from perfbench.lib import cells, hygiene; "
            "from perfbench.tests.test_perfbench_control import small; "
            "r.execute(small('bickley_jet_q.simulation'), 4, 0.3, 0, device='cpu') "
            "if __name__ == '__main__' else None; hygiene.stop_processes(); "
            "print(hygiene.forbidden_loaded(), len(hygiene.descendants()))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.stdout.strip().splitlines()[-1] == "[] 0", proc.stderr[-2000:]
