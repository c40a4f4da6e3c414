"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``perfbench/`` one file each for a configuration
(``configs/<config>.json``), the model kind it names (``models/<model>.py``: the
program's build and the reference) and its scenario (``scenarios/<scenario>.py``: the
inputs from the seed), a traffic mix (``traffic/<traffic>.json``: the driver it names
and the program's entry), a driver (``drivers/<driver>.py``), a cell's limits
(``limits/<cell>.json``), a per-layer metric's reader (``metrics/<metric>.py``) and a
stage's counts (``counts/<stage>.py``). A cell, configuration, mix, driver or metric
is added by adding its files and its entries in ``BENCHMARK.json``; no file here names
one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]  # perfbench/


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_module(path):
    """The Python file ``path`` as a module (file names may hold dots)."""
    path = pathlib.Path(path)
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=None):
    """The parsed ``BENCHMARK.json`` of the checkout at ``root`` (perfbench/'s
    parent)."""
    return _json(pathlib.Path(root or HERE.parent) / "BENCHMARK.json")


def _reports(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(name, root=None):
    """The ``Cell`` named ``name`` in the checkout at ``root``: its configuration,
    traffic and limits read from their files under perfbench/, and the metrics it
    reports."""
    root = pathlib.Path(root or HERE.parent)
    base = root / "perfbench"
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=entry["chips"], config=_json(root / conf["file"]),
                traffic=_json(base / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(base / "limits" / f"{name}.json"), end_to_end=e2e,
                per_layer=per_layer)


def driver(name):
    """The driver module ``name`` (``drivers/<name>.py``): its ``run(ctx)``."""
    return load_module(HERE / "drivers" / f"{name}.py")


def metric_reader(metric_name):
    """The reader module of per-layer metric ``metric_name``."""
    return load_module(HERE / "metrics" / f"{metric_name}.py")


def stage_count(stage, cfg):
    """(operations, bytes) of ``stage`` at configuration ``cfg``."""
    return load_module(HERE / "counts" / f"{stage}.py").count(cfg)
