"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root names the cells, configurations and metrics; each configuration is
`configs/<config>.json`, each traffic mix `traffic/<traffic>.json`, each
window driver `drivers/<mode>.py` (the traffic names its mode), each metric
a reader `metrics/<metric>.py`. Adding a cell, a configuration, a mix or a
metric adds files and entries; no file here needs an edit."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    """`<bench_dir>/<kind>/<name>.json`."""
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) that `cell` reports: those
    whose `workloads` list it, and those without the key (an end-to-end
    metric for every cell; a per-layer one for every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def cell_spec(bench: dict, cell: str, bench_dir: str = BENCH_DIR) -> dict:
    """Everything a run of `cell` needs: its entry, its configuration and
    traffic files, and its metrics."""
    w = find(bench["workloads"], cell, "workload")
    c = find(bench["configs"], w["config"], "configuration")
    e2e, layer = cell_metrics(bench, cell)
    return {
        "cell": w,
        "config": {**load_json("configs", c["name"], bench_dir), "name": c["name"]},
        "traffic": {**load_json("traffic", w["traffic"], bench_dir), "name": w["traffic"]},
        "end_to_end": e2e,
        "per_layer": layer,
        "bench_dir": bench_dir,
    }


def _load_file(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mode: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """`drivers/<mode>.py`."""
    return _load_file(os.path.join(bench_dir, "drivers", f"{mode}.py"), f"p3bench_driver_{mode}")


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The `read(data)` of `metrics/<metric>.py`: a number, or None where
    the run has nothing to read for it."""
    mod = _load_file(os.path.join(bench_dir, "metrics", f"{metric}.py"), "p3bench_metric_" + metric.replace(".", "_"))
    return mod.read
