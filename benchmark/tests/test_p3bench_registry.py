"""The harness finds cells, configurations, traffic mixes, drivers and
metrics by name, BENCHMARK.json keeps to its contract, and a new cell,
configuration or per-layer metric needs new files only."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark.harness import spec as spec_mod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec_mod.load_benchmark()


def test_every_name_resolves_to_its_files():
    for w in BENCH["workloads"]:
        s = spec_mod.cell_spec(BENCH, w["name"])
        assert s["config"]["name"] == w["config"]
        assert s["traffic"]["name"] == w["traffic"]
        assert callable(spec_mod.driver(s["traffic"]["mode"]).window)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec_mod.reader(m["name"]))
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(spec_mod.ROOT, c["file"]))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        e, layer = spec_mod.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2 and layer
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")


def test_a_new_cell_config_and_metric_are_files_only(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a per-layer
    metric and a cell as new files and entries, and find each by name."""
    root = tmp_path / "checkout"
    shutil.copytree(spec_mod.BENCH_DIR, root / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    bench_dir = str(root / "benchmark")
    cfg = json.load(open(os.path.join(bench_dir, "configs", "p2p_image.json")))
    cfg["experiment"] = "p2p_lidar"
    json.dump(cfg, open(os.path.join(bench_dir, "configs", "p2p_lidar.json"), "w"))
    traffic = json.load(open(os.path.join(bench_dir, "traffic", "eval_passes_128.json")))
    traffic["splits"] = {"test": 64}
    json.dump(traffic, open(os.path.join(bench_dir, "traffic", "eval_passes_64.json"), "w"))
    with open(os.path.join(bench_dir, "metrics", "predict.scorenet_ms_per_batch.py"), "w") as f:
        f.write("from benchmark.harness.readers import mean_batch_ms\n\n\n"
                "def read(data):\n    return mean_batch_ms(data, 'scorenet_ms')\n")
    bench["configs"].append({"name": "p2p_lidar", "source": "https://example.org", "file":
                             "benchmark/configs/p2p_lidar.json", "reduced": [], "why": "LiDAR only"})
    bench["workloads"].append({"name": "p2p_lidar.predict", "config": "p2p_lidar", "traffic": "eval_passes_64",
                               "chips": 1, "why": "LiDAR-only prediction"})
    for m in bench["end_to_end"]:
        if m["name"] == "predict_tiles_per_s":
            m["workloads"].append("p2p_lidar.predict")
    bench["per_layer"].append({"name": "predict.scorenet_ms_per_batch", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "ScoreNets", "moves": "predict_tiles_per_s",
                               "workloads": ["p2p_image.predict", "p2p_lidar.predict"]})
    s = spec_mod.cell_spec(bench, "p2p_lidar.predict", bench_dir)
    assert s["config"]["experiment"] == "p2p_lidar" and s["traffic"]["splits"] == {"test": 64}
    assert "predict.scorenet_ms_per_batch" in {m["name"] for m in s["per_layer"]}
    read = spec_mod.reader("predict.scorenet_ms_per_batch", bench_dir)
    assert read({"window": {"batch_times": [{"scorenet_ms": 2.0}, {"scorenet_ms": 4.0}]}}) == 3.0


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec_mod.cell_spec(BENCH, "no.such_cell")
