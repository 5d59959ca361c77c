"""The port's entry points on more than one process, on the CPU (gloo):

- `P3_LAUNCH=2 python -m pixelspointspolygons_torch.cli.train ... device=cpu`
  on a tiny FFL-image (full ViT depth at 32 px and width 48, `simple`
  polygonization) ends rc 0 with one set of checkpoints, one run log and
  the same global metrics on both ranks, `training.device_cache=auto`
  taking the host loader;
- `cli.predict` under `P3_LAUNCH=2`, on a 3-tile split (the second rank's
  shard wrap-padded with the first tile), writes one prediction file whose
  annotations equal, as a set, the one-process run's, from a checkpoint
  that one process wrote (ROADMAP 3.17: the JAX package's processes each
  write their own shard);
- `graft_entry_torch.dryrun_multichip(2, device="cpu")` prints one line per
  family;
- NCCL asked for more processes than there are cards raises, and nothing
  falls back to gloo or to the CPU; across hosts each process takes the card
  of its local rank;
- a process that fails ends the launch at once, whichever rank it is.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import graft_entry_torch
from pixelspointspolygons_torch import parallel
from pixelspointspolygons_torch.cli import predict as cli_predict
from pixelspointspolygons_torch.cli._common import process_group
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data.loader import build_loader, to_device
from pixelspointspolygons_torch.models.ffl import build_ffl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def overrides(root) -> list[str]:
    return [
        "experiment=ffl_image", "dataset=synthetic", "run_type=debug",
        f"host.dataset_root={root}/data", f"host.model_root={root}/out",
        "experiment.dataset.num_train=4", "experiment.dataset.num_val=2", "experiment.dataset.num_test=3",
        "run_type.train_subset=null", "run_type.val_subset=null", "run_type.test_subset=null",
        "experiment.model.batch_size=1", "experiment.model.num_epochs=1", "training.val_every=1",
        "training.save_every=100", "experiment.encoder.in_size=32", "experiment.encoder.patch_feature_dim=48",
        "experiment.model.decoder.in_feature_dim=16", "experiment.polygonization.method=[simple]",
    ]


def launch(module: str, args: list[str], n: int = 2) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "P3_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env["P3_LAUNCH"], env["OMP_NUM_THREADS"] = str(n), "1"
    return subprocess.run([sys.executable, "-m", module, *args, "device=cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    run = launch("pixelspointspolygons_torch.cli.train", overrides(root) + ["training.device_cache=auto"])
    assert run.returncode == 0, run.stderr[-3000:]
    return root, run, compose(overrides(root))


def test_two_process_train_writes_once_and_reports_global_metrics(trained):
    root, run, cfg = trained
    histories = [eval(line) for line in run.stdout.splitlines() if line.startswith("{'epoch'")]  # noqa: S307
    assert len(histories) == 2 and histories[0] == histories[1] and histories[0]["epoch"] == 0
    # the device cache serves one process: `auto` takes the host loader on both
    assert run.stderr.count("device cache unavailable") == 2
    assert np.isfinite(histories[0]["loss"]) and 0.0 <= histories[0]["val_iou"] <= 1.0
    ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["best_val_loss.pt", "epoch_0.pt", "latest.pt"]
    payload = torch.load(os.path.join(ckpt_dir, "latest.pt"), weights_only=True)
    assert not any(k.startswith("module.") for k in payload["model"])
    build_ffl(cfg).load_state_dict(payload["model"])  # strict: the bare model's names
    assert payload["step"] == 2  # 4 tiles, 2 processes, batch 1 a process
    logs = os.listdir(os.path.join(cfg.output_dir, "runs"))
    assert logs == ["ffl_image.jsonl"]
    with open(os.path.join(cfg.output_dir, "runs", logs[0])) as f:
        records = [json.loads(line) for line in f]
    assert [r["_type"] for r in records] == ["config", "metrics"]
    assert records[1]["loss"] == pytest.approx(histories[0]["loss"], rel=1e-12)


def _sharpen_seg_head(cfg) -> None:
    """Rewrite `latest` in one process with its seg head shifted to the
    median of its logits on the test tiles and sharpened, so that its maps have
    contours to polygonize."""
    path = os.path.join(cfg.output_dir, "checkpoints", "latest.pt")
    payload = torch.load(path, weights_only=True)
    model = build_ffl(cfg).eval()
    model.load_state_dict(payload["model"])
    batch = next(iter(build_loader(cfg, "test", eval_mode=True, batch_size=3)))
    with torch.inference_mode():
        seg = model(to_device(batch, torch.device("cpu"), ("images",)))["seg"]
    shift = float(torch.logit(seg.double()).median())
    with torch.no_grad():
        model.seg_out.weight.mul_(20.0)
        model.seg_out.bias.sub_(shift).mul_(20.0)
    payload["model"] = model.state_dict()
    torch.save(payload, path)


def test_two_process_predict_writes_the_whole_split_once(trained):
    root, _, cfg = trained
    _sharpen_seg_head(cfg)
    # the sharpened map's regions are small and ragged: keep every polygon
    args = overrides(root) + ["evaluation=test", "checkpoint=latest", "experiment.polygonization.simple_method.min_area=1",
                              "experiment.polygonization.simple_method.seg_threshold=0.1"]
    run = launch("pixelspointspolygons_torch.cli.predict", args)
    assert run.returncode == 0, run.stderr[-3000:]
    pcfg = compose(args)
    pred_file = pcfg.evaluation.pred_file
    with open(pred_file) as f:
        two = f.read()
    with open(pred_file.replace(".json", "_time.json")) as f:
        assert json.load(f)["num_images"] == 3
    cli_predict.main(args + ["device=cpu"])
    with open(pred_file) as f:
        one = f.read()

    def as_set(text):
        return {json.dumps(a, sort_keys=True) for a in json.loads(text)}

    ids = [int(b["image_id"][0]) for b in build_loader(pcfg, "test", eval_mode=True)]
    # every tile has polygons, those of rank 1's own tile among them
    assert len(ids) == 3 and {a["image_id"] for a in json.loads(one)} == set(ids)
    assert len(json.loads(two)) == len(json.loads(one)) and as_set(two) == as_set(one)


def test_dryrun_multichip_runs_every_family(capfd, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned processes' torch threads
    graft_entry_torch.dryrun_multichip(2, device="cpu")
    lines = [line for line in capfd.readouterr().out.splitlines() if line.startswith("dryrun_multichip(2)")]
    assert [line.split()[1] for line in lines] == ["pix2poly", "hisup", "hisup-hrnet", "ffl"]
    assert all("OK" in line and "loss=" in line for line in lines)


def test_nccl_with_more_processes_than_cards_raises(monkeypatch):
    """No fallback: NCCL on 2 processes with 1 card raises before any group
    starts, through `init_distributed`, the CLIs' `process_group` and the
    dry run; gloo is taken only with `device=cpu`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one process per card"):
        parallel.init_distributed("cuda", world_size=2, rank=1, init_method="tcp://127.0.0.1:1")
    monkeypatch.setenv("P3_NUM_PROCESSES", "2")
    monkeypatch.setenv("P3_PROCESS_ID", "0")
    monkeypatch.setenv("P3_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="one process per card"):
        with process_group(None):
            pass
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        graft_entry_torch.dryrun_multichip(2)
    assert not parallel.is_distributed()


def test_nccl_places_each_process_on_its_local_card(monkeypatch):
    """Two hosts of one card each: the launcher's `LOCAL_RANK` and
    `LOCAL_WORLD_SIZE` put global rank 1 on `cuda:0` of its host."""
    started = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: started.setdefault("set", dev))
    monkeypatch.setattr(parallel.dist, "init_process_group", lambda backend, **kw: started.update(backend=backend, **kw))
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    dev = parallel.init_distributed("cuda", world_size=2, rank=1, init_method="tcp://127.0.0.1:1")
    assert dev == torch.device("cuda", 0) and started["set"] == dev and started["device_id"] == dev
    assert (started["backend"], started["world_size"], started["rank"]) == ("nccl", 2, 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="2 processes were asked for on this host"):
        parallel.init_distributed("cuda", world_size=4, rank=1, init_method="tcp://127.0.0.1:1")


def test_launch_ends_when_a_later_rank_fails(tmp_path):
    """`P3_LAUNCH=2`: rank 1 fails at once while rank 0 would run for two
    minutes; the launcher ends rank 0 and returns rank 1's code promptly."""
    (tmp_path / "p3_launch_probe.py").write_text(
        "import os, sys, time\n"
        "from pixelspointspolygons_torch import parallel\n"
        "rc = parallel.maybe_launch()\n"
        "if rc is not None:\n"
        "    sys.exit(rc)\n"
        "if os.environ['P3_PROCESS_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(120)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "P3_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env["P3_LAUNCH"] = "2"
    t = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "p3_launch_probe"], cwd=tmp_path, env=env, timeout=100)
    assert run.returncode == 3 and time.perf_counter() - t < 60
