"""The port's last script twins against the JAX package's scripts, on the CPU
at tiny sizes:

- `cli.postprocess_oracle`: the HiSup and Pix2Poly rows equal the script's
  functions' exactly (the same host code on the same ground truth); the
  FFL maps equal exactly (the same numpy and cv2 calls in the same order);
  the FFL ACM rows within ORACLE_FFL_TOL of JAX's: the ACM is chaotic at
  the ulp level (ROADMAP 3.9), so two packages' ACMs on the same maps may
  part by a pixel here and there, which moves a 64 px tile's IoU by about
  a hundredth; the printed report equals the script's; ROADMAP 3.20, the
  Pix2Poly branch reading the environment's dataset root in both
  packages;
- `cli.measure_predict_e2e`: the script's keys in its order, the tile
  count, and the same prediction file from every pass; under a test
  subset the tiles it predicted, where the script counts the config's
  (ROADMAP 3.22);
- `cli.profile`: a trace of each mode that holds the decode's operations;
- `cli.gather_pretrained_models`: the script's lines for two present and
  seven missing checkpoints;
- `cli.droplidar50_ablation` end to end on a tiny `p2p_fusion`: its two
  rows equal (ROADMAP 3.15);
- every twin refusing to start without a card unless given `device=cpu`.
"""

import collections
import contextlib
import io
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import pixelspointspolygons_tpu.predict.ffl_polygonize as jax_fp
from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.utils.coco import CocoIndex as JaxCocoIndex
from pixelspointspolygons_torch.cli import (_ablation, droplidar50_ablation, gather_pretrained_models, measure_predict_e2e,
                                            postprocess_oracle, profile)
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data import ensure_synthetic_dataset
from pixelspointspolygons_torch.models.pix2poly import factory as p2p_factory
from pixelspointspolygons_torch.train.state import TrainState, linear_warmup_decay, make_optimizer, make_scheduler
from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager
from pixelspointspolygons_torch.utils.coco import CocoIndex
from test_torch_entrypoints import _script
from test_torch_ffl import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_slice_lidar import P2P_ARGS
from test_torch_slice_lidar import overrides as lidar_overrides
from test_torch_train_pix2poly import tiny_vit  # noqa: F401 (a fixture)

ORACLE_S, ORACLE_N = 64, 3
ORACLE_FFL_TOL = 0.02


def _oracle_args(root) -> list[str]:
    return [f"host.dataset_root={root}/data", f"host.model_root={root}/out", f"experiment.encoder.in_size={ORACLE_S}",
            "experiment.dataset.num_train=2", f"experiment.dataset.num_val={ORACLE_N}", "experiment.dataset.num_test=2"]


def _printed(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Each package's oracle functions on the same tiles; JAX's maps taken
    from the Polygonizer it builds. The Pix2Poly branches read the dataset
    root from the environment (ROADMAP 3.20)."""
    root = tmp_path_factory.mktemp("oracle")
    base = ["experiment=ffl_image", "dataset=synthetic", "run_type=debug"] + _oracle_args(root)
    cfg, jcfg = compose(base), jax_compose(base)
    ensure_synthetic_dataset(cfg)
    script = _script("postprocess_oracle")
    jgt = JaxCocoIndex(jcfg.experiment.dataset.annotations["val"])
    gt = CocoIndex(cfg.experiment.dataset.annotations["val"])
    ids = list(gt.imgs)[:ORACLE_N]
    assert ids == list(jgt.imgs)[:ORACLE_N] and len(ids) == ORACLE_N
    seen = {}

    class Recorded(jax_fp.Polygonizer):
        def __call__(self, seg, crossfield, *args, **kwargs):
            seen["maps"] = (seg.copy(), crossfield.copy())
            return super().__call__(seg, crossfield, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("P3_DATASET_ROOT", str(root / "data"))
        mp.setattr(jax_fp, "Polygonizer", Recorded)
        want = {"ffl": script.oracle_ffl(jcfg, jgt, ids), "hisup": script.oracle_hisup(jcfg, jgt, ids),
                "pix2poly": script.oracle_pix2poly(jcfg, jgt, ids)}
        got = {"ffl": postprocess_oracle.oracle_ffl(cfg, gt, ids, device="cpu"),
               "hisup": postprocess_oracle.oracle_hisup(cfg, gt, ids),
               "pix2poly": postprocess_oracle.oracle_pix2poly(cfg, gt, ids)}
    return {"root": root, "cfg": cfg, "gt": gt, "ids": ids, "want": want, "got": got, "jax_maps": seen["maps"]}


@pytest.mark.parametrize("family", ["hisup", "pix2poly"])
def test_oracle_host_rows_equal_the_script(oracle, family):
    assert oracle["got"][family] == oracle["want"][family]
    assert set(oracle["got"][family][family]) == {"IoU", "C-IoU", "NR"}


def test_oracle_ffl_maps_equal_the_script(oracle):
    seg, cf = postprocess_oracle.ffl_maps(oracle["cfg"], oracle["gt"], oracle["ids"])
    want_seg, want_cf = oracle["jax_maps"]
    assert seg.shape == (ORACLE_N, 1, ORACLE_S, ORACLE_S) and cf.shape == (ORACLE_N, 4, ORACLE_S, ORACLE_S)
    np.testing.assert_array_equal(seg, want_seg)
    np.testing.assert_array_equal(cf, want_cf)
    assert 0.0 < seg.mean() < 1.0


def test_oracle_ffl_rows_within_tolerance(oracle):
    got, want = oracle["got"]["ffl"], oracle["want"]["ffl"]
    assert list(got) == list(want) == ["ffl.acm.tol_1", "ffl.acm.tol_2", "ffl.acm.tol_3"]
    for row in want:
        assert set(got[row]) == set(want[row]) == {"IoU", "C-IoU", "NR"}
        for k in want[row]:
            assert abs(got[row][k] - want[row][k]) <= ORACLE_FFL_TOL, (row, k, got[row], want[row])
    assert got["ffl.acm.tol_1"]["IoU"] > 0.85


@pytest.mark.parametrize("model", ["hisup", "pix2poly"])
def test_oracle_report_equals_the_script(oracle, model, monkeypatch):
    """`main`'s printed report, the `model=` and `n=` keys parsed as the
    script parses them."""
    args = [f"model={model}", f"n={ORACLE_N}"] + _oracle_args(oracle["root"])
    monkeypatch.setenv("P3_DATASET_ROOT", str(oracle["root"] / "data"))
    monkeypatch.setattr(sys, "argv", ["postprocess_oracle.py"] + args)
    want = _printed(_script("postprocess_oracle").main)
    got = _printed(postprocess_oracle.main, args + ["device=cpu"])
    assert got == want and json.loads(got) == oracle["want"][model]


def test_oracle_pix2poly_reads_the_environment_root(oracle, tmp_path, monkeypatch):
    """ROADMAP 3.20: the Pix2Poly branch composes its own config, so the
    command line's `host.dataset_root` does not reach its dataset; with the
    environment's root elsewhere both packages look for the tiles there."""
    elsewhere = tmp_path / "elsewhere"
    monkeypatch.setenv("P3_DATASET_ROOT", str(elsewhere))
    script = _script("postprocess_oracle")
    jcfg = jax_compose(["experiment=ffl_image", "dataset=synthetic", "run_type=debug"] + _oracle_args(oracle["root"]))
    for fn, cfg in ((script.oracle_pix2poly, jcfg), (postprocess_oracle.oracle_pix2poly, oracle["cfg"])):
        assert str(cfg.experiment.dataset.in_path).startswith(str(oracle["root"]))
        with pytest.raises(FileNotFoundError, match=str(elsewhere)):
            fn(cfg, oracle["gt"], oracle["ids"])


# --- the predict timer --------------------------------------------------------------

E2E_ARGS = ["experiment.encoder.in_size=32", "experiment.encoder.patch_feature_dim=32",
            "experiment.model.decoder.in_feature_dim=32", "experiment.model.decoder.num_layers=1",
            "experiment.model.decoder.num_heads=4", "experiment.model.tokenizer.max_num_vertices=8",
            "experiment.model.sinkhorn_iterations=5"]


def _seeded_checkpoint(cfg, name: str) -> None:
    model = p2p_factory.build_pix2poly(cfg, generator=torch.Generator().manual_seed(0))
    opt = make_optimizer("adamw", model.parameters(), 3e-4)
    state = TrainState(model, opt, make_scheduler(opt, linear_warmup_decay(3e-4, 10), 3e-4))
    CheckpointManager(cfg.output_dir).save(name, state, 0, cfg)


def _recording(get_predictor, files: list):
    """`get_predictor` whose predictors append the text of each prediction
    file they write to `files`."""
    def recorded(*args, **kwargs):
        predictor = get_predictor(*args, **kwargs)
        predict = predictor.predict_dataset

        def predict_dataset(split):
            path = predict(split)
            with open(path) as f:
                files.append(f.read())
            return path

        predictor.predict_dataset = predict_dataset
        return predictor

    return recorded


def test_measure_predict_e2e_prints_the_scripts_line(tiny_vit, tmp_path, monkeypatch, capsys):
    """One JSON line with the script's keys in its order; the tiles of the
    split; four passes that write the same prediction file."""
    args = ["experiment=p2p_image", "dataset=synthetic", "run_type=debug", f"host.dataset_root={tmp_path}/data",
            f"host.model_root={tmp_path}/out", "experiment.dataset.num_train=2", "experiment.dataset.num_val=2",
            "experiment.dataset.num_test=3", "run_type.test_subset=null", "experiment.model.batch_size=2",
            "evaluation=test", "checkpoint=latest", *E2E_ARGS]
    cfg = compose(args)
    ensure_synthetic_dataset(cfg)
    _seeded_checkpoint(cfg, "latest")
    files = []
    monkeypatch.setattr(measure_predict_e2e, "get_predictor", _recording(measure_predict_e2e.get_predictor, files))
    report = measure_predict_e2e.main(args + ["device=cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == report
    test_ids = set(CocoIndex(cfg.experiment.dataset.annotations["test"]).imgs)
    assert len(files) == 4 and len(set(files)) == 1 and {a["image_id"] for a in json.loads(files[0])} <= test_ids
    assert report["tiles"] == 3 and report["split"] == "test" and report["checkpoint"] == "latest"
    warm = report["warm_s_median"]  # rounded to 0.01 s, the rate from the unrounded seconds
    assert 3 / (warm + 0.005) <= report["warm_tiles_per_s"] <= 3 / max(warm - 0.005, 1e-9) and report["cold_s"] >= 0

    class Idle:
        def predict_dataset(self, split):
            time.sleep(0.001)  # a wall the script can divide by: an instant call can read 0.0 s

    predict_script = _script("predict")
    monkeypatch.setattr(predict_script, "get_predictor", lambda cfg: Idle())
    monkeypatch.setattr(sys, "argv", ["measure_predict_e2e.py"] + args)
    _script("measure_predict_e2e").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(report) == list(want)
    assert {k: report[k] for k in ("experiment", "split", "tiles", "batch_size", "checkpoint")} == {
        k: want[k] for k in ("experiment", "split", "tiles", "batch_size", "checkpoint")}


def test_measure_predict_e2e_counts_the_tiles_it_predicted(tiny_vit, tmp_path, monkeypatch, capsys):
    """ROADMAP 3.22: under `run_type.test_subset=2` of a 3-tile split each
    pass predicts 2 tiles, and the twin reports 2 and a rate over them;
    the script reports the config's `num_test`, 3."""
    args = ["experiment=p2p_image", "dataset=synthetic", "run_type=debug", f"host.dataset_root={tmp_path}/data",
            f"host.model_root={tmp_path}/out", "experiment.dataset.num_train=2", "experiment.dataset.num_val=2",
            "experiment.dataset.num_test=3", "run_type.test_subset=2", "experiment.model.batch_size=2",
            "evaluation=test", "checkpoint=latest", *E2E_ARGS]
    cfg = compose(args)
    ensure_synthetic_dataset(cfg)
    _seeded_checkpoint(cfg, "latest")
    files = []
    monkeypatch.setattr(measure_predict_e2e, "get_predictor", _recording(measure_predict_e2e.get_predictor, files))
    report = measure_predict_e2e.main(args + ["device=cpu"])
    capsys.readouterr()
    assert len(files) == 4 and all(len({a["image_id"] for a in json.loads(f)}) <= 2 for f in files)
    assert report["tiles"] == 2
    warm = report["warm_s_median"]
    assert 2 / (warm + 0.005) <= report["warm_tiles_per_s"] <= 2 / max(warm - 0.005, 1e-9)

    class Idle:
        def predict_dataset(self, split):
            time.sleep(0.001)  # a wall the script can divide by: an instant call can read 0.0 s

    monkeypatch.setattr(_script("predict"), "get_predictor", lambda cfg: Idle())
    monkeypatch.setattr(sys, "argv", ["measure_predict_e2e.py"] + args)
    _script("measure_predict_e2e").main()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["tiles"] == 3


# --- the profiler trace --------------------------------------------------------------

PROFILE_ARGS = ["experiment.encoder.patch_size=32", "experiment.encoder.patch_feature_dim=32",
                "experiment.model.decoder.in_feature_dim=32", "experiment.model.decoder.num_layers=1",
                "experiment.model.decoder.num_heads=4", "experiment.model.tokenizer.max_num_vertices=4",
                "experiment.model.sinkhorn_iterations=5"]


@pytest.mark.parametrize("mode", ["generate", "train"])
def test_profile_writes_a_trace_of_the_decode(mode, tiny_vit, tmp_path, capsys):
    """Three traced runs of the script's step on 224 px images (patches of
    32 here): the decode's operations in the trace, three times over. The
    greedy decode embeds and takes the argmax at each of its max_len - 1 =
    9 steps; the train step embeds the sequence once and differentiates
    through it."""
    out = profile.main([str(tmp_path / "trace"), mode] + PROFILE_ARGS + ["device=cpu"])
    assert out["path"] == str(tmp_path / "trace" / f"trace_{mode}.json") and out["export_s"] >= 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"trace written to {tmp_path / 'trace'} (mode={mode})"
    with open(out["path"]) as f:
        events = json.load(f)["traceEvents"]
    ops = collections.Counter(e["name"] for e in events if e.get("cat") == "cpu_op")
    if mode == "generate":
        assert ops["aten::argmax"] == ops["aten::embedding"] == 3 * 9
    else:
        assert ops["aten::embedding"] == ops["autograd::engine::evaluate_function: EmbeddingBackward0"] == 3
        assert ops["aten::logsumexp"] >= 3 * 2 * 5  # the Sinkhorn's rows and columns
    assert ops["aten::addmm"] >= 3


def test_profile_takes_the_number_of_traced_runs(tiny_vit, tmp_path):
    """`runs` after the mode: one traced decode holds each step's argmax
    once (the script itself always traces three)."""
    out = profile.main([str(tmp_path / "trace"), "generate", "1"] + PROFILE_ARGS + ["device=cpu"])
    with open(out["path"]) as f:
        events = json.load(f)["traceEvents"]
    ops = collections.Counter(e["name"] for e in events if e.get("cat") == "cpu_op")
    assert ops["aten::argmax"] == ops["aten::embedding"] == 9


# --- the checkpoint gatherer ------------------------------------------------------------

PRESENT = ("p2p_image", "hisup_fusion")


def test_gather_pretrained_models_prints_the_scripts_lines(tmp_path, monkeypatch):
    """Two experiments with a `best_val_iou` and seven without: the twin
    copies each file where the script copies its checkpoint directory, and
    prints the same lines (its destination is the file)."""
    args = [f"host.model_root={tmp_path}/out"]
    printed = {}
    for side in ("script", "twin"):
        for exp in PRESENT:
            out_dir = (jax_compose if side == "script" else compose)([f"experiment={exp}"] + args).output_dir
            ckpt = os.path.join(out_dir, "checkpoints", "best_val_iou")
            if side == "script":
                os.makedirs(ckpt)
                with open(os.path.join(ckpt, "checkpoint"), "w") as f:
                    f.write(exp)
            else:
                with open(ckpt + ".pt", "w") as f:
                    f.write(exp)
        run_dir = tmp_path / side
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        if side == "script":
            monkeypatch.setattr(sys, "argv", ["gather_pretrained_models.py"] + args)
            printed[side] = _printed(_script("gather_pretrained_models").main).splitlines()
        else:
            printed[side] = _printed(gather_pretrained_models.main, args + ["device=cpu"]).splitlines()
        assert sorted(os.listdir(run_dir / "gathered_pretrained")) == sorted(PRESENT)
    assert gather_pretrained_models.EXPERIMENTS == _script("gather_pretrained_models").EXPERIMENTS
    assert printed["twin"] == [line + ".pt" if line.startswith("gathered ") else line for line in printed["script"]]
    assert len(printed["twin"]) == 9 and sum(line.startswith("[skip] ") for line in printed["twin"]) == 7
    for exp in PRESENT:
        with open(tmp_path / "twin" / "gathered_pretrained" / exp / "best_val_iou.pt") as f:
            assert f.read() == exp


# --- the LiDAR-dropout ablation, ROADMAP 3.15 ------------------------------------------


def test_droplidar50_rows_are_equal(tiny_vit, tmp_path, monkeypatch):
    """ROADMAP 3.15: a seeded tiny `p2p_fusion` as `best_val_iou`; the
    `no_lidar` row's override reaches no module, so both rows predict with
    the same model on the same LiDAR and score the same."""
    monkeypatch.chdir(tmp_path)
    args = lidar_overrides(tmp_path, "p2p_fusion", P2P_ARGS)
    cfg = compose(["experiment=p2p_fusion", "experiment.lidar_dropout=0.5", "evaluation=test",
                   "checkpoint=best_val_iou"] + args)
    ensure_synthetic_dataset(cfg)
    _seeded_checkpoint(cfg, "best_val_iou")
    files = []
    monkeypatch.setattr(_ablation, "get_predictor", _recording(_ablation.get_predictor, files))
    df = droplidar50_ablation.main(args + ["device=cpu"])
    assert list(df["variant"]) == ["with_lidar", "no_lidar"] and df["num_images"][0] == 2
    assert len(files) == 2 and files[0] == files[1] and json.loads(files[0])
    rows = df.drop(columns=["variant", "prediction_time"]).to_dict("records")
    assert rows[0] == rows[1] and 0.0 <= rows[0]["IoU"] <= 1.0
    with open(tmp_path / "droplidar50_ablation.csv") as f:
        assert f.readline().strip().split(",")[0] == "variant"


# --- no card, no run -------------------------------------------------------------------

REFUSALS = {
    "postprocess_oracle": (postprocess_oracle, ["model=hisup"]),
    "measure_predict_e2e": (measure_predict_e2e, ["experiment=p2p_image", "dataset=synthetic", "evaluation=test"]),
    "profile": (profile, []),
    "gather_pretrained_models": (gather_pretrained_models, []),
    "droplidar50_ablation": (droplidar50_ablation, ["dataset=synthetic"]),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_twin_refuses_to_start_without_a_card(name, tmp_path, monkeypatch):
    """Without `device=cpu` each twin asks for the card, and on a machine
    without one it raises before it reads or writes anything."""
    monkeypatch.chdir(tmp_path)
    twin, args = REFUSALS[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            twin.main(args + [f"host.model_root={tmp_path}/out", f"host.dataset_root={tmp_path}/data"])
        assert not os.listdir(tmp_path)
