"""The port's last entry points and host modules against the JAX package's
scripts and modules, on the CPU:

- the ablation twins (`cli.modality_ablation`, `lidar_density_ablation`,
  `all_countries`, `dino_v2_ablation`, `image_res_ablation`,
  `droplidar50_ablation`): each run's
  overrides, its `[skip]` line and its CSV equal the script's, with every
  checkpoint missing; three twins end to end on a tiny synthetic split
  with `device=cpu`: `modality_ablation` cut to one experiment (and
  refusing to start without a card otherwise), `lidar_density_ablation`
  at two caps from one set of weights and a third cap's `[skip]`,
  `all_countries` with one fusion row at `country=all` and a second row's
  `[skip]`, their rows in the scripts' order;
- `cli.csv_results_to_latex` against the script's table; `cli.evaluate_gt`
  reports the perfect scores on the ground truth;
- `cli.preprocess_ffl`: the stats equal the JAX dataset's interior
  fractions of the same tiles, and the cache files read back as JAX's
  ground truth (exact: the same numpy and cv2 calls);
- `predict/afm_squeeze.py` equal to JAX's on the same AFM (numpy copies);
- `utils/visualization.py`: each plot's file is written, and
  `denormalize_image` and `c0c2_to_uv_numpy` equal JAX's exactly; the
  Pix2Poly trainer's val figure, and a figure that fails not stopping
  `train`; `cli.wireframe_loader` against the script;
- ROADMAP 3.18: with `encoder.in_size` 512 on 224 px tiles both packages'
  FFL loss fails at its first product of the maps and the ground truth,
  the port with a message that says so.
"""

import contextlib
import io
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.data import P3Dataset as JaxDataset
from pixelspointspolygons_tpu.models.ffl import losses as jax_losses
from pixelspointspolygons_tpu.predict import afm_squeeze as jax_squeeze
from pixelspointspolygons_tpu.predict.ffl_polygonize import c0c2_to_uv_numpy as jax_c0c2_to_uv
from pixelspointspolygons_tpu.utils import visualization as jax_vis
from pixelspointspolygons_torch.cli import (_ablation, all_countries, csv_results_to_latex, dino_v2_ablation,
                                            droplidar50_ablation, evaluate_gt, image_res_ablation,
                                            lidar_density_ablation, modality_ablation, preprocess_ffl,
                                            wireframe_loader)
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data import P3Dataset, ensure_synthetic_dataset
from pixelspointspolygons_torch.models.ffl import build_ffl
from pixelspointspolygons_torch.models.ffl import losses
from pixelspointspolygons_torch.models.ffl import model as ffl_model
from pixelspointspolygons_torch.ops.afm import afm
from pixelspointspolygons_torch.predict import afm_squeeze
from pixelspointspolygons_torch.predict.ffl_polygonize import c0c2_to_uv_numpy
from pixelspointspolygons_torch.train.trainer_pix2poly import Pix2PolyTrainer
from pixelspointspolygons_torch.utils import visualization
from test_torch_ffl import VIT, one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_train_pix2poly import overrides as p2p_overrides
from test_torch_train_pix2poly import tiny_vit  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
S = 32


def _synthetic(root, extra=()):
    return ["dataset=synthetic", "run_type=debug", f"host.dataset_root={root}/data", f"host.model_root={root}/out",
            "experiment.dataset.num_train=4", "experiment.dataset.num_val=2", "experiment.dataset.num_test=4",
            "run_type.train_subset=null", "run_type.val_subset=null", "run_type.test_subset=null",
            "experiment.model.batch_size=2", f"experiment.encoder.in_size={S}", *extra]


def _script(name: str):
    """A module of scripts/, which is put last on sys.path: its `profile.py`
    must not hide the standard library's."""
    if SCRIPTS not in sys.path:
        sys.path.append(SCRIPTS)
    import importlib

    return importlib.import_module(name)


# --- the ablation twins --------------------------------------------------------

TWINS = {
    "modality_ablation": (modality_ablation, "EXPERIMENTS"),
    "lidar_density_ablation": (lidar_density_ablation, "DENSITIES"),
    "all_countries": (all_countries, "EXPERIMENTS"),
    "dino_v2_ablation": (dino_v2_ablation, "ENCODERS"),
    "image_res_ablation": (image_res_ablation, "CONFIGS"),
    "droplidar50_ablation": (droplidar50_ablation, "VARIANTS"),
}


def _missing_checkpoint(*args, **kwargs):
    raise FileNotFoundError("checkpoint 'best_val_iou' not found")


def _recorded(compose_fn, seen: list):
    def record(overrides):
        seen.append(list(overrides))
        return compose_fn(overrides)
    return record


@pytest.mark.parametrize("name", list(TWINS))
def test_ablation_twin_runs_as_its_script(name, tmp_path, monkeypatch):
    """Every run of the twin composes the script's overrides (the command
    line's after them), and with no checkpoint each prints the script's
    `[skip]` line; both write the same CSV."""
    twin, list_name = TWINS[name]
    script = _script(name)
    assert getattr(twin, list_name) == getattr(script, list_name)
    extra = ["run_type=debug", "dataset=synthetic"]
    outputs = {}
    for side in ("script", "twin"):
        seen = []
        run_dir = tmp_path / side
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if side == "script":
                monkeypatch.setattr(script, "compose", _recorded(script.compose, seen))
                monkeypatch.setattr(script, "get_predictor", _missing_checkpoint)
                monkeypatch.setattr(sys, "argv", [name] + extra)
                script.main()
            else:
                monkeypatch.setattr(_ablation, "compose", _recorded(_ablation.compose, seen))
                monkeypatch.setattr(_ablation, "get_predictor", _missing_checkpoint)
                twin.main(extra + ["device=cpu"])
        with open(run_dir / f"{name}.csv") as f:
            outputs[side] = (seen, out.getvalue(), f.read())
    assert outputs["twin"] == outputs["script"]
    seen, printed, _ = outputs["twin"]
    assert len(seen) == len(getattr(twin, list_name)) and all(o[-2:] == extra for o in seen)
    assert printed.count("[skip] ") == len(seen)


def test_dino_v2_rows_share_one_checkpoint():
    """ROADMAP 3.19: the output directory names the model, the input size
    and the experiment, not the encoder, so the two rows of the DINOv2
    ablation read one `best_val_iou`, in JAX as in the port."""
    for compose_fn in (compose, jax_compose):
        dirs = {compose_fn(o + ["run_type=debug"]).output_dir for _, o, _ in dino_v2_ablation.runs()}
        assert len(dirs) == 1


@pytest.fixture()
def tiny_vit_cnn(monkeypatch):
    full = ffl_model.encoder_config
    monkeypatch.setattr(ffl_model, "encoder_config", lambda cfg: {**full(cfg), "dim": VIT["dim"], "depth": 1,
                                                                  "num_heads": VIT["num_heads"]})


def test_modality_ablation_end_to_end_on_cpu(tiny_vit_cnn, tmp_path, monkeypatch, capsys):
    """The twin cut to `ffl_image` here: a seeded tiny FFL written as
    `best_val_iou` is predicted and evaluated on the 4-tile test split."""
    monkeypatch.setattr(modality_ablation, "EXPERIMENTS", ["ffl_image"])
    monkeypatch.chdir(tmp_path)
    args = _synthetic(tmp_path, ["experiment.model.decoder.in_feature_dim=32",
                                 "experiment.polygonization.acm_method.steps=20", "evaluation.modes=[iou,coco]"])
    cfg = compose(["experiment=ffl_image", "evaluation=test", "checkpoint=best_val_iou"] + args)
    torch.manual_seed(0)
    model = build_ffl(cfg)
    os.makedirs(os.path.join(cfg.output_dir, "checkpoints"))
    torch.save({"model": model.state_dict(), "epoch": 0, "cfg": cfg.to_dict()},
               os.path.join(cfg.output_dir, "checkpoints", "best_val_iou.pt"))
    df = modality_ablation.main(args + ["device=cpu"])
    assert list(df["experiment"]) == ["ffl_image"] and 0.0 <= float(df["IoU"][0]) <= 1.0
    assert df["num_images"][0] == 4 and "[skip]" not in capsys.readouterr().out
    with open(tmp_path / "modality_ablation.csv") as f:
        header = f.readline().strip().split(",")
    assert header[0] == "experiment" and {"IoU", "C-IoU", "AP"} <= set(header)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            modality_ablation.main(args)


def _skip_lines(printed: str) -> list[str]:
    return [line for line in printed.splitlines() if line.startswith("[skip] ")]


def test_lidar_density_ablation_end_to_end_on_cpu(tiny_vit_cnn, tmp_path, monkeypatch, capsys):
    """The twin cut to three caps: one seeded tiny FFL-LiDAR written as
    `best_val_iou` of caps 4 and 64 (a cap changes the grouping, not the
    parameters: the cap-64 model loads the cap-4 weights strictly), none of
    cap 8. Caps 4 and 64 are predicted and scored in the script's order, and
    cap 8 prints the script's `[skip] mnv=8: ...` line."""
    caps = [4, 8, 64]
    monkeypatch.setattr(lidar_density_ablation, "DENSITIES", caps)
    monkeypatch.chdir(tmp_path)
    args = _synthetic(tmp_path, ["experiment.model.decoder.in_feature_dim=32", "experiment.encoder.max_num_points=256",
                                 "experiment.polygonization.acm_method.steps=20", "evaluation.modes=[iou,coco]"])
    cfgs = {mnv: compose([f"experiment=lidar_density_ablation{mnv}", "evaluation=test", "checkpoint=best_val_iou"]
                         + args) for mnv in caps}
    assert {mnv: int(c.experiment.encoder.max_num_points_per_voxel) for mnv, c in cfgs.items()} == {m: m for m in caps}
    torch.manual_seed(0)
    weights = build_ffl(cfgs[4]).state_dict()
    build_ffl(cfgs[64]).load_state_dict(weights)
    for mnv in (4, 64):
        os.makedirs(os.path.join(cfgs[mnv].output_dir, "checkpoints"))
        torch.save({"model": weights, "epoch": 0, "cfg": cfgs[mnv].to_dict()},
                   os.path.join(cfgs[mnv].output_dir, "checkpoints", "best_val_iou.pt"))
    df = lidar_density_ablation.main(args + ["device=cpu"])
    script_runs = [mnv for mnv in _script("lidar_density_ablation").DENSITIES if mnv in (4, 64)]
    assert list(df["max_num_points_per_voxel"]) == script_runs == [4, 64]
    assert list(df["num_images"]) == [4, 4] and all(0.0 <= float(v) <= 1.0 for v in df["IoU"])
    assert [line.split(":")[0] for line in _skip_lines(capsys.readouterr().out)] == ["[skip] mnv=8"]
    with open(tmp_path / "lidar_density_ablation.csv") as f:
        assert f.readline().strip().split(",")[0] == "max_num_points_per_voxel"


def test_all_countries_end_to_end_on_cpu(tiny_vit, tmp_path, monkeypatch, capsys):
    """The twin with a seeded tiny p2p_fusion as `best_val_iou` and no
    ffl_fusion checkpoint: the p2p_fusion row predicts and scores the test
    split of `country=all` (the per-country files written beside the CH
    tree), and ffl_fusion prints the script's `[skip] ffl_fusion: ...`
    line."""
    from test_torch_script_twins import _seeded_checkpoint
    from test_torch_slice_lidar import P2P_ARGS
    from test_torch_slice_lidar import overrides as lidar_overrides

    monkeypatch.setattr(all_countries, "EXPERIMENTS", ["p2p_fusion", "ffl_fusion"])
    monkeypatch.chdir(tmp_path)
    args = [o for o in lidar_overrides(tmp_path, "p2p_fusion", P2P_ARGS)
            if not o.startswith(("experiment=", "experiment.dataset.country="))]
    run = all_countries.runs()[0][1]
    cfg = compose(run + args)
    assert str(cfg.experiment.dataset.country) == "all"
    ensure_synthetic_dataset(cfg)
    _seeded_checkpoint(cfg, "best_val_iou")
    df = all_countries.main(args + ["device=cpu"])
    script_runs = [e for e in _script("all_countries").EXPERIMENTS if e == "p2p_fusion"]
    assert list(df["experiment"]) == script_runs == ["p2p_fusion"] and df["num_images"][0] == 2
    assert 0.0 <= float(df["IoU"][0]) <= 1.0
    assert cfg.evaluation.pred_file.startswith(cfg.output_dir) and os.path.isfile(cfg.evaluation.pred_file)
    assert cfg.experiment.dataset.annotations["test"].endswith("annotations_all_test.json")
    assert [line.split(":")[0] for line in _skip_lines(capsys.readouterr().out)] == ["[skip] ffl_fusion"]


# --- the paper table and the ground truth's scores -----------------------------


def test_csv_results_to_latex_matches_the_script(tmp_path, monkeypatch):
    import pandas as pd

    rows = [{"experiment": e, "IoU": 0.5 + 0.1 * i, "polis": 3.0 - i, "AP": 0.2 * i} for i, e in
            enumerate(["p2p_image", "hisup_image", "ffl_image"])]
    paths = []
    for i in (0, 1):
        paths.append(str(tmp_path / f"r{i}.csv"))
        pd.DataFrame(rows[i:i + 2]).to_csv(paths[-1], index=False)
    argv = paths + ["type=modality", "caption=Two files"]
    script = _script("csv_results_to_latex")
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["csv_results_to_latex.py"] + argv)
    with contextlib.redirect_stdout(out):
        script.main()
    tex = csv_results_to_latex.main(argv + [f"out={tmp_path}/t.tex"])
    assert tex + "\n" == out.getvalue() and "Two files" in tex
    with open(tmp_path / "t.tex") as f:
        assert f.read() == tex


def test_evaluate_gt_reports_perfect_scores(tmp_path, capsys):
    args = ["experiment=hisup_image"] + _synthetic(tmp_path)
    ensure_synthetic_dataset(compose(args))
    results = evaluate_gt.main(args + ["device=cpu"])
    for k, want, _ in evaluate_gt.PERFECT:
        assert results[k] == pytest.approx(want, abs=1e-6), k
    assert "GT self-eval perfect" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate_gt.main(args)


# --- FFL preprocessing --------------------------------------------------------


def test_preprocess_ffl_matches_the_jax_dataset(tmp_path):
    """Stats of every split equal to the JAX dataset's interior fractions
    of the same tiles, and cache files that the port's loader reads back
    as JAX's ground truth."""
    args = ["experiment=ffl_image"] + _synthetic(tmp_path)
    freqs = preprocess_ffl.main(args)
    cfg, jcfg = compose(args), jax_compose(args)
    for split in ("train", "val", "test"):
        jds, ds = JaxDataset(jcfg, split), P3Dataset(cfg, split)
        fracs, n = [], len(ds)
        assert n and len(os.listdir(os.path.join(ds.dataset_dir, "ffl_cache_torch", split))) == n
        for i in range(n):
            want = jds._ffl_gt(jds.coco.imgs[jds.tile_ids[i]])
            got = ds._ffl_gt(ds.coco.imgs[ds.tile_ids[i]])
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            fracs.append(float((want["gt_polygons_image"][..., 0] > 0).mean()))
        f = float(np.mean(fracs))
        assert freqs[split] == f
        stats = np.load(cfg.experiment.dataset.ffl_stats[split])["class_freq"]
        np.testing.assert_array_equal(stats, np.array([1.0 - f, f], np.float32))
        np.testing.assert_array_equal(P3Dataset(cfg, split).class_freq, stats)


# --- AFM squeeze ------------------------------------------------------------------


def test_afm_squeeze_matches_jax():
    """The port's plain AFM of a few long segments, squeezed into segments by
    both packages' copies."""
    r = np.random.RandomState(0)
    lines = torch.from_numpy(r.uniform(4, 60, (1, 6, 4)).astype(np.float32))
    afmap, _ = afm(lines, torch.ones(1, 6, dtype=torch.bool), 64, 64)
    amap = afmap[0].numpy().astype(np.float64)
    pts, angs = afm_squeeze.afm_to_points(amap)
    want_pts, want_angs = jax_squeeze.afm_to_points(amap)
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(angs, want_angs)
    for kw in ({}, {"cell": 3.0, "min_points": 6}):
        got, want = afm_squeeze.afm_to_line_segments(amap, **kw), jax_squeeze.afm_to_line_segments(amap, **kw)
        assert len(got) == len(want) and len(want) >= 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# --- plots -----------------------------------------------------------------------


def test_visualization_writes_every_plot(tmp_path):
    r = np.random.RandomState(1)
    image = r.uniform(-2, 2, (S, S, 3)).astype(np.float32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    for maxv in (255.0, 1.0):
        got = visualization.denormalize_image(image, mean, std, maxv)
        np.testing.assert_array_equal(got, jax_vis.denormalize_image(image, mean, std, maxv))
    cf = r.normal(size=(4, S, S)).astype(np.float32)
    for a, b in zip(c0c2_to_uv_numpy(cf), jax_c0c2_to_uv(cf)):
        np.testing.assert_array_equal(a, b)
    disp = visualization.denormalize_image(image, mean, std)
    polys = [np.array([[2.0, 2.0], [12.5, 3.0], [10.0, 14.0]]), np.array([[20.0, 20.0], [30.0, 21.0], [25.0, 29.5]])]
    plots = {
        "image.png": lambda f: visualization.plot_image(disp, f),
        "image_u8.png": lambda f: visualization.plot_image((disp * 255).astype(np.uint8), f),
        "cloud.png": lambda f: visualization.plot_point_cloud(r.uniform(0, 50, (500, 3)), f),
        "polygons.png": lambda f: visualization.plot_polygons(polys, f, image=disp, gt=[p + 1 for p in polys]),
        "polygons_white.png": lambda f: visualization.plot_polygons(polys, f),
        "mask.png": lambda f: visualization.plot_mask(r.rand(S, S) > 0.5, f),
        "crossfield.png": lambda f: visualization.plot_crossfield(cf, f, stride=8, image=disp),
    }
    for name, plot in plots.items():
        path = str(tmp_path / "plots" / name)
        plot(path)
        img = cv2.imread(path)
        assert img is not None and img.std() > 0, name


@pytest.mark.parametrize("broken", [False, True])
def test_pix2poly_trainer_logs_its_val_figure(broken, tiny_vit, tmp_path, monkeypatch):  # noqa: F811
    """One epoch of the tiny Pix2Poly trainer: its val-IoU pass writes
    `val_prediction_0.png`, not blank; a figure that fails leaves no file
    and the run goes on to its end."""
    if broken:
        def fail(*args, **kwargs):
            raise ValueError("no figure")
        monkeypatch.setattr(visualization, "prediction_figure", fail)
    cfg = compose(p2p_overrides(tmp_path, ["experiment.model.num_epochs=1"]))
    history = Pix2PolyTrainer(cfg, device="cpu").train()
    assert history["epoch"] == 0 and 0.0 <= history["val_iou"] <= 1.0
    path = os.path.join(cfg.output_dir, "runs", "images", "val_prediction_0.png")
    if broken:
        assert not os.path.exists(path)
        return
    img = cv2.imread(path)
    assert img is not None and img.shape[0] >= 400 - S and img.std() > 0


def test_wireframe_loader_matches_the_script(tmp_path, monkeypatch):
    """The val split's targets assembled into the same polygon counts as the
    script's, drawn into the same files."""
    args = ["experiment=p2p_image"] + _synthetic(tmp_path)
    printed = {}
    for side in ("script", "twin"):
        run_dir = tmp_path / side
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if side == "script":
                monkeypatch.setattr(sys, "argv", ["test_wireframe_loader.py"] + args)
                _script("test_wireframe_loader").main()
            else:
                wireframe_loader.main(args)
        printed[side] = out.getvalue()
        assert sorted(os.listdir(run_dir / "wireframe_debug")) == ["tile_0.png", "tile_1.png"]
        assert cv2.imread(str(run_dir / "wireframe_debug" / "tile_0.png")) is not None
    assert printed["twin"] == printed["script"] and "polygons" in printed["twin"]


# --- ROADMAP 3.18 ----------------------------------------------------------------


def test_ffl_at_512_on_224_tiles_fails_in_the_loss_as_in_jax():
    """`encoder=unetresnet101 experiment.encoder.in_size=512` on the 224 px
    tiles of the P3 dataset: the model's maps are 512 px and the ground
    truth 224 px; JAX's seg loss fails at its first product of the two, and
    the port's at the same point, saying why."""
    args = ["experiment=ffl_image", "encoder=unetresnet101", "experiment.encoder.in_size=512"]
    cfg = compose(args)
    assert int(cfg.experiment.model.decoder.in_feature_size) == 512
    assert int(cfg.experiment.model.decoder.in_feature_dim) == 32
    r = np.random.RandomState(2)
    seg = r.uniform(0.01, 0.99, (2, 1, 512, 512)).astype(np.float32)
    gt = {"gt_polygons_image": r.uniform(0, 1, (2, 3, 224, 224)).astype(np.float32)}
    kw = dict(bce_coef=1.0, dice_coef=0.2, seg_type="bool", gt_channels=[0], use_weights=False)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_losses.seg_loss({"seg": jnp.asarray(seg)}, {k: jnp.asarray(v) for k, v in gt.items()}, **kw)
    with pytest.raises(ValueError, match="encoder.in_size must be the tiles' size"):
        losses.seg_loss({"seg": torch.from_numpy(seg)}, {k: torch.from_numpy(v) for k, v in gt.items()}, **kw)
    ok = losses.seg_loss({"seg": torch.from_numpy(seg[..., :224, :224].copy())},
                         {k: torch.from_numpy(v) for k, v in gt.items()}, **kw)
    assert torch.isfinite(ok)
