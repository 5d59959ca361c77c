"""The port's FFL prediction against the JAX package's, on the CPU: a tiny
`vit_cnn` FFL (tests/test_ffl.py::tiny_ffl's sizes) with the same weights
on both sides (drawn from a numpy seed, bridged into the port), over the
synthetic test split; then the predict / evaluate / predict_demo entry
points and the per-batch soft-fail.

Both sides run the ACM with its steps cut from 500 to ACM_STEPS by the same
config override (`experiment.polygonization.acm_method.steps`): the full 500
are held to JAX's in tests/test_torch_ffl_polygonize.py, and 50 keep this
file cheap while every stage still runs.

Tolerances and why:
- the maps: the two forwards agree to float32 rounding, so their float16
  roundings agree to one float16 step (2^-11 at [0.5, 1)) on at most 0.5 %
  of the values;
- the ACM on JAX's float16 maps against JAX's: the random crossfield is
  rough at the pixel scale, so a vertex whose rounded edge midpoint lies on
  a pixel boundary can read another pixel in one run than in the other and
  the runs part there (6.7e-3 px here): all within 0.05 px, the median
  within 1e-4 px, at most 5 % beyond 1e-3 px
  (tests/test_torch_ffl_polygonize.py); given JAX's ACM positions, the
  port's host stage gives JAX's polygons exactly;
- the files: the same keys, tiles and polygon counts; each package's
  evaluator gives the two files' IoU within 1e-3.
"""

import copy
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.data.loader import build_loader as jax_build_loader
from pixelspointspolygons_tpu.eval.evaluator import Evaluator as JaxEvaluator
from pixelspointspolygons_tpu.models.ffl import FFL as JaxFFL
from pixelspointspolygons_tpu.parallel import make_mesh, shard_batch
from pixelspointspolygons_tpu.predict import ffl_polygonize as jax_fp
from pixelspointspolygons_tpu.predict.predictor_ffl import FFLPredictor as JaxFFLPredictor
from pixelspointspolygons_torch.cli import evaluate as cli_evaluate
from pixelspointspolygons_torch.cli import predict as cli_predict
from pixelspointspolygons_torch.cli import predict_demo as cli_predict_demo
from pixelspointspolygons_torch.cli._common import compose_from_argv
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data.loader import to_device
from pixelspointspolygons_torch.eval.evaluator import Evaluator
from pixelspointspolygons_torch.models.ffl import FFL
from pixelspointspolygons_torch.models.ffl import model as ffl_model
from pixelspointspolygons_torch.models.vit import ViTCNNEncoder
from pixelspointspolygons_torch.predict import ffl_polygonize as fp
from pixelspointspolygons_torch.predict import predictor_ffl
from pixelspointspolygons_torch.predict.predictor_ffl import FFLPredictor
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_ffl import VIT, _random_variables, one_torch_thread  # noqa: F401 (an autouse fixture)

S, DIM, ACM_STEPS = 32, 32, 50
KEYS = {"acm.tol_1", "acm.tol_2", "acm.tol_3"}


def _overrides(root, extra=()):
    return [
        "experiment=ffl_image",
        "dataset=synthetic",
        "run_type=debug",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.num_train=2",
        "experiment.dataset.num_val=2",
        "experiment.dataset.num_test=4",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "experiment.model.batch_size=2",
        f"experiment.encoder.in_size={S}",
        f"experiment.model.decoder.in_feature_dim={DIM}",
        f"experiment.polygonization.acm_method.steps={ACM_STEPS}",
        "evaluation=test",
        "evaluation.modes=[iou]",
        "checkpoint=latest",
        *extra,
    ]


def _tiny_port_model() -> FFL:
    return FFL(ViTCNNEncoder(out_size=S, out_dim=DIM, **VIT), dim=DIM, seg_channels=1, out_size=S)


def _write_latest(cfg, sd) -> None:
    os.makedirs(os.path.join(cfg.output_dir, "checkpoints"), exist_ok=True)
    torch.save({"model": sd, "epoch": 0, "cfg": cfg.to_dict()}, os.path.join(cfg.output_dir, "checkpoints", "latest.pt"))


@pytest.fixture(scope="module")
def ffl_setup(tmp_path_factory):
    """JAX's predictor (tiny FFL, one CPU device) and the port's, with the
    same weights: drawn from a numpy seed, with the seg head's last kernel
    scaled so that about a tenth of the pixels are buildings, in 2-3
    components per tile."""
    root = tmp_path_factory.mktemp("torch_predict_ffl")
    jcfg = jax_compose(_overrides(root))
    batches = list(jax_build_loader(jcfg, "test", eval_mode=True))
    assert len(batches) == 2
    jm = JaxFFL(encoder_cfg={"name": "vit_cnn", **VIT, "out_size": S}, dim=DIM, seg_channels=1, out_size=S)
    variables = _random_variables(jm, {"images": jnp.asarray(batches[0]["images"])}, 2)
    variables["params"]["seg_out"]["kernel"] = variables["params"]["seg_out"]["kernel"] * 6.0

    jp = JaxFFLPredictor(jcfg)
    jp.model, jp.mesh = jm, make_mesh(1)  # read when `_forward` is first traced
    jp.load_checkpoint = lambda: copy.deepcopy(variables)

    cfg = compose(_overrides(root))
    _write_latest(cfg, flax_to_state_dict(variables["params"], variables["batch_stats"]))
    port = FFLPredictor(cfg, device="cpu", model=_tiny_port_model())
    port.load_checkpoint()
    return {"root": root, "jcfg": jcfg, "cfg": cfg, "batches": batches, "variables": variables, "jp": jp, "port": port}


def test_predictor_matches_jax(ffl_setup, monkeypatch):
    """The forward's float16 maps; the ACM on JAX's maps (the host copy and
    the float16 tensors, as the forward hands them over) against JAX's
    `acm_optimize`; and, given JAX's ACM positions, the host stage's
    polygons against JAX's polygonizer."""
    jp, port, variables = ffl_setup["jp"], ffl_setup["port"], ffl_setup["variables"]
    acm_runs = []

    def jax_acm(pos, vmask, next_idx, point_batch, indicator, c0c2, pinned, **kw):
        args = (pos, vmask, next_idx.int(), point_batch.int(), indicator, c0c2, pinned)
        want = np.asarray(jax_fp.acm_optimize(*(jnp.asarray(a.numpy()) for a in args), **kw))
        got = port_acm(pos, vmask, next_idx, point_batch, indicator, c0c2, pinned, **kw).numpy()
        acm_runs.append((np.abs(got - want)[vmask.numpy()].max(1), kw["steps"]))
        return torch.from_numpy(want)

    port_acm = fp.acm_optimize
    monkeypatch.setattr(fp, "acm_optimize", jax_acm)
    n_polys = 0
    for batch in ffl_setup["batches"]:
        jout = jp._forward(variables, shard_batch({"images": batch["images"]}, jp.mesh))
        j_seg, j_cf = np.asarray(jout["seg"]), np.asarray(jout["crossfield"])
        pout = port.forward(to_device(batch, port.device, predictor_ffl.INPUT_KEYS))
        p_seg, p_cf = pout["seg"].numpy(), pout["crossfield"].numpy()
        assert p_seg.dtype == j_seg.dtype == p_cf.dtype == np.float16
        for p, j in ((p_seg, j_seg), (p_cf, j_cf)):
            d = np.abs(p.astype(np.float32) - j.astype(np.float32))
            assert d.max() <= 2.0**-10 and (d > 0).mean() <= 5e-3
        assert 0.05 < (p_seg > 0.5).mean() < 0.3

        want = jp.polygonizer(j_seg.astype(np.float32), j_cf.astype(np.float32))
        maps = (torch.from_numpy(j_seg), torch.from_numpy(j_cf))
        got = port._host_stage((j_seg.astype(np.float32), j_cf.astype(np.float32), maps), batch)
        assert port.polygonizer.stats["acm_steps"] == ACM_STEPS and port.polygonizer.stats["rings"] > 0
        assert set(got) == set(want) == {"acm"} and set(got["acm"]) == {"tol_1", "tol_2", "tol_3"}
        for tol in want["acm"]:
            for g, w in zip(got["acm"][tol], want["acm"][tol]):
                assert [len(p) for p in g] == [len(p) for p in w], tol
                for a, c in zip(g, w):
                    np.testing.assert_array_equal(a, c)
                n_polys += len(w)
    assert n_polys >= 6 and len(acm_runs) == 2
    d = np.concatenate([r[0] for r in acm_runs])
    assert all(r[1] == ACM_STEPS for r in acm_runs)
    assert d.max() <= 0.05 and np.median(d) <= 1e-4 and (d > 1e-3).mean() <= 0.05


def test_predict_dataset_files_match_jax(ffl_setup, tmp_path):
    """Both packages' `predict_dataset` over the split, each file through
    its package's evaluator."""
    jp, port = ffl_setup["jp"], ffl_setup["port"]
    cfg, jcfg = copy.deepcopy(ffl_setup["cfg"]), copy.deepcopy(ffl_setup["jcfg"])
    cfg.evaluation.pred_file = str(tmp_path / "port.json")
    jcfg.evaluation.pred_file = str(tmp_path / "jax.json")
    port.cfg, jp.cfg = cfg, jcfg
    try:
        pred_file, jax_file = port.predict_dataset("test"), jp.predict_dataset("test")
    finally:
        port.cfg, jp.cfg = ffl_setup["cfg"], ffl_setup["jcfg"]
    assert port.failed_batches == 0 and len(port.batch_times) == 2
    assert all(t["device_ms"] is None and t["acm_steps"] == ACM_STEPS and t["bucket"] == 4096
               and t["dropped"] == 0 for t in port.batch_times)

    def load(path):
        with open(path) as f:
            return json.load(f)

    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"{n}.json" for n in ("port", "jax", "port_time", "jax_time")]
        + [f"{n}_{k}.json" for n in ("port", "jax") for k in KEYS])
    assert load(pred_file) == load(pred_file.replace(".json", "_acm.tol_1.json"))
    assert load(pred_file.replace(".json", "_time.json"))["num_images"] == 4
    for key in KEYS:
        got, want = load(pred_file.replace(".json", f"_{key}.json")), load(jax_file.replace(".json", f"_{key}.json"))
        assert len(got) == len(want) > 0
        assert sorted(a["image_id"] for a in got) == sorted(a["image_id"] for a in want)

    def run(evaluator, path):
        evaluator.load_gt()
        evaluator.load_predictions(path)
        return evaluator.evaluate()

    got, want = run(Evaluator(cfg), pred_file), run(JaxEvaluator(jcfg), jax_file)
    assert got["IoU"] == pytest.approx(want["IoU"], abs=1e-3) and 0.0 < got["IoU"] < 1.0


def test_a_failed_batch_is_logged_counted_and_skipped(ffl_setup, tmp_path, monkeypatch):
    port = ffl_setup["port"]
    cfg = copy.deepcopy(ffl_setup["cfg"])
    cfg.evaluation.pred_file = str(tmp_path / "port.json")
    calls = []
    polygonize = port.polygonizer.__class__.__call__

    def flaky(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("polygonization fault")
        return polygonize(self, *args, **kwargs)

    monkeypatch.setattr(port.polygonizer.__class__, "__call__", flaky)
    port.cfg = cfg
    try:
        pred_file = port.predict_dataset("test")
    finally:
        port.cfg = ffl_setup["cfg"]
    assert port.failed_batches == 1 and len(port.batch_times) == 1
    with open(pred_file.replace(".json", "_time.json")) as f:
        assert json.load(f)["num_images"] == 2
    with open(pred_file) as f:
        assert {a["image_id"] for a in json.load(f)} <= set(ffl_setup["batches"][1]["image_id"].tolist())


# --- entry points ----------------------------------------------------------


@pytest.fixture()
def tiny_vit_cnn(monkeypatch):
    """The config tree sizes the ViT only by `in_size`; shrink it."""
    full = ffl_model.encoder_config
    monkeypatch.setattr(ffl_model, "encoder_config", lambda cfg: {**full(cfg), "dim": VIT["dim"], "depth": 1,
                                                                  "num_heads": VIT["num_heads"]})


def test_cli_predict_evaluate_and_demo_on_cpu(ffl_setup, tiny_vit_cnn, tmp_path, monkeypatch, capsys):
    """The three entry points on `experiment=ffl_image` with `device=cpu`,
    from the fixture's weights written as `latest`; the demo also through
    the sliding-window inference (a 64 px image in 32 px patches)."""
    monkeypatch.chdir(tmp_path)
    args = _overrides(ffl_setup["root"], ["device=cpu", f"host.model_root={tmp_path}/out",
                                          "evaluation.modes=[iou,coco,polis,stats]"])
    cfg, device = compose_from_argv(args)
    assert device == "cpu"
    variables = ffl_setup["variables"]
    _write_latest(cfg, flax_to_state_dict(variables["params"], variables["batch_stats"]))
    results = cli_predict.main(args)
    assert {"IoU", "C-IoU", "AP", "polis", "prediction_time"} <= set(results)
    assert results["num_images"] == 4 and 0.0 <= results["IoU"] <= 1.0
    for key in KEYS:
        assert os.path.isfile(cfg.evaluation.pred_file.replace(".json", f"_{key}.json"))
    again = cli_evaluate.main(args)
    assert json.dumps(again, sort_keys=True) == json.dumps(results, sort_keys=True)
    assert "'IoU'" in capsys.readouterr().out

    test_dir = os.path.join(cfg.experiment.dataset.in_path, "images", "test")
    image = os.path.join(test_dir, sorted(os.listdir(test_dir))[0])
    polys, out_file = cli_predict_demo.main(args + [f"+image_file={image}"])
    assert out_file == "prediction_ffl_image.png" and isinstance(polys, list)
    assert cv2.imread(str(tmp_path / out_file)) is not None

    big = tmp_path / "big.png"
    cv2.imwrite(str(big), cv2.resize(cv2.imread(image), (2 * S, 2 * S)))
    calls = []
    forward = FFLPredictor.forward
    monkeypatch.setattr(FFLPredictor, "forward", lambda self, inputs: calls.append(inputs["images"].shape)
                        or forward(self, inputs))
    polys, _ = cli_predict_demo.main(args + [f"+image_file={big}", f"experiment.model.eval.patch_size={S}",
                                             "experiment.model.eval.patch_overlap=8"])
    assert calls and all(shape == (1, S, S, 3) for shape in calls) and len(calls) == 9
    assert all(np.asarray(p).max() <= 2 * S for p in polys)


@pytest.mark.parametrize("entry", [cli_predict, cli_evaluate, cli_predict_demo])
def test_cli_needs_a_card_unless_asked_for_the_cpu(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main(_overrides(tmp_path))
