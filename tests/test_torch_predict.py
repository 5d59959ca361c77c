"""The port's HiSup prediction against the JAX package's, on the CPU:
junction extraction, host polygonization, the predictor as a whole (tiny
HRNet with bridged weights) and its one-batch-in-flight order, and the
predict / evaluate / predict_demo entry points.

Tolerances and why:
- junction extraction on identical maps: indices identical (NMS is an exact
  max, the selection a stable sort, as `lax.top_k` orders ties), points
  within 1e-6 (the same float32 additions), scores identical;
- polygonization: identical numpy/cv2 code, so rings and scores identical;
- the predictor as a whole: the models agree to float32 rounding, so the
  float16 remask agrees to one float16 step (2^-11 at [0.5, 1)) on at most
  0.1 % of pixels; the same junction candidates (as sets: two with scores
  equal to rounding may swap places) within 1e-5 px, their scores within
  1e-6; where a
  sample's two float16 remasks are equal, its polygons are equal to 1e-5 px
  (the junctions they snap to) and its polygon scores identical.
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
from pixelspointspolygons_tpu.models.hisup.model import HiSup as JaxHiSup
from pixelspointspolygons_tpu.models.hisup.model import extract_junctions as jax_extract_junctions
from pixelspointspolygons_tpu.parallel import make_mesh, shard_batch
from pixelspointspolygons_tpu.predict import ffl_polygonize as jax_ffl
from pixelspointspolygons_tpu.predict import hisup_polygon as jax_poly
from pixelspointspolygons_tpu.predict.predictor_hisup import HiSupPredictor as JaxHiSupPredictor
from pixelspointspolygons_tpu.utils.coco import generate_coco_ann as jax_generate_coco_ann
from pixelspointspolygons_tpu.utils.coco import save_annotations as jax_save_annotations
from pixelspointspolygons_torch.cli._common import compose_from_argv
from pixelspointspolygons_torch.cli import evaluate as cli_evaluate
from pixelspointspolygons_torch.cli import predict as cli_predict
from pixelspointspolygons_torch.cli import predict_demo as cli_predict_demo
from pixelspointspolygons_torch.cli import train as cli_train
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.eval.evaluator import Evaluator
from pixelspointspolygons_torch.models.hisup import factory
from pixelspointspolygons_torch.models.hisup.model import HiSup, extract_junctions, nms_2d
from pixelspointspolygons_torch.models.hrnet import HRNetEncoder
from pixelspointspolygons_torch.predict import ffl_polygonize as port_ffl
from pixelspointspolygons_torch.predict import hisup_polygon as port_poly
from pixelspointspolygons_torch.predict import predictor_hisup
from pixelspointspolygons_torch.predict.predictor_hisup import HiSupPredictor
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict

TOPO = dict(width=4, stage1_planes=4, stage1_blocks=1, num_blocks=1, num_modules=(1, 1, 1), stem_ch=8)
S, DIM = 64, 16


# --- junction extraction ---------------------------------------------------


def _jloc_maps(kind: str, rng, B=2, H=96, W=96):
    """(B, 3, H, W) softmax maps. 'plateaus' rounds them to 1/64, so NMS
    leaves runs of equal scores and the selection meets ties."""
    p = torch.softmax(torch.from_numpy(rng.normal(size=(B, 3, H, W)).astype(np.float32) * 2), dim=1).numpy()
    if kind == "plateaus":
        p = np.round(p * 64) / 64
    return p.astype(np.float32)


@pytest.mark.parametrize(
    "kind,shape,topk,th",
    [
        ("random", (96, 96), 300, 0.008),
        ("plateaus", (96, 96), 300, 0.008),
        ("plateaus", (224, 224), 300, 0.008),
        ("random", (40, 40), 300, 0.45),  # the threshold zeroes part of the list
        ("plateaus", (12, 12), 300, 0.008),  # topk > H·W: clamped to H·W
    ],
)
def test_extract_junctions_matches_jax(kind, shape, topk, th):
    rng = np.random.RandomState(sum(shape) + topk)
    jloc = _jloc_maps(kind, rng, H=shape[0], W=shape[1])
    n = min(topk, shape[0] * shape[1])
    if kind == "plateaus":  # NMS leaves ties among the selected nonzero scores
        flat = nms_2d(torch.from_numpy(jloc[:, 1])).reshape(2, -1).numpy()
        top = np.sort(flat, 1)[:, -n:]
        top = top[top > 0]
        assert len(np.unique(top)) < len(top)
    # with zero offsets a point is its pixel's centre: equal points are equal indices
    zero = np.zeros((2, 2) + shape, np.float32)
    want_p, want_s = jax_extract_junctions(jnp.asarray(jloc), jnp.asarray(zero), topk=topk, th=th)
    got_p, got_s = extract_junctions(torch.from_numpy(jloc), torch.from_numpy(zero), topk=topk, th=th)
    assert got_p.shape == (2, 2 * n, 2) and got_s.shape == (2, 2 * n)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if th > 0.3:
        assert 0 < int((got_s == 0).sum()) < got_s.numel()

    joff = rng.uniform(-0.5, 0.5, (2, 2) + shape).astype(np.float32)
    want_p, _ = jax_extract_junctions(jnp.asarray(jloc), jnp.asarray(joff), topk=topk, th=th)
    got_p, _ = extract_junctions(torch.from_numpy(jloc), torch.from_numpy(joff), topk=topk, th=th)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-6)


# --- host polygonization ---------------------------------------------------


def _random_blob_mask(seed, H=96, W=96, n_blobs=6):
    """tests/test_hisup.py::TestPolygonizationMirrorIdentity's masks."""
    rng = np.random.RandomState(seed)
    m = np.zeros((H, W), np.float32)
    for _ in range(n_blobs):
        x, y = rng.randint(5, W - 20), rng.randint(5, H - 20)
        w, h = rng.randint(4, 18), rng.randint(4, 18)
        m[y : y + h, x : x + w] = rng.uniform(0.6, 1.0)
        if rng.rand() < 0.5:  # rotated blob → diagonal staircase edges
            c = ((x + w / 2), (y + h / 2))
            rot = cv2.getRotationMatrix2D(c, rng.uniform(10, 80), 1.0)
            m = cv2.warpAffine(m, rot, (W, H))
    if rng.rand() < 0.5:  # punch holes
        m[H // 3 : H // 3 + rng.randint(8, 12), W // 3 : W // 3 + rng.randint(8, 12)] = 0.0
    return m


def _junctions(kind, mask, seed):
    rng = np.random.RandomState(1000 + seed)
    if kind == "random":
        return rng.uniform(0, 96, size=(30, 2))
    # near the traced vertices, so that most boundaries snap
    polys, _ = jax_poly.polygons_from_masks(mask, np.zeros((0, 2)))
    pts = np.concatenate(polys) if polys else np.zeros((0, 2))
    return pts + rng.uniform(-0.4, 0.4, pts.shape)


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("junctions", ["random", "vertices"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_polygons_from_masks_match_jax(seed, junctions, mirror):
    mask = _random_blob_mask(seed)
    juncs = _junctions(junctions, mask, seed)
    want_p, want_s = jax_poly.polygons_from_masks(mask, juncs, reference_mirror=mirror)
    got_p, got_s = port_poly.polygons_from_masks(mask, juncs, reference_mirror=mirror)
    assert len(want_p) > 0 and len(got_p) == len(want_p)
    assert got_s == want_s
    for a, b in zip(got_p, want_p):
        np.testing.assert_array_equal(a, b)
    if junctions == "vertices":  # snapping ran: some ring is made of junctions
        assert any((np.abs(p[:, None] - juncs[None]).sum(-1) < 1e-12).any(1).all() for p in got_p)


def test_douglas_peucker_and_diagonal_to_square_match_jax():
    rng = np.random.RandomState(5)
    for n, tol in [(2, 1.0), (3, 0.5), (50, 1.0), (200, 0.25), (200, 3.0)]:
        pts = np.cumsum(rng.normal(size=(n, 2)), axis=0)
        pts[-1] = pts[0] if n > 3 else pts[-1]  # closed rings too
        np.testing.assert_array_equal(port_ffl.douglas_peucker(pts, tol), jax_ffl.douglas_peucker(pts, tol))
    ring = np.array([[5, 5], [6, 6], [7, 6], [8, 5], [8, 4], [7, 3], [6, 3], [5, 4], [5, 5]], np.int64)
    for poly in [ring] + [
        np.concatenate([w, w[:1]]) for w in (np.cumsum(rng.randint(-1, 2, (40, 2)), axis=0) for _ in range(5))
    ]:
        want = jax_poly.diagonal_to_square(poly)
        np.testing.assert_array_equal(port_poly.diagonal_to_square(poly), want)
        np.testing.assert_array_equal(port_poly.diagonal_to_square_loop(poly), want)


# --- the predictor as a whole ----------------------------------------------


def _overrides(root, extra=()):
    return [
        "experiment=hisup_image",
        "dataset=synthetic",
        "run_type=debug",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.num_train=2",
        "experiment.dataset.num_val=4",
        "experiment.dataset.num_test=2",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "experiment.model.batch_size=2",
        f"experiment.encoder.in_size={S}",
        f"experiment.model.decoder.in_feature_size={S}",
        f"experiment.model.decoder.in_feature_dim={DIM}",
        "evaluation.modes=[iou]",
        *extra,
    ]


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """JAX's predictor (tiny HRNet, one CPU device) and the port's, with the
    same weights. At flax's init the remask head gives about 0.5 everywhere;
    its last BatchNorm is scaled and shifted so that a third of the pixels
    are buildings and the masks have a few components per tile."""
    root = tmp_path_factory.mktemp("torch_predict")
    jcfg = jax_compose(_overrides(root))
    batches = list(jax_build_loader(jcfg, "val", eval_mode=True))
    assert len(batches) == 2
    jm = JaxHiSup(encoder_cfg={"name": "hrnet", "in_size": S, **TOPO}, dim=DIM, pred_size=S)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1), {"images": jnp.asarray(batches[0]["images"])}))
    variables = copy.deepcopy(variables)
    bn = variables["params"]["final_conv"]["BatchNorm_2"]
    bn["scale"] = np.asarray(bn["scale"]) * 30.0
    bn["bias"] = np.asarray(bn["bias"]) + np.array([-1.0, 0.0], np.float32)

    jp = JaxHiSupPredictor(jcfg)
    jp.model, jp.mesh = jm, make_mesh(1)  # read when `_forward` is first traced

    cfg = compose(_overrides(root))
    model = HiSup(HRNetEncoder(in_size=S, out_dim=DIM, **TOPO), dim=DIM, pred_size=S)
    sd = flax_to_state_dict(variables["params"], variables["batch_stats"])
    os.makedirs(os.path.join(cfg.output_dir, "checkpoints"), exist_ok=True)
    torch.save({"model": sd, "epoch": 0, "cfg": cfg.to_dict()}, os.path.join(cfg.output_dir, "checkpoints", "latest.pt"))
    port = HiSupPredictor(cfg, device="cpu", model=model)
    port.load_checkpoint()
    return {"root": root, "jcfg": jcfg, "cfg": cfg, "batches": batches, "variables": variables, "jp": jp, "port": port}


def _assert_same_candidates(p_juncs, p_scores, j_juncs, j_scores):
    """The same junction candidates per sample and class, each within
    1e-5 px and its score within 1e-6. Two candidates whose scores differ at
    float32 rounding may swap places between the two models, and the
    polygons do not depend on that order (snapping orders the junctions it
    keeps along the boundary), so the sets are compared."""
    B, n2, _ = p_juncs.shape
    for b in range(B):
        for half in (slice(0, n2 // 2), slice(n2 // 2, n2)):
            got = np.concatenate([p_juncs[b, half], p_scores[b, half, None]], 1)
            want = np.concatenate([j_juncs[b, half], j_scores[b, half, None]], 1)
            got, want = got[np.lexsort(got[:, :2].T)], want[np.lexsort(want[:, :2].T)]
            np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=1e-5)
            np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-6)


def test_predictor_matches_jax(slice_setup):
    jp, port = slice_setup["jp"], slice_setup["port"]
    variables = {k: slice_setup["variables"][k] for k in ("params", "batch_stats")}
    n_equal = n_polys = 0
    for batch in slice_setup["batches"]:
        handles = jp._forward(variables, shard_batch({"images": batch["images"]}, jp.mesh))
        want_polys, want_scores = jp._host_stage(handles)
        j_remask, j_juncs, j_scores = (np.asarray(h) for h in handles)
        inputs = predictor_hisup.to_device(batch, port.device, predictor_hisup._INPUT_KEYS)
        p_remask, p_juncs, p_scores = (t.numpy() for t in port.forward(inputs))
        assert p_remask.dtype == j_remask.dtype == np.float16

        d = np.abs(p_remask.astype(np.float32) - j_remask.astype(np.float32))
        assert d.max() <= 2.0**-11 and (d > 0).mean() <= 1e-3
        assert 0.2 < (p_remask > 0.5).mean() < 0.5
        _assert_same_candidates(p_juncs, p_scores, j_juncs, j_scores)

        got_polys, got_scores = port.predict_batch(batch)
        for b in range(len(got_polys)):
            if not np.array_equal(p_remask[b], j_remask[b]):
                continue
            n_equal += 1
            n_polys += len(got_polys[b])
            assert got_scores[b] == want_scores[b]
            assert len(got_polys[b]) == len(want_polys[b])
            for a, w in zip(got_polys[b], want_polys[b]):
                np.testing.assert_allclose(a, w, rtol=0, atol=1e-5)
    assert n_equal >= 2 and n_polys >= 4


def test_predicted_files_evaluate_as_jax(slice_setup, tmp_path):
    """The port's predict_dataset (checkpoint, loader, float16 images, one
    batch in flight) against JAX's forward and host stage over the val
    split, each file through its package's evaluator: IoU and C-IoU within
    1e-6 (the polygons agree to 1e-5 px, far inside a pixel)."""
    jp, port, cfg, jcfg = slice_setup["jp"], slice_setup["port"], slice_setup["cfg"], slice_setup["jcfg"]
    variables = {k: slice_setup["variables"][k] for k in ("params", "batch_stats")}
    anns = []
    for batch in slice_setup["batches"]:
        polys, scores = jp._host_stage(jp._forward(variables, shard_batch({"images": batch["images"]}, jp.mesh)))
        for b in range(len(polys)):
            anns.extend(jax_generate_coco_ann(polys[b], int(batch["image_id"][b]), scores[b]))
    jax_file = str(tmp_path / "jax.json")
    jax_save_annotations(anns, jax_file)

    cfg = copy.deepcopy(cfg)
    cfg.evaluation.pred_file = str(tmp_path / "port.json")
    port.cfg = cfg
    try:
        pred_file = port.predict_dataset("val")
    finally:
        port.cfg = slice_setup["cfg"]
    with open(pred_file) as f:
        port_anns = json.load(f)
    assert len(port_anns) == len(anns) > 0
    assert sorted({a["image_id"] for a in port_anns}) == sorted({a["image_id"] for a in anns})
    with open(pred_file.replace(".json", "_time.json")) as f:
        assert json.load(f)["num_images"] == 4
    assert [t["device_ms"] for t in port.batch_times] == [None, None]

    def run(evaluator, path):
        evaluator.load_gt()
        evaluator.load_predictions(path)
        return evaluator.evaluate()

    got, want = run(Evaluator(cfg), pred_file), run(JaxEvaluator(jcfg), jax_file)
    for k in ("IoU", "C-IoU", "NR"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert 0.0 < got["IoU"] < 1.0


def test_predict_dataset_keeps_one_batch_in_flight(tmp_path, monkeypatch):
    """Batch k+1 is dispatched before batch k's host stage runs, and the
    results stay in loader order (tests/test_hisup.py::TestPredictDoubleBuffering)."""
    cfg = compose(_overrides(tmp_path))
    cfg.evaluation.pred_file = str(tmp_path / "pred.json")
    model = HiSup(HRNetEncoder(in_size=32, out_dim=8, **TOPO), dim=8, pred_size=32)
    predictor = HiSupPredictor(cfg, device="cpu", model=model)
    events = []
    batches = [
        {"images": np.zeros((2, 32, 32, 3), np.float32),
         "sample_valid": np.array([True, True]),
         "image_id": np.array([2 * k, 2 * k + 1])}
        for k in range(3)
    ]
    ring = np.array([[1.0, 1.0], [5.0, 1.0], [5.0, 5.0], [1.0, 5.0]])

    def fake_dispatch(inputs):
        assert inputs["images"].dtype == torch.float32  # sent as float16, widened on the device
        k = len([e for e in events if e[0] == "dispatch"])
        events.append(("dispatch", k))
        return k, None  # (outputs, no CUDA events)

    def fake_host_stage(k):
        events.append(("consume", k))
        return [[ring], [ring]], [[0.9], [0.9]]

    monkeypatch.setattr(predictor, "load_checkpoint", lambda: {})
    monkeypatch.setattr(predictor_hisup, "build_loader", lambda cfg, split, eval_mode=True: iter(batches))
    monkeypatch.setattr(predictor, "_dispatch", fake_dispatch)
    monkeypatch.setattr(predictor, "_fetch", lambda handles: handles[0])
    monkeypatch.setattr(predictor, "_host_stage", fake_host_stage)

    pred_file = predictor.predict_dataset("val")

    assert events == [
        ("dispatch", 0),
        ("dispatch", 1),
        ("consume", 0),
        ("dispatch", 2),
        ("consume", 1),
        ("consume", 2),
    ]
    with open(pred_file) as f:
        anns = json.load(f)
    assert [a["image_id"] for a in anns] == [0, 1, 2, 3, 4, 5]
    assert len(predictor.batch_times) == 3


# --- entry points ----------------------------------------------------------


@pytest.fixture()
def tiny_hrnet(monkeypatch):
    """The config tree sizes HRNet only by `in_size`; shrink its widths."""
    full = factory.encoder_config
    monkeypatch.setattr(factory, "encoder_config", lambda cfg: {**full(cfg), **TOPO})


def test_cli_predict_evaluate_and_demo_on_cpu(tiny_hrnet, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    common = _overrides(tmp_path, ["experiment.model.num_epochs=1", "training.save_every=0", "device=cpu"])
    cli_train.main(common)
    args = common + ["evaluation=test", "checkpoint=latest", "evaluation.modes=[iou,coco,polis,mta,stats]"]
    results = cli_predict.main(args)
    assert {"IoU", "C-IoU", "NR", "AP", "polis", "mta", "num_gt_anns", "prediction_time"} <= set(results)
    assert results["num_images"] == 2 and 0.0 <= results["IoU"] <= 1.0
    cfg, device = compose_from_argv(args)
    assert device == "cpu" and os.path.isfile(cfg.evaluation.pred_file)
    csv_file = os.path.join(cfg.output_dir, f"{cfg.evaluation.eval_file}_test.csv")
    with open(csv_file) as f:
        assert f.readline().startswith("experiment,IoU,C-IoU,NR,AP,")
    again = cli_evaluate.main(args)  # the same file again (NaN-aware comparison)
    assert json.dumps(again, sort_keys=True) == json.dumps(results, sort_keys=True)
    assert "'IoU'" in capsys.readouterr().out

    image = sorted(os.listdir(os.path.join(cfg.experiment.dataset.in_path, "images", "test")))[0]
    image = os.path.join(cfg.experiment.dataset.in_path, "images", "test", image)
    polys, out_file = cli_predict_demo.main(common + ["checkpoint=latest", f"+image_file={image}"])
    assert out_file == "prediction_hisup_image.png" and isinstance(polys, list)
    png = cv2.imread(str(tmp_path / out_file))
    assert png is not None and png.shape[0] >= 64 * 14


@pytest.mark.parametrize("entry", [cli_predict, cli_predict_demo])
@pytest.mark.parametrize("experiment,item", [("ffl_image", "FFL")])
def test_cli_other_models_not_ported(entry, experiment, item, tmp_path, monkeypatch):
    """FFL at bfloat16, which once raised here naming ROADMAP item 'FFL',
    predicts through each entry on the CPU from a tiny model's `latest`
    (float32 in tests/test_torch_predict_ffl.py; bfloat16 against flax in
    tests/test_torch_ffl_bf16.py)."""
    from pixelspointspolygons_torch.models.ffl import build_ffl
    from pixelspointspolygons_torch.models.ffl import model as ffl_model
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler
    from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager
    from test_torch_train_ffl import overrides as ffl_overrides

    full = ffl_model.encoder_config
    monkeypatch.setattr(ffl_model, "encoder_config", lambda cfg: {**full(cfg), "depth": 1, "num_heads": 2})
    monkeypatch.chdir(tmp_path)
    args = ffl_overrides(tmp_path, ["host.compute_dtype=bfloat16", "evaluation=test", "evaluation.modes=[iou]",
                                    "checkpoint=latest"])
    cfg = compose(args)
    assert cfg.experiment.name == experiment
    model = build_ffl(cfg, generator=torch.Generator().manual_seed(0))
    opt = make_optimizer("adam", model.parameters(), 1e-4)
    CheckpointManager(cfg.output_dir).save("latest", TrainState(model, opt, make_scheduler(opt, lambda n: 1e-4, 1e-4)),
                                           0, cfg)
    if entry is cli_predict:
        results = entry.main(args + ["device=cpu"])
        assert 0.0 <= results["IoU"] <= 1.0
        return
    from pixelspointspolygons_torch.data import ensure_synthetic_dataset

    ensure_synthetic_dataset(cfg)
    test_dir = os.path.join(cfg.experiment.dataset.in_path, "images", "test")
    image = os.path.join(test_dir, sorted(os.listdir(test_dir))[0])
    polys, out_file = entry.main(args + ["device=cpu", f"+image_file={image}"])
    assert out_file == f"prediction_{item.lower()}_image.png" and os.path.isfile(tmp_path / out_file)


@pytest.mark.parametrize("entry", [cli_predict, cli_evaluate, cli_predict_demo])
def test_cli_needs_a_card_unless_asked_for_the_cpu(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main(_overrides(tmp_path, ["evaluation=test", "checkpoint=latest"]))
