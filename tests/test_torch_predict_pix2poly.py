"""The port's Pix2Poly prediction against the JAX package's, on the CPU:
Hungarian assignment and successor-chain assembly, the predictor as a whole
(a tiny Pix2Poly with bridged weights on a small synthetic split) and its
one-batch-in-flight order, and the predict / evaluate / predict_demo entry
points for `experiment=p2p_image`.

Tolerances and why: the host code is the same numpy and scipy code on the
same arrays, so permutations, chains and polygons are identical. The two
models agree to float32 rounding (tests/test_torch_pix2poly.py), so their
greedy tokens are identical and their raw scores agree to 1e-4; Hungarian
on scores that close picks the same assignment unless two assignments tie
to 1e-4, which these seeded inputs do not. So the COCO json files are
identical.
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
from pixelspointspolygons_tpu.models.pix2poly import Pix2Poly as JaxPix2Poly
from pixelspointspolygons_tpu.parallel import make_mesh
from pixelspointspolygons_tpu.predict import predictor_pix2poly as jax_pp
from pixelspointspolygons_tpu.utils.coco import generate_coco_ann as jax_generate_coco_ann
from pixelspointspolygons_torch.cli import evaluate as cli_evaluate
from pixelspointspolygons_torch.cli import predict as cli_predict
from pixelspointspolygons_torch.cli import predict_demo as cli_predict_demo
from pixelspointspolygons_torch.cli._common import compose_from_argv
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.models.layers import init_flax_defaults
from pixelspointspolygons_torch.models.pix2poly import Pix2Poly, factory
from pixelspointspolygons_torch.predict import predictor_pix2poly as port_pp
from pixelspointspolygons_torch.predict.predictor_pix2poly import Pix2PolyPredictor
from pixelspointspolygons_torch.train.state import TrainState, linear_warmup_decay, make_optimizer, make_scheduler
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager

S, DIM, NV = 32, 32, 12  # tile size (= token bins), widths, vertex slots
VOCAB, BOS, EOS, PAD = S + 3, S, S + 1, S + 2
MAX_LEN = 2 * NV + 2
ENC = {"name": "vit", "img_size": S, "patch_size": 8, "dim": DIM, "depth": 1, "num_heads": 2}
MODEL = dict(vocab_size=VOCAB, encoder_len=(S // 8) ** 2, dim=DIM, num_heads=4, num_layers=2, max_len=MAX_LEN,
             pad_idx=PAD, max_num_vertices=NV, sinkhorn_iterations=10)


def _overrides(root, extra=()):
    return [
        "experiment=p2p_image",
        "dataset=synthetic",
        "run_type=debug",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.num_train=2",
        "experiment.dataset.num_val=5",
        "experiment.dataset.num_test=2",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "experiment.model.batch_size=2",
        f"experiment.encoder.in_size={S}",
        f"experiment.encoder.patch_feature_dim={DIM}",
        f"experiment.model.decoder.in_feature_dim={DIM}",
        "experiment.model.decoder.num_layers=2",
        "experiment.model.decoder.num_heads=4",
        f"experiment.model.tokenizer.max_num_vertices={NV}",
        "experiment.model.sinkhorn_iterations=10",
        "evaluation.modes=[iou]",
        *extra,
    ]


# --- host assembly -----------------------------------------------------------


def test_scores_to_permutations_matches_jax():
    scores = np.random.RandomState(0).normal(size=(3, 7, 7)).astype(np.float32)
    got = port_pp.scores_to_permutations(scores.copy())
    np.testing.assert_array_equal(got, jax_pp.scores_to_permutations(scores.copy()))
    np.testing.assert_array_equal(got.sum(1), 1.0)
    np.testing.assert_array_equal(got.sum(2), 1.0)


CHAINS = [
    [[0, 1], [1, 2], [2, 0]],  # one ring
    [[3, 4], [0, 1], [4, 0], [1, 3]],  # a ring found out of order
    [[0, 1], [2, 3], [1, 2], [5, 6], [3, 0], [6, 5], [4, 4]],  # two rings and a self-link
    [[0, 1], [1, 2], [2, 3]],  # an open chain
]


@pytest.mark.parametrize("chains", CHAINS)
def test_bubble_merge_matches_jax(chains):
    got = port_pp._bubble_merge(copy.deepcopy(chains))
    assert got == jax_pp._bubble_merge(copy.deepcopy(chains))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permutations_to_polygons_matches_jax(seed):
    """Random permutations with self-linked padding rows, and the crafted
    chains as permutation matrices."""
    rng = np.random.RandomState(seed)
    B, N = 3, 10
    perm = np.zeros((B, N, N), np.float32)
    for b in range(B):
        n = rng.randint(0, N + 1)
        perm[b, np.arange(n), rng.permutation(n)] = 1
        perm[b, range(n, N), range(n, N)] = 1
    crafted = np.zeros((1, N, N), np.float32)
    for i, j in [pair for pair in CHAINS[2] if pair[0] != pair[1]]:
        crafted[0, i, j] = 1
    crafted[0, range(7, N), range(7, N)] = 1
    crafted[0, 4, 4] = 1
    vertices = rng.uniform(0, 224, (B + 1, N, 2)).astype(np.float32)
    perm = np.concatenate([perm, crafted])
    got = port_pp.permutations_to_polygons(perm, vertices)
    want = jax_pp.permutations_to_polygons(perm, vertices)
    assert [len(p) for p in got] == [len(p) for p in want]
    assert len(got[-1]) == 1  # the 4-ring; the 2-ring 5 <-> 6 is no polygon
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g, w)


# --- the predictor as a whole ----------------------------------------------


def _weights(variables, seed=6, eos_bias=1.0):
    """Unit-scale embeddings and an EOS bias (tests/test_torch_pix2poly.py::_vary),
    so the tokens vary and rows stop at different steps."""
    v = copy.deepcopy(jax.device_get(variables))
    r = np.random.RandomState(seed)
    dec = v["params"]["decoder"]
    for k in ("decoder_pos_embed", "encoder_pos_embed"):
        dec[k] = r.normal(size=dec[k].shape).astype(np.float32)
    dec["embedding"]["embedding"] = r.normal(size=dec["embedding"]["embedding"].shape).astype(np.float32)
    bias = np.zeros(VOCAB, np.float32)
    bias[EOS] = eos_bias
    dec["output"]["bias"] = bias
    return v


def _jax_predictor(jcfg, jm):
    jp = jax_pp.Pix2PolyPredictor(jcfg)
    jp.model, jp.mesh = jm, make_mesh(1)  # read when `_gen` is first traced
    return jp


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """JAX's predictor and the port's (one CPU device each) with the same
    tiny Pix2Poly weights; the port's read from a `latest` checkpoint."""
    root = tmp_path_factory.mktemp("torch_predict_p2p")
    jcfg = jax_compose(_overrides(root))
    jm = JaxPix2Poly(**MODEL, encoder_cfg=ENC)
    jp = _jax_predictor(jcfg, jm)
    batches = list(jax_build_loader(jcfg, "val", tokenizer=jp.tokenizer, eval_mode=True))
    assert len(batches) == 3 and batches[-1]["sample_valid"].tolist() == [True, False]
    init = jax.jit(jm.init)(jax.random.PRNGKey(1), {"images": jnp.asarray(batches[0]["images"])},
                            jnp.zeros((2, MAX_LEN - 1), jnp.int32))
    variables = _weights(init)

    cfg = compose(_overrides(root))
    sd = flax_to_state_dict(variables["params"], variables["batch_stats"])
    os.makedirs(os.path.join(cfg.output_dir, "checkpoints"), exist_ok=True)
    torch.save({"model": sd, "epoch": 0, "cfg": cfg.to_dict()}, os.path.join(cfg.output_dir, "checkpoints", "latest.pt"))
    port = Pix2PolyPredictor(cfg, device="cpu", model=Pix2Poly(**MODEL, encoder_cfg=ENC))
    port.load_checkpoint()
    return {"jcfg": jcfg, "cfg": cfg, "batches": batches, "variables": variables, "jp": jp, "port": port}


def test_predictor_matches_jax(slice_setup):
    """Per batch: identical tokens, raw scores within 1e-4, identical
    polygons, through the port's predict_batch (float16 images, decode with
    early exit, assembly)."""
    jp, port = slice_setup["jp"], slice_setup["port"]
    n_polys, stops = 0, set()
    for batch in slice_setup["batches"]:
        j_tokens, j_scores = (np.asarray(a) for a in jp.decode_async(slice_setup["variables"], batch))
        want_polys, _ = jp.assemble(j_tokens.copy(), j_scores.copy())
        inputs = port_pp.to_device(batch, port.device, port_pp._INPUT_KEYS)
        assert inputs["images"].dtype == torch.float32
        (tokens, scores), info = port.forward(inputs)
        np.testing.assert_array_equal(tokens.numpy(), j_tokens)
        np.testing.assert_allclose(scores.numpy(), j_scores, rtol=0, atol=1e-4)
        assert info["steps"] <= MAX_LEN - 1
        got_polys, got_tokens = port.predict_batch(batch)
        np.testing.assert_array_equal(got_tokens, j_tokens)
        assert [len(p) for p in got_polys] == [len(p) for p in want_polys]
        for gb, wb in zip(got_polys, want_polys):
            for g, w in zip(gb, wb):
                np.testing.assert_array_equal(g, w)
            n_polys += len(gb)
        stops |= {int(np.argmax(r == EOS)) if (r == EOS).any() else -1 for r in j_tokens}
    assert n_polys >= 3 and len(stops) >= 3  # polygons, and rows stopping at several steps


def test_predicted_file_matches_jax(slice_setup, tmp_path):
    """The port's predict_dataset (checkpoint, loader, one batch in flight,
    the padded last batch) writes the same COCO json as JAX's decode and
    assembly on the same tiles, and its timing file."""
    jp, port = slice_setup["jp"], slice_setup["port"]
    anns = []
    for batch in slice_setup["batches"]:
        polys, _ = jp.assemble(*(np.array(a) for a in jp.decode_async(slice_setup["variables"], batch)))
        for b, image_polys in enumerate(polys):
            if batch["sample_valid"][b]:
                anns.extend(jax_generate_coco_ann(image_polys, int(batch["image_id"][b])))
    cfg = copy.deepcopy(slice_setup["cfg"])
    cfg.evaluation.pred_file = str(tmp_path / "port.json")
    port.cfg = cfg
    try:
        pred_file = port.predict_dataset("val")
    finally:
        port.cfg = slice_setup["cfg"]
    with open(pred_file) as f:
        got = json.load(f)
    assert len(got) > 0 and got == json.loads(json.dumps(anns))
    with open(pred_file.replace(".json", "_time.json")) as f:
        assert json.load(f)["num_images"] == 5
    times = port.batch_times
    assert len(times) == 3 and all(t["device_ms"] is None and t["encoder_ms"] is None for t in times)
    assert all(1 <= t["steps"] <= MAX_LEN - 1 and t["host_ms"] >= 0 and t["decode_host_ms"] > 0 for t in times)


@pytest.mark.parametrize("eval_batch_size", [None, 3])
def test_predict_dataset_keeps_one_batch_in_flight(tmp_path, monkeypatch, eval_batch_size):
    """Batch k+1 is dispatched before batch k is assembled, the results stay
    in loader order, and `evaluation.batch_size` sizes the loader's batches
    (tests/test_hisup.py::TestPredictDoubleBuffering's order)."""
    cfg = compose(_overrides(tmp_path, [f"evaluation.batch_size={eval_batch_size or 'null'}"]))
    cfg.evaluation.pred_file = str(tmp_path / "pred.json")
    predictor = Pix2PolyPredictor(cfg, device="cpu", model=Pix2Poly(**MODEL, encoder_cfg=ENC))
    events, loader_args = [], {}
    batches = [
        {"images": np.zeros((2, S, S, 3), np.float32), "sample_valid": np.array([True, True]),
         "image_id": np.array([2 * k, 2 * k + 1])}
        for k in range(3)
    ]
    ring = np.array([[1.0, 1.0], [5.0, 1.0], [5.0, 5.0], [1.0, 5.0]])

    def fake_build_loader(cfg, split, tokenizer=None, eval_mode=False, batch_size=None):
        loader_args.update(tokenizer=tokenizer, eval_mode=eval_mode, batch_size=batch_size)
        return iter(batches)

    def fake_dispatch(inputs):
        assert inputs["images"].dtype == torch.float32  # sent as float16, widened on the device
        k = len([e for e in events if e[0] == "dispatch"])
        events.append(("dispatch", k))
        return k, {"steps": 1, "decode_host_ms": 0.0}, None

    def fake_assemble(k, _):
        events.append(("assemble", k))
        return [[ring], [ring]], None

    monkeypatch.setattr(predictor, "load_checkpoint", lambda: {})
    monkeypatch.setattr(port_pp, "build_loader", fake_build_loader)
    monkeypatch.setattr(predictor, "_dispatch", fake_dispatch)
    monkeypatch.setattr(predictor, "_fetch", lambda handles: (handles[0], None))
    monkeypatch.setattr(predictor, "assemble", fake_assemble)

    pred_file = predictor.predict_dataset("val")

    assert events == [("dispatch", 0), ("dispatch", 1), ("assemble", 0), ("dispatch", 2), ("assemble", 1),
                      ("assemble", 2)]
    assert loader_args == {"tokenizer": predictor.tokenizer, "eval_mode": True, "batch_size": eval_batch_size}
    with open(pred_file) as f:
        assert [a["image_id"] for a in json.load(f)] == [0, 1, 2, 3, 4, 5]
    assert len(predictor.batch_times) == 3


# --- entry points ----------------------------------------------------------


@pytest.fixture()
def tiny_vit(monkeypatch):
    """The config tree fixes the ViT's depth and heads; shrink them."""
    full = factory.encoder_config
    monkeypatch.setattr(factory, "encoder_config", lambda cfg: {**full(cfg), "depth": 1, "num_heads": 2})


def _write_latest(cfg) -> None:
    """A seeded random Pix2Poly as `latest`, in the trainer's format."""
    model = factory.build_pix2poly(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.decoder.decoder_pos_embed.normal_(generator=torch.Generator().manual_seed(1))
    opt = make_optimizer("adamw", model.parameters(), 3e-4)
    state = TrainState(model, opt, make_scheduler(opt, linear_warmup_decay(3e-4, 10), 3e-4))
    CheckpointManager(cfg.output_dir).save("latest", state, 0, cfg)


def test_cli_predict_evaluate_and_demo_on_cpu(tiny_vit, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    common = _overrides(tmp_path, ["device=cpu"])
    args = common + ["evaluation=test", "checkpoint=latest", "evaluation.modes=[iou,coco,polis,mta,stats]"]
    cfg, device = compose_from_argv(args)
    assert device == "cpu"
    _write_latest(cfg)
    results = cli_predict.main(args)
    assert {"IoU", "C-IoU", "NR", "AP", "polis", "mta", "num_gt_anns", "prediction_time"} <= set(results)
    assert results["num_images"] == 2 and 0.0 <= results["IoU"] <= 1.0
    assert os.path.isfile(cfg.evaluation.pred_file)
    again = cli_evaluate.main(args)  # the same file again (NaN-aware comparison)
    assert json.dumps(again, sort_keys=True) == json.dumps(results, sort_keys=True)
    assert "'IoU'" in capsys.readouterr().out

    image = sorted(os.listdir(os.path.join(cfg.experiment.dataset.in_path, "images", "test")))[0]
    image = os.path.join(cfg.experiment.dataset.in_path, "images", "test", image)
    polys, out_file = cli_predict_demo.main(common + ["checkpoint=latest", f"+image_file={image}"])
    assert out_file == "prediction_pix2poly_image.png" and isinstance(polys, list)
    png = cv2.imread(str(tmp_path / out_file))
    assert png is not None and png.shape[0] >= S * 28


@pytest.mark.parametrize("entry", [cli_predict, cli_evaluate, cli_predict_demo])
def test_cli_needs_a_card_unless_asked_for_the_cpu(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main(_overrides(tmp_path, ["evaluation=test", "checkpoint=latest"]))


def test_bfloat16_not_ported(tiny_vit, tmp_path):
    """FFL's predictor, which once refused bfloat16 naming ROADMAP item
    'FFL', builds its model at bfloat16 with float32 parameters and ships
    float16 maps (against flax: tests/test_torch_ffl_bf16.py; HiSup's:
    tests/test_torch_hisup_bf16.py); the Pix2Poly predictor builds its model
    at bfloat16 (float32 parameters) and predicts a batch from a float32
    checkpoint, its scores reaching the host as float32."""
    ffl = compose(["experiment=ffl_image", "dataset=synthetic", f"host.model_root={tmp_path}",
                   "host.compute_dtype=bfloat16", "experiment.encoder.in_size=16"])
    ffl_predictor = cli_predict.get_predictor(ffl, "cpu")
    assert ffl_predictor.model.compute_dtype == torch.bfloat16 and ffl_predictor.map_dtype == torch.float16
    assert all(p.dtype == torch.float32 for p in ffl_predictor.model.parameters())
    cfg = compose(_overrides(tmp_path, ["host.compute_dtype=bfloat16", "checkpoint=latest"]))
    _write_latest(cfg)
    predictor = cli_predict.get_predictor(cfg, "cpu")
    assert predictor.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in predictor.model.parameters())
    predictor.load_checkpoint()
    batch = {"images": np.random.RandomState(0).normal(size=(2, S, S, 3)).astype(np.float32)}
    (tokens, scores), info = predictor.forward(port_pp.to_device(batch, predictor.device, port_pp._INPUT_KEYS))
    assert scores.dtype == torch.bfloat16 and tokens.shape == (2, MAX_LEN - 1)
    polys, _ = predictor.predict_batch(batch)
    assert len(polys) == 2 and predictor._fetch(((tokens, scores), info, None))[1].dtype == np.float32


def test_predictor_builds_with_flax_init(tmp_path):
    """Without a model given, the predictor builds the config's model (the
    ViT at its configured depth) and takes the checkpoint's weights."""
    cfg = compose(_overrides(tmp_path))
    predictor = cli_predict.get_predictor(cfg, "cpu")
    assert isinstance(predictor, Pix2PolyPredictor) and predictor.device.type == "cpu"
    model = predictor.model
    assert hasattr(model.encoder.vit, "block11") and model.max_num_vertices == NV
    ref = Pix2Poly(**MODEL, encoder_cfg={**ENC, "depth": 12, "num_heads": 6})
    init_flax_defaults(ref, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in ref.state_dict().items()} == {k: v.shape for k, v in model.state_dict().items()}
