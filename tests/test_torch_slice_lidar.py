"""The LiDAR and fusion slice as a whole, against the JAX package on the CPU:
the loader's LiDAR items on the same seeds, the LiDAR files (.npz, .las,
.laz) through `load_lidar_file` and the port's own LASzip bindings,
tiny HiSup-LiDAR training (two train steps and a val step of the port's
steps against JAX's, from the same bridged weights, on batches that JAX's
loader built), a tiny Pix2Poly early-fusion prediction against JAX's
predictor, and, port only, every experiment built and run forward and
backward, and the entry points of a LiDAR experiment on the CPU.

Tolerances and why:
- loader items: the same numpy code on the same rng draws: equal;
- files: the same decoders on the same bytes: equal;
- the HiSup-LiDAR steps (tests/test_torch_slice.py's rules): losses 1e-5
  relative (float32 sums in another order; the PFN's and the heads'
  train-mode BatchNorms differ in how they take the variance, ROADMAP
  3.11); the two float32 gradients within 1e-3 of each other in relative
  L2 over all parameters; every parameter within 2·lr of JAX's after an
  update (AdamW moves an element whose gradient is at the rounding noise
  by lr·sign(noise)); BatchNorm statistics 5e-4 relative (+1e-5); the val
  step's losses 1e-4;
- the fusion prediction: the two models agree to float32 rounding, so the
  greedy tokens are identical and the raw scores agree to 1e-4
  (tests/test_torch_predict_pix2poly.py).
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.data import dataset as jax_dataset
from pixelspointspolygons_tpu.data.loader import build_loader as jax_build_loader
from pixelspointspolygons_tpu.models.hisup.model import HiSup as JaxHiSup
from pixelspointspolygons_tpu.models.pix2poly import Pix2Poly as JaxPix2Poly
from pixelspointspolygons_tpu.native import laz as jax_laz
from pixelspointspolygons_tpu.parallel import make_mesh, shard_batch
from pixelspointspolygons_tpu.train import hisup_step as jax_step
from pixelspointspolygons_tpu.train import state as jax_state
from pixelspointspolygons_torch import laz, native
from pixelspointspolygons_torch.cli import predict as cli_predict
from pixelspointspolygons_torch.cli import predict_demo as cli_predict_demo
from pixelspointspolygons_torch.cli import train as cli_train
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data import dataset
from pixelspointspolygons_torch.data.loader import build_loader, to_device
from pixelspointspolygons_torch.models.ffl import build_ffl
from pixelspointspolygons_torch.models.ffl import model as ffl_model
from pixelspointspolygons_torch.models.hisup import factory as hisup_factory
from pixelspointspolygons_torch.models.hisup.encoders import PointPillarsViTCNNEncoder
from pixelspointspolygons_torch.models.hisup.model import HiSup
from pixelspointspolygons_torch.models.pix2poly import Pix2Poly, Tokenizer, build_pix2poly
from pixelspointspolygons_torch.models.pix2poly import factory as p2p_factory
from pixelspointspolygons_torch.predict import predictor_pix2poly as port_pp
from pixelspointspolygons_torch.predict.predictor_pix2poly import Pix2PolyPredictor
from pixelspointspolygons_torch.train.hisup_step import make_train_step, make_val_step
from pixelspointspolygons_torch.train.state import TrainState, cosine_with_warmup, make_optimizer, make_scheduler
from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_ffl import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_predict_pix2poly import _jax_predictor, _weights
from test_torch_slice import _assert_params_close, _assert_stats_close, _rel_l2, _sync_port_to_jax
from test_torch_train_pix2poly import flax_init

S, DIM, NPTS, LR, WD, TOTAL_STEPS = 32, 16, 512, 1e-4, 1e-4, 10
CPU = torch.device("cpu")
VIT = dict(img_size=S, patch_size=8, dim=32, depth=1, num_heads=2)
PILLARS = dict(width=float(S), height=float(S), voxel_x=8.0, voxel_y=8.0, max_points_per_voxel=64)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def overrides(root, experiment="hisup_lidar", extra=()):
    return [
        f"experiment={experiment}",
        "dataset=synthetic",
        "run_type=debug",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.country=CH",
        "experiment.dataset.num_train=4",
        "experiment.dataset.num_val=3",
        "experiment.dataset.num_test=2",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "experiment.model.batch_size=2",
        f"experiment.encoder.in_size={S}",
        f"experiment.encoder.patch_feature_dim={VIT['dim']}",
        f"experiment.encoder.max_num_points={NPTS}",
        f"experiment.model.decoder.in_feature_size={S}",
        f"experiment.model.decoder.in_feature_dim={DIM}",
        *extra,
    ]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_slice_lidar")


# --- the loader's LiDAR items --------------------------------------------------------


@pytest.mark.parametrize("experiment,split", [("hisup_lidar", "train"), ("hisup_lidar", "val"),
                                              ("p2p_fusion", "train")])
def test_lidar_loader_items_match_jax(root, experiment, split):
    """The port's batches equal JAX's on the same seeds: the points in
    pixel coordinates, moved by the D4 element and shuffled on the train
    split after the image's draws, padded to max_num_points; the images
    and targets beside them; `lidar` float32 on its way to the device."""
    extra = ["run_type.name=release"]  # the train split shuffled across epochs as in a real run
    jcfg, cfg = jax_compose(overrides(root, experiment, extra)), compose(overrides(root, experiment, extra))
    tok = {}
    if experiment.startswith("p2p"):
        from pixelspointspolygons_tpu.models.pix2poly import Tokenizer as JaxTokenizer

        tok = {"tokenizer": JaxTokenizer(jcfg)}, {"tokenizer": Tokenizer(cfg)}
    want_loader = jax_build_loader(jcfg, split, **(tok[0] if tok else {}))
    got_loader = build_loader(cfg, split, **(tok[1] if tok else {}))
    for epoch in (0, 1):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        for want, got in zip(want_loader, got_loader):
            assert set(got) == set(want) and {"lidar", "lidar_mask"} <= set(got)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["lidar"].shape == (2, NPTS, 3) and got["lidar"].dtype == np.float32
            assert 0 < got["lidar_mask"].sum() <= 2 * NPTS
            dev = to_device(got, CPU, ("lidar", "lidar_mask"))
            assert dev["lidar"].dtype == torch.float32 and dev["lidar_mask"].dtype == torch.bool
    # x, y clipped to [0, S], then the D4 element's (S - 1) - x may reach -1
    pts = got["lidar"][got["lidar_mask"]]
    assert pts[:, :2].min() >= -1 and pts[:, :2].max() <= S and 0 <= pts[:, 2].min() and pts[:, 2].max() <= 100


# --- files ------------------------------------------------------------------------


def _write_las(path, xyz, scale, offset):
    """An uncompressed LAS 1.4 point-format-6 file (tests/test_laz.py's)."""
    XYZ = np.round((xyz - offset) / scale).astype(np.int32)
    hdr = bytearray(375)
    hdr[:4] = b"LASF"
    hdr[24:26] = bytes([1, 4])
    hdr[94:96] = (375).to_bytes(2, "little")
    hdr[96:100] = (375).to_bytes(4, "little")
    hdr[104] = 6
    hdr[105:107] = (30).to_bytes(2, "little")
    hdr[131:155] = np.asarray(scale, np.float64).tobytes()
    hdr[155:179] = np.asarray(offset, np.float64).tobytes()
    hdr[247:255] = len(xyz).to_bytes(8, "little")
    recs = np.zeros((len(xyz), 30), np.uint8)
    recs[:, :12] = XYZ.astype("<i4").view(np.uint8).reshape(len(xyz), 12)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(recs.tobytes())


def test_lidar_files_load_as_in_jax(tmp_path):
    """.npz, .npy, .las and .laz through `load_lidar_file`, equal to JAX's;
    a .laz written by the port's `write_laz` decodes the same by JAX's
    `read_laz` and the port's; the port's library is built under
    `build/torch_kernels/`; a decode outside the header's box raises."""
    rng = np.random.default_rng(0)
    xyz = np.cumsum(rng.integers(-300, 300, size=(3000, 3)), axis=0) * 0.01 + [2_600_000.0, 1_200_000.0, 400.0]
    scale, offset = np.array([0.01, 0.01, 0.01]), np.floor(xyz.min(axis=0))
    paths = {ext: str(tmp_path / f"tile.{ext}") for ext in ("npz", "npy", "las", "laz")}
    np.savez_compressed(paths["npz"], points=xyz)
    np.save(paths["npy"], xyz)
    _write_las(paths["las"], xyz, scale, offset)
    nbytes = laz.write_laz(paths["laz"], xyz, scale=scale, offset=offset)
    assert 0 < nbytes < 30 * len(xyz)
    for ext, path in paths.items():
        got = dataset.load_lidar_file(path)
        np.testing.assert_array_equal(got, jax_dataset.load_lidar_file(path), err_msg=ext)
        np.testing.assert_allclose(got, xyz, rtol=0, atol=0.0051, err_msg=ext)
    np.testing.assert_array_equal(jax_laz.read_laz(paths["laz"]), laz.read_laz(paths["laz"]))
    np.testing.assert_array_equal(laz.read_laz(paths["laz"]), dataset.load_las_points(paths["las"]))
    lib = native.shared_library_path(laz.SOURCE, "libp3laszip")
    assert lib.startswith(os.path.join(ROOT, "build", "torch_kernels") + os.sep) and os.path.isfile(lib)
    assert laz.SOURCE == os.path.join(ROOT, "native", "laszip.cpp")

    raw = bytearray(open(paths["laz"], "rb").read())
    raw[179:187] = np.float64(xyz[:, 0].min() + 1.0).tobytes()  # the header's max x far below the points
    bad = str(tmp_path / "bad.laz")
    with open(bad, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(ValueError, match="header's box"):
        laz.read_laz(bad)


# --- HiSup-LiDAR training -------------------------------------------------------------


@pytest.fixture(scope="module")
def hisup_lidar(root):
    cfg = jax_compose(overrides(root))
    batches = list(jax_build_loader(cfg, "train"))
    assert len(batches) == 2 and batches[0]["lidar"].shape == (2, NPTS, 3) and "images" not in batches[0]
    weights = {k: float(v) for k, v in cfg.experiment.model.loss_weights.items()}
    enc = {"name": "pointpillars_vit_cnn", **VIT, **PILLARS, "out_size": S}
    jm = JaxHiSup(encoder_cfg=enc, dim=DIM, pred_size=S)
    inputs = {"lidar": jnp.asarray(batches[0]["lidar"]), "lidar_mask": jnp.asarray(batches[0]["lidar_mask"])}
    variables = flax_init(jm, inputs)
    return {"batches": batches, "weights": weights, "jm": jm, "variables": variables, "mesh": make_mesh(1),
            "train": jax_step.make_train_step(jm, weights, S), "val": jax_step.make_val_step(jm, weights, S)}


def _jax_state(setup):
    tx = jax_state.make_optimizer("adamw", jax_state.cosine_with_warmup(LR, TOTAL_STEPS), weight_decay=WD)
    state = jax_state.create_train_state(setup["jm"], setup["variables"], tx)
    return jax.device_put(state.replace(step=jnp.asarray(0)), jax.devices()[0])


def _port_state(setup):
    v = setup["variables"]
    model = HiSup(PointPillarsViTCNNEncoder(out_size=S, out_dim=DIM, **VIT, **PILLARS), dim=DIM, pred_size=S)
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    opt = make_optimizer("adamw", model.parameters(), LR, weight_decay=WD)
    return TrainState(model, opt, make_scheduler(opt, cosine_with_warmup(LR, TOTAL_STEPS), LR))


def test_hisup_lidar_train_and_val_steps_match_jax(hisup_lidar):
    """Step 1 from the same weights; step 2 from JAX's state after step 1
    copied into the port; then the val step. Each step's losses, gradient,
    update and BatchNorm statistics against JAX's."""
    setup = hisup_lidar
    weights, mesh = setup["weights"], setup["mesh"]
    jstate, port = _jax_state(setup), _port_state(setup)
    jm = setup["jm"]

    @jax.jit
    def jax_grads(params, batch_stats, jbatch):
        from pixelspointspolygons_tpu.models.hisup.model import encode_targets, hisup_losses

        targets = encode_targets(jbatch, S)

        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": batch_stats},
                              {"lidar": jbatch["lidar"], "lidar_mask": jbatch["lidar_mask"]},
                              train=True, mutable=["batch_stats"])
            return sum(weights[k] * v for k, v in hisup_losses(out, targets).items())

        return jax.grad(loss_fn)(params)

    train = make_train_step(weights, S)
    for i, host_batch in enumerate(setup["batches"]):
        if i:
            _sync_port_to_jax(port, jstate)
        jbatch = shard_batch(host_batch, mesh)
        pbatch = to_device(host_batch, CPU, _DEV_KEYS)
        assert set(pbatch) == set(_DEV_KEYS) - {"images"}
        want_grads = flax_to_state_dict(jax.device_get(jax_grads(jstate.params, jstate.batch_stats, jbatch)))
        jstate, want = setup["train"](jstate, jbatch)
        got = train(port, pbatch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
        grads = {n: p.grad for n, p in port.model.named_parameters()}
        assert set(grads) == set(want_grads) and _rel_l2(grads, want_grads) <= 1e-3
        _assert_params_close(port, jstate, n_updates=1, near_frac=0.02)
        _assert_stats_close(port, jstate, rtol=5e-4)
    jval = setup["val"](jstate, shard_batch(setup["batches"][0], mesh))
    pval = make_val_step(weights, S)(port, to_device(setup["batches"][0], CPU, _DEV_KEYS))
    for k in jval:
        np.testing.assert_allclose(float(pval[k]), float(jval[k]), rtol=1e-4, err_msg=k)


# --- Pix2Poly early-fusion prediction -------------------------------------------------

NV = 12
P2P = dict(vocab_size=S + 3, encoder_len=(S // 8) ** 2, dim=32, num_heads=4, num_layers=2, max_len=2 * NV + 2,
           pad_idx=S + 2, max_num_vertices=NV, sinkhorn_iterations=10)
P2P_ARGS = ["experiment.model.decoder.in_feature_dim=32", "experiment.model.decoder.num_layers=2",
            "experiment.model.decoder.num_heads=4", f"experiment.model.tokenizer.max_num_vertices={NV}",
            "experiment.model.sinkhorn_iterations=10", "evaluation.modes=[iou]"]


def test_p2p_fusion_prediction_matches_jax(root):
    """A tiny early-fusion Pix2Poly from bridged weights, through the port's
    predictor from a `latest` checkpoint, against JAX's predictor on the
    val split: identical tokens and polygons, raw scores within 1e-4."""
    args = overrides(root, "p2p_fusion", P2P_ARGS)
    jcfg, cfg = jax_compose(args), compose(args)
    enc = {"name": "early_fusion_vit", **VIT, **PILLARS}
    jm = JaxPix2Poly(**P2P, encoder_cfg=enc)
    jp = _jax_predictor(jcfg, jm)
    batches = list(jax_build_loader(jcfg, "val", tokenizer=jp.tokenizer, eval_mode=True))
    assert len(batches) == 2 and {"images", "lidar", "lidar_mask"} <= set(batches[0])
    inputs = {k: jnp.asarray(batches[0][k]) for k in ("images", "lidar", "lidar_mask")}
    variables = _weights(flax_init(jm, inputs, jnp.zeros((2, P2P["max_len"] - 1), jnp.int32)))

    os.makedirs(os.path.join(cfg.output_dir, "checkpoints"), exist_ok=True)
    sd = flax_to_state_dict(variables["params"], variables.get("batch_stats"))
    torch.save({"model": sd, "epoch": 0, "cfg": cfg.to_dict()},
               os.path.join(cfg.output_dir, "checkpoints", "latest.pt"))
    port = Pix2PolyPredictor(cfg, device="cpu", model=Pix2Poly(**P2P, encoder_cfg=enc))
    port.load_checkpoint()
    n_polys = 0
    for batch in batches:
        j_tokens, j_scores = (np.asarray(a) for a in jp.decode_async(variables, batch))
        want_polys, _ = jp.assemble(j_tokens.copy(), j_scores.copy())
        (tokens, scores), _ = port.forward(port_pp.to_device(batch, port.device, port_pp.INPUT_KEYS))
        np.testing.assert_array_equal(tokens.numpy(), j_tokens)
        np.testing.assert_allclose(scores.numpy(), j_scores, rtol=0, atol=1e-4)
        got_polys, _ = port.predict_batch(batch)
        assert [len(p) for p in got_polys] == [len(p) for p in want_polys]
        for gb, wb in zip(got_polys, want_polys):
            for g, w in zip(gb, wb):
                np.testing.assert_array_equal(g, w)
            n_polys += len(gb)
    assert n_polys >= 1


# --- port only: every experiment, and the entry points ----------------------------------

EXPERIMENTS = ["p2p_image", "p2p_lidar", "p2p_fusion", "hisup_image", "hisup_lidar", "hisup_fusion",
               "ffl_image", "ffl_lidar", "ffl_fusion"]
TINY = ["experiment.encoder.in_size=32", "experiment.model.decoder.in_feature_size=32",
        "experiment.model.decoder.in_feature_dim=64", "experiment.encoder.patch_feature_dim=96",
        "experiment.encoder.max_num_points=256"]  # tests/test_experiment_matrix.py's


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_experiment_builds_and_runs(experiment):
    """Each of the nine graded experiments builds through its factory at a
    tiny size and runs a train-mode forward and backward on its modality's
    inputs, every parameter getting a gradient (tests/test_experiment_matrix.py
    builds the same nine in JAX)."""
    cfg = compose([f"experiment={experiment}", "dataset=synthetic", "run_type=debug"] + TINY)
    enc = cfg.experiment.encoder
    r = np.random.RandomState(0)
    batch = {}
    if enc.use_images:
        batch["images"] = torch.from_numpy(r.normal(size=(2, 32, 32, 3)).astype(np.float32))
    if enc.use_lidar:
        batch["lidar"] = torch.from_numpy(r.uniform(1, 31, (2, 256, 3)).astype(np.float32))
        batch["lidar_mask"] = torch.from_numpy(r.rand(2, 256) < 0.9)
    gen = torch.Generator().manual_seed(0)
    name = cfg.experiment.model.name
    if name == "pix2poly":
        tok = Tokenizer(cfg)
        model = build_pix2poly(cfg, tok, generator=gen).train()
        logits, perm = model(batch, torch.full((2, tok.max_len - 1), tok.PAD_code, dtype=torch.long))
        out, loss = logits, logits.mean() + perm.mean()
    elif name == "hisup":
        model = hisup_factory.build_hisup(cfg, generator=gen).train()
        outs = model(batch)
        out, loss = outs["mask"], sum(v.mean() for v in outs.values())
    else:
        model = build_ffl(cfg, generator=gen).train()
        outs = model(batch)
        out, loss = outs["seg"], outs["seg"].mean() + outs["crossfield"].mean()
    loss.backward()
    assert torch.isfinite(out).all() and out.shape[0] == 2
    no_grad = [n for n, p in model.named_parameters() if p.grad is None]
    assert not no_grad, no_grad[:5]


@pytest.mark.parametrize("experiment", [e for e in EXPERIMENTS if not e.endswith("image")])
def test_lidar_experiments_run_at_bfloat16(experiment):
    """`host.compute_dtype=bfloat16` builds each LiDAR and fusion experiment
    with bfloat16 layers and float32 parameters, and its eval forward gives
    finite bfloat16 outputs (the layers are held to flax's bfloat16 in
    tests/test_torch_lidar.py and tests/test_torch_fusion.py)."""
    from pixelspointspolygons_torch.train.state import compute_dtype

    cfg = compose([f"experiment={experiment}", "dataset=synthetic", "run_type=debug",
                   "host.compute_dtype=bfloat16"] + TINY)
    dtype = compute_dtype(cfg)
    r = np.random.RandomState(1)
    batch = {"lidar": torch.from_numpy(r.uniform(1, 31, (2, 256, 3)).astype(np.float32)),
             "lidar_mask": torch.from_numpy(r.rand(2, 256) < 0.9)}
    if cfg.experiment.encoder.use_images:
        batch["images"] = torch.from_numpy(r.normal(size=(2, 32, 32, 3)).astype(np.float32))
    name = cfg.experiment.model.name
    with torch.no_grad():
        if name == "pix2poly":
            tok = Tokenizer(cfg)
            model = build_pix2poly(cfg, tok, dtype=dtype).eval()
            out = model.encode(batch)
        elif name == "hisup":
            model = hisup_factory.build_hisup(cfg, dtype=dtype).eval()
            out = model(batch)["remask"]
        else:
            model = build_ffl(cfg, dtype=dtype).eval()
            out = model(batch)["crossfield"]
    assert dtype == torch.bfloat16 and out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.fixture()
def tiny_trunks(monkeypatch):
    """The config tree fixes the ViT's depth and heads; shrink them."""
    for module in (hisup_factory, ffl_model, p2p_factory):
        full = module.encoder_config
        monkeypatch.setattr(module, "encoder_config",
                            lambda cfg, full=full: {**full(cfg), "depth": 1, "num_heads": 2})


def test_ffl_lidar_train_predict_and_demo_from_a_laz_file_on_cpu(tiny_trunks, tmp_path, monkeypatch):
    """`cli.train`, `cli.predict` and `cli.predict_demo` (its LiDAR from a
    .laz file that the port's `write_laz` wrote from a test tile's points)
    for `experiment=ffl_lidar` on the CPU."""
    monkeypatch.chdir(tmp_path)
    common = overrides(tmp_path, "ffl_lidar", ["device=cpu", "experiment.model.num_epochs=1",
                                               "experiment.polygonization.acm_method.steps=5"])
    history = cli_train.main(common)
    assert np.isfinite(history["loss"]) and 0.0 <= history["val_iou"] <= 1.0
    results = cli_predict.main(common + ["evaluation=test", "checkpoint=latest"])
    assert results["num_images"] == 2 and 0.0 <= results["IoU"] <= 1.0
    cfg = compose([a for a in common if a != "device=cpu"])
    info = next(iter(dataset.P3Dataset(cfg, "test").coco.imgs.values()))
    pts = dataset.load_lidar_file(os.path.join(cfg.experiment.dataset.in_path, info["lidar_path"]))
    laz.write_laz(str(tmp_path / "tile.laz"), pts)
    polys, out_file = cli_predict_demo.main(common + ["checkpoint=latest", f"+lidar_file={tmp_path / 'tile.laz'}"])
    assert out_file == "prediction_ffl_lidar.png" and isinstance(polys, list)
    assert cv2.imread(str(tmp_path / out_file)) is not None
    with pytest.raises(ValueError, match="lidar_file"):
        cli_predict_demo.main(common + ["checkpoint=latest"])
