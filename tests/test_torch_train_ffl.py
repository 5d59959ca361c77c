"""FFL training, the port's against the JAX package's, on the CPU at
float32: the ground truth, the D4 replay of the angle field, the train and
val items (before and after the float16 transfer), the Scharr gradient,
every loss term and its gradient, `make_train_step` and `make_val_step` of
a tiny FFL (tests/test_ffl.py::tiny_ffl's sizes: img 32, patch 8, dim 32,
depth 1, 2 heads) from the same weights (drawn from a numpy seed in the
shapes `jax.eval_shape` gives, bridged into the port), then the trainer
end to end with a resume and a warm start, and its command line.

Step 1 runs from identical weights. Step 2 and the val step run from the
JAX state before them copied into the port (parameters, BatchNorm
statistics, Adam's moments and count), so each step is compared on
identical inputs.

Tolerances and why:
- the ground truth, the angle replay and the items: the same numpy and cv2
  calls in the same order, so equal (exact), and equal again after each
  side's float16 transfer;
- the Scharr gradient: 1e-6 absolute on a map in [-1, 1] (a convolution
  summed in another order);
- each loss term and the total: 1e-5 relative (float32 means over a few
  thousand pixels summed in other orders; measured ≤ 2.4e-6); the
  gradient with respect to the outputs: 1e-5 of its largest element (XLA
  contracts the complex products into FMAs; measured ≤ 3e-7). The port
  takes JAX's side where the two autograds disagree at a point (`jnp.clip`
  at a bound, `jnp.abs` at 0), which the fixture's flat patches reach;
- a step's losses: 1e-5 relative (float32 through the ViT, four
  convolutions and the losses; measured ≤ 6e-6, the port within 6e-7 of
  its own float64 losses and JAX within 5.4e-6 of them: flax's train-mode
  BatchNorm takes the variance as E[x²] - E[x]², which cancels); learning
  rate 1e-6 relative (optax evaluates the schedule in float32);
- parameters after an update: Adam's first steps move each element by
  about lr·sign(g); where |g| is at the rounding noise (a bias feeding a
  BatchNorm), the two sides can move it in opposite directions, 2·lr
  apart. Every element within 2·lr (+1e-7), all but 2 % within 1e-6, as
  for Pix2Poly (tests/test_torch_train_pix2poly.py);
- BatchNorm running statistics: 1e-5 relative (+1e-6) after an identical
  step; the val step's losses 1e-5 relative.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.data import P3Dataset as JaxDataset
from pixelspointspolygons_tpu.data import augment as jax_augment
from pixelspointspolygons_tpu.data import ensure_synthetic_dataset as jax_ensure
from pixelspointspolygons_tpu.data import ffl_gt as jax_ffl_gt
from pixelspointspolygons_tpu.models.ffl import FFL as JaxFFL
from pixelspointspolygons_tpu.models.ffl import losses as jax_losses
from pixelspointspolygons_tpu.ops.spatial_grad import spatial_gradient as jax_spatial_gradient
from pixelspointspolygons_tpu.parallel import make_mesh, shard_batch
from pixelspointspolygons_tpu.train import ffl_step as jax_step
from pixelspointspolygons_tpu.train import state as jax_state
from pixelspointspolygons_torch.cli import train as cli_train
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data import P3Dataset, ensure_synthetic_dataset
from pixelspointspolygons_torch.data import augment, ffl_gt
from pixelspointspolygons_torch.data.loader import to_device
from pixelspointspolygons_torch.data.synthetic import generate_tile
from pixelspointspolygons_torch.models.ffl import FFL
from pixelspointspolygons_torch.models.ffl import losses
from pixelspointspolygons_torch.models.ffl import model as ffl_model
from pixelspointspolygons_torch.models.vit import ViTCNNEncoder
from pixelspointspolygons_torch.ops.spatial_grad import spatial_gradient
from pixelspointspolygons_torch.train.ffl_step import make_train_step, make_val_step
from pixelspointspolygons_torch.train.state import TrainState, cosine_with_warmup, make_optimizer, make_scheduler
from pixelspointspolygons_torch.train.trainer_ffl import FFL_BATCH_KEYS, FFLTrainer
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_ffl import VIT, _random_variables, one_torch_thread  # noqa: F401 (an autouse fixture)

S, DIM = 32, 32
LR, TOTAL_STEPS = 1e-4, 40
EPOCH = 7  # seg_interior_crossfield's weight is 0.08 here, between the thresholds 5 and 10


def overrides(root, extra=()):
    return [
        "experiment=ffl_image",
        "dataset=synthetic",
        "run_type=debug",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.num_train=4",
        "experiment.dataset.num_val=2",
        "experiment.dataset.num_test=2",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "experiment.model.batch_size=2",
        "experiment.model.num_epochs=2",
        "training.val_every=2",
        "training.save_every=100",
        f"experiment.encoder.in_size={S}",
        f"experiment.encoder.patch_feature_dim={DIM}",
        f"experiment.model.decoder.in_feature_dim={DIM}",
        "experiment.polygonization.acm_method.steps=20",
        *extra,
    ]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same synthetic tiles written by each package into its own root,
    so that each computes and caches its own ground truth."""
    root = tmp_path_factory.mktemp("torch_train_ffl")
    jcfg, pcfg = jax_compose(overrides(root / "jax")), compose(overrides(root / "port"))
    jax_ensure(jcfg)
    ensure_synthetic_dataset(pcfg)
    return jcfg, pcfg


# --- the ground truth and the items -----------------------------------------


def test_compute_ffl_gt_matches_jax(datasets):
    """All four arrays, on the 32 px tiles of the train split and on a
    224 px synthetic tile."""
    pds = P3Dataset(datasets[1], "train")
    cases = [(pds._polygons(pds.coco.imgs[i]), S) for i in pds.tile_ids]
    cases.append((generate_tile(np.random.RandomState(7), 224)[2], 224))
    for polygons, size in cases:
        polygons = [np.asarray(p, np.float64) for p in polygons]
        got, want = ffl_gt.compute_ffl_gt(polygons, size, size), jax_ffl_gt.compute_ffl_gt(polygons, size, size)
        assert set(got) == set(want) == {"gt_polygons_image", "distances", "sizes", "gt_crossfield_angle"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sum(len(p) for p, _ in cases) >= 6


@pytest.mark.parametrize("g", augment.D4_ELEMENTS)
def test_apply_d4_crossfield_angle_matches_jax(g):
    angle = np.random.RandomState(0).uniform(0, np.pi, (9, 7)).astype(np.float32)
    angle[0, :4] = [0.0, np.float32(np.pi / 2), np.float32(np.pi) - 1e-6, 1e-7]
    got, want = augment.apply_d4_crossfield_angle(angle, g), jax_augment.apply_d4_crossfield_angle(angle, g)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _f16_transfer(batch: dict) -> tuple[dict, dict]:
    """Each side's device copy of a host batch: the port's `to_device` on
    the CPU (float16 keys promoted to float32) and JAX's `shard_batch`
    (float16 leaves), both as float32 numpy."""
    port = to_device(batch, torch.device("cpu"), FFL_BATCH_KEYS)
    jax_side = shard_batch({k: batch[k] for k in FFL_BATCH_KEYS if k in batch}, make_mesh(1))
    return ({k: v.numpy() for k, v in port.items()},
            {k: np.asarray(v).astype(np.float32) if v.dtype == jnp.float16 else np.asarray(v) for k, v in jax_side.items()})


@pytest.mark.parametrize("split", ["train", "val"])
def test_ffl_items_match_jax(datasets, split):
    """The train items (D4, colour jitter, noise; the angle replayed) and the
    val items for three seeds per tile, each package from its own cache
    (the port's under ffl_cache_torch); then both sides' float16 transfer
    of the batch."""
    jds, pds = JaxDataset(datasets[0], split), P3Dataset(datasets[1], split)
    assert len(pds) == len(jds) > 0
    items = []
    for idx in range(len(jds)):
        for seed in range(3):
            want = jds.get_item(idx, np.random.RandomState(seed))
            got = pds.get_item(idx, np.random.RandomState(seed))
            assert set(got) == set(want) == {"image_id", *FFL_BATCH_KEYS} - {"lidar", "lidar_mask"}
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            items.append(got)
    assert os.path.isdir(os.path.join(pds.dataset_dir, "ffl_cache_torch", split))
    assert len(os.listdir(os.path.join(pds.dataset_dir, "ffl_cache_torch", split))) == len(pds)
    assert not os.path.isdir(os.path.join(pds.dataset_dir, "ffl_cache"))
    assert items[0]["gt_polygons_image"].shape == (3, S, S) and items[0]["gt_crossfield_angle"].shape == (1, S, S)
    assert sum(float(it["gt_polygons_image"][1].sum()) for it in items) > 0
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    port, jax_side = _f16_transfer(batch)
    assert set(port) == set(jax_side) == set(FFL_BATCH_KEYS) - {"lidar", "lidar_mask"}
    for k in port:
        np.testing.assert_array_equal(port[k], jax_side[k], err_msg=k)
    # the float16 round moves the angle by at most half a float16 step
    assert 0 < np.abs(port["gt_crossfield_angle"] - batch["gt_crossfield_angle"]).max() <= 2.0**-10


# --- the ops and the losses --------------------------------------------------


def test_spatial_gradient_matches_jax():
    x = np.random.RandomState(1).uniform(-1, 1, (2, 3, 11, 13)).astype(np.float32)
    got = spatial_gradient(torch.from_numpy(x))
    assert got.shape == (2, 3, 2, 11, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_spatial_gradient(jnp.asarray(x))), rtol=0, atol=1e-6)


def _loss_inputs(channels: int, seed: int = 0, B: int = 2, size: int = 24):
    """Outputs with flat patches (zero seg gradient, so the safe norm and
    JAX's subgradients matter) and a saturated one; targets rounded through
    float16 as the loader ships them."""
    r = np.random.RandomState(seed)
    seg = r.uniform(0, 1, (B, channels, size, size)).astype(np.float32)
    seg[:, :, :6, :6] = 0.25
    seg[0, 0, 10:14, 10:14] = 1.0
    img = (r.rand(B, 3, size, size) > 0.6).astype(np.float32)
    img[:, 0] *= r.uniform(0.9, 1.0, (B, size, size)).astype(np.float32)
    batch = {
        "gt_polygons_image": img,
        "distances": r.rand(B, 1, size, size).astype(np.float32),
        "sizes": np.clip(r.rand(B, 1, size, size), 0.05, 1).astype(np.float32),
        "gt_crossfield_angle": (r.rand(B, 1, size, size) * np.pi).astype(np.float32),
    }
    batch = {k: v.astype(np.float16).astype(np.float32) for k, v in batch.items()}
    batch["class_freq"] = np.tile([[0.8, 0.2]], (B, 1)).astype(np.float32)
    return {"seg": seg, "crossfield": r.uniform(-2, 2, (B, 4, size, size)).astype(np.float32)}, batch


_LOSS_CASES = {
    "bool": [],
    "float_with_pixel_weights": ["experiment.model.loss.seg.type=float", "experiment.model.loss.seg.use_freq=true",
                                 "experiment.model.loss.seg.use_dist=true", "experiment.model.loss.seg.use_size=true"],
    "bool_with_pixel_weights": ["experiment.model.loss.seg.use_freq=true", "experiment.model.loss.seg.use_size=true"],
    "edge_and_vertex": ["experiment.model.seg.compute_edge=true", "experiment.model.seg.compute_vertex=true"],
    "normalize": ["experiment.model.loss.multi.normalize=true", "experiment.model.seg.compute_edge=true"],
}


@pytest.mark.parametrize("case", list(_LOSS_CASES))
def test_losses_and_their_gradients_match_jax(case):
    """Every active term, the total and its gradient with respect to seg and
    crossfield. With `normalize`, the total over a `LossNormTracker`'s norms
    after two epoch updates, against JAX's tracker."""
    args = ["experiment=ffl_image", "dataset=synthetic", "experiment.encoder.in_size=24", *_LOSS_CASES[case]]
    jcfg, pcfg = jax_compose(args), compose(args)
    jloss, jweights = jax_losses.make_ffl_loss(jcfg)
    ploss, pweights = losses.make_ffl_loss(pcfg)
    assert pweights(EPOCH) == jweights(EPOCH)
    channels = 1 + 2 * ("vertex" in case) + ("normalize" in case)
    outputs, batch = _loss_inputs(channels)
    norms = jnorms = None
    if case == "normalize":
        tracker, jtracker = losses.LossNormTracker(pweights(0)), jax_losses.LossNormTracker(jweights(0))
        for r in (np.random.RandomState(5).uniform(0.1, 3, (2, len(pweights(0)))).tolist()):
            epoch_means = {"loss": 1.0, **dict(zip(pweights(0), r))}
            tracker.update(epoch_means)
            jtracker.update(epoch_means)
        norms, jnorms = tracker.norms(), jtracker.norms()
        assert norms == {k: float(v) for k, v in jnorms.items()} and len(norms) == 7

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.float32(v) for k, v in jweights(EPOCH).items()}

    def jtotal(o):
        total, terms = jloss(o, jbatch, jw, jnorms) if norms else jloss(o, jbatch, jw)
        return total, terms

    (want, want_terms), want_grads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    out = {k: torch.from_numpy(v).requires_grad_() for k, v in outputs.items()}
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, got_terms = ploss(out, pbatch, pweights(EPOCH), norms) if norms else ploss(out, pbatch, pweights(EPOCH))
    got.backward()

    assert set(got_terms) == set(want_terms) and len(want_terms) >= 5
    for k in want_terms:
        np.testing.assert_allclose(float(got_terms[k].detach()), float(want_terms[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for k in outputs:
        g, w = out[k].grad.numpy(), np.asarray(want_grads[k])
        assert np.isfinite(g).all(), k
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
    if case == "normalize":  # the raw total differs from the optimized one
        raw, _ = ploss({k: v.detach() for k, v in out.items()}, pbatch, pweights(EPOCH))
        assert abs(float(raw) - float(got)) > 1e-3


def test_epoch_weight_matches_jax():
    cfg = jax_compose(["experiment=ffl_image", "dataset=synthetic"])
    thresholds = [int(t) for t in cfg.experiment.model.loss.multi.epoch_thresholds]
    for spec in ([0, 0, 0.2], [1.0, 0.5, 0.0, 0.25], 0.005, 1):
        t = thresholds if isinstance(spec, int | float) or len(spec) == 3 else [0, 3, 7, 20]
        for epoch in range(25):
            assert losses.epoch_weight(spec, epoch, t) == jax_losses.epoch_weight(spec, epoch, t)
    _, pweights = losses.make_ffl_loss(compose(["experiment=ffl_image", "dataset=synthetic"]))
    _, jweights = jax_losses.make_ffl_loss(cfg)
    assert [pweights(e) for e in range(12)] == [jweights(e) for e in range(12)]
    assert pweights(0)["seg_interior_crossfield"] == 0.0 and pweights(10)["seg_interior_crossfield"] == 0.2


# --- the steps ---------------------------------------------------------------


@pytest.fixture(scope="module")
def step_setup(datasets):
    """Two host batches of the port's train loader (float16-rounded where
    the loaders round), the JAX FFL and its variables, and JAX's steps."""
    from pixelspointspolygons_torch.data.loader import F16_KEYS, build_loader

    loader = build_loader(datasets[1], "train")
    batches = [{k: (v.astype(np.float16).astype(np.float32) if k in F16_KEYS else v) for k, v in b.items()
                if k in FFL_BATCH_KEYS} for b in loader]
    assert len(batches) == 2
    jm = JaxFFL(encoder_cfg={"name": "vit_cnn", **VIT, "out_size": S}, dim=DIM, seg_channels=1, out_size=S)
    variables = _random_variables(jm, {"images": jnp.asarray(batches[0]["images"])}, 3)
    jloss, jweights = jax_losses.make_ffl_loss(datasets[0])
    ploss, pweights = losses.make_ffl_loss(datasets[1])
    return {"batches": batches, "jm": jm, "variables": variables, "jweights": jweights, "pweights": pweights,
            "ploss": ploss, "train": jax_step.make_train_step(jm, jloss), "val": jax_step.make_val_step(jm, jloss)}


def _port_state(variables):
    model = FFL(ViTCNNEncoder(out_size=S, out_dim=DIM, **VIT), dim=DIM, seg_channels=1, out_size=S)
    model.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]), strict=True)
    opt = make_optimizer("adam", model.parameters(), LR)
    return TrainState(model, opt, make_scheduler(opt, cosine_with_warmup(LR, TOTAL_STEPS), LR))


def _sync_port_to_jax(port, jstate):
    """Copy the JAX state (parameters, batch_stats, Adam's moments and count) into the port."""
    port.model.load_state_dict(flax_to_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    adam = jstate.opt_state[0]  # (scale_by_adam, scale_by_learning_rate)
    mu, nu = flax_to_state_dict(jax.device_get(adam.mu)), flax_to_state_dict(jax.device_get(adam.nu))
    for name, p in port.model.named_parameters():
        st = port.optimizer.state[p]
        st["exp_avg"].copy_(mu[name])
        st["exp_avg_sq"].copy_(nu[name])
        st["step"].fill_(int(adam.count))


def test_two_train_steps_and_val_step_match_jax(step_setup):
    s = step_setup
    tx = jax_state.make_optimizer("adam", jax_state.cosine_with_warmup(LR, TOTAL_STEPS))
    jstate = jax.device_put(jax_state.create_train_state(s["jm"], s["variables"], tx), jax.devices()[0])
    port = _port_state(s["variables"])
    schedule = jax_state.cosine_with_warmup(LR, TOTAL_STEPS)
    ptrain = make_train_step(s["ploss"])
    jw = {k: jnp.float32(v) for k, v in s["jweights"](EPOCH).items()}
    for i, host in enumerate(s["batches"]):
        if i:  # step 2 from the JAX state after step 1
            _sync_port_to_jax(port, jstate)
        np.testing.assert_allclose(port.scheduler.get_last_lr()[0], float(schedule(int(jstate.step))), rtol=1e-6)
        jstate, want = s["train"](jstate, {k: jnp.asarray(v) for k, v in host.items()}, jw)
        got = ptrain(port, {k: torch.from_numpy(v) for k, v in host.items()}, s["pweights"](EPOCH))
        assert set(got) == set(want) and len(want) == 6
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
        want_params = flax_to_state_dict(jax.device_get(jstate.params))
        n_far = n_total = 0
        for name, p in port.model.named_parameters():
            d = (p.detach() - want_params[name]).abs()
            assert float(d.max()) <= 2 * LR * 1.0001 + 1e-7, name
            n_far += int((d > 1e-6).sum())
            n_total += d.numel()
        assert n_far <= 0.02 * n_total, f"{n_far} of {n_total} parameters differ by more than 1e-6"
        stats = flax_to_state_dict({}, jax.device_get(jstate.batch_stats))
        sd = port.model.state_dict()
        assert len(stats) == 6  # 3 BatchNorms (encoder, seg head, crossfield head) x (mean, var)
        for k, v in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
        assert port.step == int(jstate.step) == i + 1

    host = s["batches"][0]
    _sync_port_to_jax(port, jstate)  # the val step from identical weights too
    jval = s["val"](jstate, {k: jnp.asarray(v) for k, v in host.items()}, jw)
    pval = make_val_step(s["ploss"])(port, {k: torch.from_numpy(v) for k, v in host.items()}, s["pweights"](EPOCH))
    assert set(pval) == set(jval)
    for k in jval:
        np.testing.assert_allclose(float(pval[k]), float(jval[k]), rtol=1e-5, err_msg=k)


# --- the trainer and its command line ---------------------------------------


@pytest.fixture()
def tiny_vit(monkeypatch):
    """The config tree fixes the ViT's depth and heads; shrink them."""
    full = ffl_model.encoder_config
    monkeypatch.setattr(ffl_model, "encoder_config", lambda cfg: {**full(cfg), "depth": 1, "num_heads": 2})


def test_trainer_end_to_end_resume_and_warm_start(tiny_vit, tmp_path):
    """Two epochs: the losses, the val IoU of the second epoch through the
    ACM (on the model's float32 maps), `latest` and `best_val_loss`; a
    resume from `latest` restores the weights, Adam, the schedule and the
    epoch; `init_weights_from` grafts the weights with a fresh optimizer."""
    cfg = compose(overrides(tmp_path))
    trainer = FFLTrainer(cfg, device="cpu")
    history = trainer.train()
    assert history["epoch"] == 1
    terms = {"seg", "crossfield_align", "crossfield_align90", "crossfield_smooth", "seg_interior_crossfield"}
    assert set(history) == {"epoch", "val_iou"} | {p + k for p in ("", "val_") for k in ("loss", *terms)}
    assert all(np.isfinite(v) for v in history.values())
    assert 0.0 <= history["val_iou"] <= 1.0
    assert trainer._predictor.model is trainer.state.model and trainer._predictor.map_dtype == torch.float32
    assert trainer.state.step == 4 and trainer.state.scheduler.last_epoch == 4
    assert trainer.manager.exists("latest") and trainer.manager.exists("best_val_loss")

    cfg2 = copy.deepcopy(cfg)
    cfg2.checkpoint = "latest"
    resumed = FFLTrainer(cfg2, device="cpu")
    resumed.train()
    assert resumed.start_epoch == 2 and resumed.state.step == 4 and resumed.state.scheduler.last_epoch == 4
    want = trainer.state.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in resumed.state.model.state_dict().items())
    moments = [(trainer.state.optimizer.state[p], resumed.state.optimizer.state[q])
               for p, q in zip(trainer.state.model.parameters(), resumed.state.model.parameters())]
    assert all(torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]) and int(a["step"]) == int(b["step"]) == 4
               for a, b in moments)

    warm = FFLTrainer(compose(overrides(tmp_path / "warm", [f"init_weights_from={trainer.manager.path('latest')}"])),
                      device="cpu")
    warm.generator = torch.Generator().manual_seed(7)
    warm.setup()
    got = warm.state.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert warm.state.step == 0 and warm.start_epoch == 0 and not warm.state.optimizer.state


@pytest.mark.parametrize("normalize", [False, True])
def test_cli_trains_ffl_on_cpu(tiny_vit, tmp_path, monkeypatch, normalize):
    """`cli.train experiment=ffl_image device=cpu`; with
    `loss.multi.normalize` the running norms are updated once per epoch
    from the epoch-mean raw losses (JAX trainer_ffl.py:133-143)."""
    updates = []
    monkeypatch.setattr(losses.LossNormTracker, "update",
                        lambda self, means, run=losses.LossNormTracker.update: (updates.append(dict(means)),
                                                                                 run(self, means)))
    extra = ["experiment.model.num_epochs=1", "device=cpu", f"experiment.model.loss.multi.normalize={normalize}"]
    history = cli_train.main(overrides(tmp_path, extra))
    assert history["epoch"] == 0 and np.isfinite(history["loss"]) and 0.0 <= history["val_iou"] <= 1.0
    if normalize:
        terms = {k: v for k, v in history.items() if k not in ("epoch", "loss") and not k.startswith("val_")}
        assert len(updates) == 1 and updates[0] == terms and len(terms) == 5
    else:
        assert not updates


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(overrides(tmp_path))
