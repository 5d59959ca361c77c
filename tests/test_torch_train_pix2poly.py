"""Pix2Poly training, the port's against the JAX package's, on the CPU at
float32: the two losses, `make_train_step` and `make_val_step` from the
same bridged weights (the tiny ViT and decoder of
tests/test_torch_pix2poly.py, 10 Sinkhorn iterations, batch 2; flax's
default init drawn with numpy, then varied), then the trainer end to end
with its command line.

Step 1 runs from identical weights. Step 2 runs from the JAX state after
step 1 copied into the port (parameters, ScoreNet BatchNorm statistics,
AdamW's moments and count), so each step is compared on identical inputs.

Tolerances and why:
- the losses alone: 1e-6 relative (the same float32 operations; the CE's
  logsumexp and the BCE's mean sum in another order);
- a step's losses: 1e-5 relative (float32 through the encoder, 2 decoder
  layers, the ScoreNets and 10 Sinkhorn iterations, summed in other orders);
- learning rate: 1e-6 relative (optax evaluates the schedule in float32);
- gradients: both float32 gradients against the port's float64 gradient,
  which is exact to ~1e-12 here. Measured: the port's is off by 1.1e-6
  and 1.3e-6 in the two steps, JAX's by 1.5e-6 and 1.8e-6 (relative L2
  over all parameters), so both bounds are 1e-5, and the two against each
  other 2e-5;
- parameters after an update: AdamW's first steps move each element by
  about lr·sign(g). Where |g| is at the rounding noise of the gradient
  (e.g. the bias of a Dense that feeds a BatchNorm, whose exact gradient is
  0), the two sides can move it in opposite directions, 2·lr apart. Every
  element must be within 2·lr (+1e-7), and all but 2 % within 1e-6;
- BatchNorm running statistics: 1e-5 relative (+1e-6) after an identical
  step.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.models.pix2poly import Pix2Poly as JaxPix2Poly
from pixelspointspolygons_tpu.train import pix2poly_step as jax_step
from pixelspointspolygons_tpu.train import state as jax_state
from pixelspointspolygons_torch.cli import train as cli_train
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.models.pix2poly import Pix2Poly, factory
from pixelspointspolygons_torch.train.pix2poly_step import (
    make_train_step,
    make_val_step,
    perm_bce_loss,
    token_ce_loss,
)
from pixelspointspolygons_torch.train.state import TrainState, linear_warmup_decay, make_optimizer, make_scheduler
from pixelspointspolygons_torch.train.trainer_pix2poly import Pix2PolyTrainer
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager

# tests/test_torch_pix2poly.py::tiny
TINY = dict(vocab_size=19, encoder_len=16, dim=32, num_heads=4, num_layers=2, max_len=12, pad_idx=18,
            max_num_vertices=5, sinkhorn_iterations=10)
TINY_ENC = {"name": "vit", "img_size": 16, "patch_size": 4, "dim": 32, "depth": 1, "num_heads": 2}
BOS, EOS, PAD = 16, 17, 18
VW, PW = 1.0, 10.0  # config/model/pix2poly.yaml
LR, WD, TOTAL_STEPS = 3e-4, 1e-4, 40


def make_batch(seed: int) -> dict:
    """Two tiles (images rounded through float16, as the loaders ship them),
    token sequences of 4 and 2 vertices with a PAD tail, and their successor
    permutations with identity padding (data/dataset.py::build_perm_targets)."""
    r = np.random.RandomState(seed)
    images = r.normal(size=(2, 16, 16, 3)).astype(np.float16).astype(np.float32)
    y = np.full((2, TINY["max_len"]), PAD, np.int32)
    y_perm = np.zeros((2, 5, 5), np.float32)
    y[:, 0] = BOS
    for b, n in enumerate((4, 2)):
        y[b, 1 : 1 + 2 * n] = r.randint(0, 16, 2 * n)
        y[b, 1 + 2 * n] = EOS
        y_perm[b, np.arange(n), np.roll(np.arange(n), -1)] = 1.0
        y_perm[b, range(n, 5), range(n, 5)] = 1.0
    return {"images": images, "y": y, "y_perm": y_perm}


def flax_init(module, *args, seed: int = 0) -> dict:
    """Variables of `module` drawn with numpy from flax's default
    initializers (lecun-normal kernels, zero biases, unit norm scales,
    embeddings of std 1/sqrt(dim), position embeddings and the CLS token of
    std 0.02, bin_score 1; BatchNorm statistics 0 and 1): the tree comes from
    `jax.eval_shape`, since compiling `init` takes seconds."""
    r = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), *args)

    def draw(path, leaf):
        name, shape = str(getattr(path[-1], "key", path[-1])), leaf.shape
        if name == "kernel":
            x = r.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            x = r.normal(size=shape) / np.sqrt(shape[-1])
        elif name in ("pos_embed", "cls_token", "decoder_pos_embed", "encoder_pos_embed"):
            x = 0.02 * r.normal(size=shape)
        elif name in ("scale", "var", "bin_score"):
            x = np.ones(shape)
        else:  # bias, mean
            x = np.zeros(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def vary(variables, seed=6):
    """Unit-scale embeddings and position embeddings (flax's init gives every
    decoder position nearly the same input) and ScoreNet BatchNorm affines
    away from 1 and 0."""
    v = copy.deepcopy(jax.device_get(variables))
    r = np.random.RandomState(seed)
    dec = v["params"]["decoder"]
    for k in ("decoder_pos_embed", "encoder_pos_embed"):
        dec[k] = r.normal(size=dec[k].shape).astype(np.float32)
    dec["embedding"]["embedding"] = r.normal(size=dec["embedding"]["embedding"].shape).astype(np.float32)
    for sn in ("scorenet1", "scorenet2"):
        for name, bn in v["params"][sn].items():
            if name.startswith("BatchNorm"):
                bn["scale"] = r.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
                bn["bias"] = r.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
    return v


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


@pytest.fixture(scope="module")
def setup():
    jm = JaxPix2Poly(**TINY, encoder_cfg=TINY_ENC)
    batches = [make_batch(0), make_batch(1)]
    variables = vary(flax_init(jm, {"images": jnp.asarray(batches[0]["images"])}, jnp.asarray(batches[0]["y"][:, :-1])))

    @jax.jit
    def grads(params, batch_stats, batch):
        """The gradient the JAX train step takes (its loss_fn, pix2poly_step.py:50-65)."""

        def loss_fn(p):
            (logits, perm), _ = jm.apply({"params": p, "batch_stats": batch_stats}, {"images": batch["images"]},
                                         batch["y"][:, :-1], train=True, mutable=["batch_stats"])
            return (VW * jax_step.token_ce_loss(logits, batch["y"][:, 1:], PAD)
                    + PW * jax_step.perm_bce_loss(perm, batch["y_perm"]))

        return jax.grad(loss_fn)(params)

    return {
        "jm": jm,
        "variables": variables,
        "batches": batches,
        "train": jax_step.make_train_step(jm, VW, PW, PAD),
        "val": jax_step.make_val_step(jm, VW, PW, PAD),
        "grads": grads,
    }


def jax_state_of(setup):
    tx = jax_state.make_optimizer("adamw", jax_state.linear_warmup_decay(LR, TOTAL_STEPS, 0.05), weight_decay=WD,
                                  b2=0.95)
    state = jax_state.create_train_state(setup["jm"], setup["variables"], tx)
    return jax.device_put(state.replace(step=jnp.asarray(0)), jax.devices()[0])


def port_state_of(setup):
    v = setup["variables"]
    model = Pix2Poly(**TINY, encoder_cfg=TINY_ENC)
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]), strict=True)
    opt = make_optimizer("adamw", model.parameters(), LR, weight_decay=WD, b2=0.95)
    return TrainState(model, opt, make_scheduler(opt, linear_warmup_decay(LR, TOTAL_STEPS, 0.05), LR))


def port64_grads(state, batch: dict) -> dict:
    """The port's gradient of the same loss evaluated in float64."""
    from pixelspointspolygons_torch.train.pix2poly_step import _losses

    model = Pix2Poly(**TINY, encoder_cfg=TINY_ENC, dtype=torch.float64).double()
    model.load_state_dict(state.model.state_dict())
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    _losses(model.train(), b64, VW, PW, PAD)["loss"].backward()
    return {n: p.grad for n, p in model.named_parameters()}


def sync_port_to_jax(port, jstate):
    """Copy the JAX state (params, batch_stats, AdamW moments and count) into the port."""
    port.model.load_state_dict(flax_to_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    adam = jstate.opt_state[0]  # (scale_by_adam, add_decayed_weights, scale_by_learning_rate)
    mu, nu = flax_to_state_dict(jax.device_get(adam.mu)), flax_to_state_dict(jax.device_get(adam.nu))
    for name, p in port.model.named_parameters():
        st = port.optimizer.state[p]
        st["exp_avg"].copy_(mu[name])
        st["exp_avg_sq"].copy_(nu[name])
        st["step"].fill_(int(adam.count))
    assert port.step == int(jstate.step)


def assert_params_close(port, jstate):
    want = flax_to_state_dict(jax.device_get(jstate.params))
    n_far = n_total = 0
    for name, p in port.model.named_parameters():
        d = (p.detach() - want[name]).abs()
        assert float(d.max()) <= 2 * LR * 1.0001 + 1e-7, name
        n_far += int((d > 1e-6).sum())
        n_total += d.numel()
    assert n_far <= 0.02 * n_total, f"{n_far} of {n_total} parameters differ by more than 1e-6"


# --- the losses --------------------------------------------------------------


@pytest.mark.parametrize("case", ["mixed", "all_pad", "no_pad"])
def test_token_ce_loss_matches_jax(case):
    """PAD targets left out, over max(count, 1): an all-PAD batch gives 0
    (F.cross_entropy with ignore_index would give NaN)."""
    r = np.random.RandomState(3)
    logits = (r.normal(size=(3, 11, 19)) * 3).astype(np.float32)
    targets = r.randint(0, 19, (3, 11)).astype(np.int32)
    if case == "all_pad":
        targets[:] = PAD
    elif case == "no_pad":
        targets[targets == PAD] = 0
    else:
        targets[1, 5:] = PAD
    want = float(jax_step.token_ce_loss(jnp.asarray(logits), jnp.asarray(targets), PAD))
    got = float(token_ce_loss(torch.from_numpy(logits), torch.from_numpy(targets), PAD))
    if case == "all_pad":
        assert got == want == 0.0
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_perm_bce_loss_matches_jax():
    """Probabilities at and beyond the clip [1e-7, 1 - 1e-7] (0, 1e-9, 1,
    1 - 1e-9 and 1e-7 itself) and inside it: values, and gradients away from
    the two clip points themselves (there jnp.clip splits the gradient, torch's
    clamp passes it)."""
    r = np.random.RandomState(4)
    perm = r.uniform(0, 1, (2, 5, 5)).astype(np.float32)
    perm[0, 0, :5] = [0.0, 1e-9, 1.0, 1.0 - 1e-9, 1e-7]
    gt = (r.uniform(size=(2, 5, 5)) < 0.3).astype(np.float32)
    want = float(jax_step.perm_bce_loss(jnp.asarray(perm), jnp.asarray(gt)))
    p = torch.from_numpy(perm).requires_grad_()
    got = perm_bce_loss(p, torch.from_numpy(gt))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()
    want_grad = np.asarray(jax.grad(lambda q: jax_step.perm_bce_loss(q, jnp.asarray(gt)))(jnp.asarray(perm)))
    away = np.ones_like(perm, bool)
    away[0, 0, 4] = False
    np.testing.assert_allclose(p.grad.numpy()[away], want_grad[away], rtol=1e-5, atol=1e-9)
    assert (p.grad.numpy()[0, 0, :4] == 0).all()


# --- the steps ---------------------------------------------------------------


def test_two_train_steps_and_val_step_match_jax(setup):
    jstate, port = jax_state_of(setup), port_state_of(setup)
    ptrain = make_train_step(VW, PW, PAD)
    schedule = jax_state.linear_warmup_decay(LR, TOTAL_STEPS, 0.05)
    key = jax.random.PRNGKey(0)
    for i, host_batch in enumerate(setup["batches"]):
        if i:  # step 2 from the JAX state after step 1
            sync_port_to_jax(port, jstate)
        jbatch = {k: jnp.asarray(v) for k, v in host_batch.items()}
        pbatch = to_torch(host_batch)
        np.testing.assert_allclose(port.scheduler.get_last_lr()[0], float(schedule(int(jstate.step))), rtol=1e-6)
        want_grads = flax_to_state_dict(jax.device_get(setup["grads"](jstate.params, jstate.batch_stats, jbatch)))
        exact = port64_grads(port, pbatch)

        jstate, want = setup["train"](jstate, jbatch, key)
        got = ptrain(port, pbatch)

        assert set(got) == set(want) == {"loss", "vertex_loss", "perm_loss"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
        port_grads = {n: p.grad for n, p in port.model.named_parameters()}
        assert set(port_grads) == set(want_grads) == set(exact)
        assert rel_l2(port_grads, exact) <= 1e-5
        assert rel_l2(want_grads, exact) <= 1e-5
        assert rel_l2(port_grads, want_grads) <= 2e-5
        assert_params_close(port, jstate)
        stats = flax_to_state_dict({}, jax.device_get(jstate.batch_stats))
        sd = port.model.state_dict()
        assert len(stats) == 12  # 3 BatchNorms x (mean, var) x 2 ScoreNets
        for k, v in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
        assert port.step == int(jstate.step) == i + 1

    host_batch = setup["batches"][0]
    jval = setup["val"](jstate, {k: jnp.asarray(v) for k, v in host_batch.items()})
    pval = make_val_step(VW, PW, PAD)(port, to_torch(host_batch))
    for k in jval:
        np.testing.assert_allclose(float(pval[k]), float(jval[k]), rtol=1e-5, err_msg=k)


# --- the trainer and its command line ---------------------------------------

S, DIM, NV = 32, 32, 12


def overrides(root, extra=()):
    return [
        "experiment=p2p_image",
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
        "experiment.model.decoder.num_layers=1",
        "experiment.model.decoder.num_heads=4",
        f"experiment.model.tokenizer.max_num_vertices={NV}",
        "experiment.model.sinkhorn_iterations=5",
        *extra,
    ]


@pytest.fixture()
def tiny_vit(monkeypatch):
    """The config tree fixes the ViT's depth and heads; shrink them."""
    full = factory.encoder_config
    monkeypatch.setattr(factory, "encoder_config", lambda cfg: {**full(cfg), "depth": 1, "num_heads": 2})


def test_trainer_end_to_end_and_resume(tiny_vit, tmp_path):
    """Two epochs (tests/test_train_integration.py's twin): the losses, the
    val IoU of the second epoch, `latest` and `best_val_loss`, the run log,
    and a resume from `latest` at epoch 2 that changes nothing."""
    cfg = compose(overrides(tmp_path))
    trainer = Pix2PolyTrainer(cfg, device="cpu")
    history = trainer.train()
    assert history["epoch"] == 1
    assert set(history) == {"epoch", "val_iou"} | {p + k for p in ("", "val_") for k in ("loss", "vertex_loss", "perm_loss")}
    assert all(np.isfinite(v) for v in history.values())
    assert 0.0 <= history["val_iou"] <= 1.0
    assert trainer._predictor.model is trainer.state.model
    assert trainer.state.step == 4 and trainer.state.scheduler.last_epoch == 4
    assert trainer.manager.exists("latest") and trainer.manager.exists("best_val_loss")
    with open(os.path.join(cfg.output_dir, "runs", f"{cfg.experiment.name}.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["_type"] for r in records] == ["config", "metrics", "metrics"]
    assert "val_iou" not in records[1] and records[2]["val_iou"] == pytest.approx(history["val_iou"])

    cfg2 = copy.deepcopy(cfg)
    cfg2.checkpoint = "latest"
    resumed = Pix2PolyTrainer(cfg2, device="cpu")
    resumed.train()
    assert resumed.start_epoch == 2 and resumed.state.step == 4
    want = trainer.state.model.state_dict()
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert resumed.best["val_loss"] == pytest.approx(trainer.best["val_loss"])


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pix2PolyTrainer(compose(overrides(tmp_path)))


def test_pretrained_encoder_refused(tiny_vit, tmp_path):
    """A configured ViT checkpoint is refused, naming its ROADMAP item, not skipped."""
    cfg = compose(overrides(tmp_path, ["experiment.encoder.pretrained=true",
                                       f"experiment.encoder.checkpoint_file={tmp_path}/vit.pth"]))
    with pytest.raises(NotImplementedError, match="ROADMAP 'Port queue' item 'Pretrained encoders'"):
        Pix2PolyTrainer(cfg, device="cpu").train()


def test_cli_trains_pix2poly_at_bfloat16_on_cpu(tiny_vit, tmp_path):
    """`host.compute_dtype=bfloat16` through the command line: the model
    computes in bfloat16 (float32 parameters), and so does its val IoU.
    (At float32: tests/test_torch_trainer.py::test_cli_other_models_not_ported.)"""
    history = cli_train.main(overrides(tmp_path, ["host.compute_dtype=bfloat16", "experiment.model.num_epochs=1",
                                                  "device=cpu"]))
    assert history["epoch"] == 0 and np.isfinite(history["loss"]) and 0.0 <= history["val_iou"] <= 1.0
    cfg = compose(overrides(tmp_path, ["host.compute_dtype=bfloat16"]))
    weights = CheckpointManager(cfg.output_dir).restore("latest")["model"]
    assert all(v.dtype == torch.float32 for v in weights.values() if v.is_floating_point())
