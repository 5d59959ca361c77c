"""The training trajectory over several epochs, the port's trainers against
the JAX package's on the CPU at float32: FFL-image (the tiny ViT of
tests/test_torch_train_ffl.py: 32 px, patch 8, dim 32, depth 1, 2 heads)
and HiSup-image (the tiny HRNet of tests/test_torch_trainer.py: width 4,
one module a stage, 32 px, head width 16), each trained end to end by its
package's `Trainer.train` on the same synthetic tiles.

Set-up: `run_type=release` with 0 loader threads (the train split is
shuffled by `RandomState(seed + epoch)`, every batch built in the test's
thread), 4 train tiles at batch 2 (2 steps an epoch), 4 epochs,
`training.val_every=1` (a val IoU every epoch, so the best-IoU policy
decides 4 times); for FFL `loss.multi.epoch_thresholds=[0,1,3]`, so that
the interior-crossfield weight is off (epochs 0 and 1), on its ramp
(epoch 2) and full (epoch 3). JAX's mesh is one CPU device. JAX's initial
weights are its own (FFL: flax's init, compiled whole; HiSup: drawn from a
numpy seed in init's shapes, since the HRNet's eager init compiles op by
op for 15 s); the port's are JAX's, bridged (`utils/bridge.py`) where each
trainer's set-up grafts pretrained encoders. Everything after that is each
trainer's own: schedule, epoch weights, loaders, steps, val pass and
checkpoint policy. A third run, the port's from JAX's weights scaled by
1 + 1e-6, is the control: how far the trajectory moves under a rounding-
sized change.

Compared, epoch by epoch, from each run's metrics log (`runs/*.jsonl`) and
from what each trainer passed to its steps and checkpoint manager:
- each epoch's tile order (the train loader's batches): equal;
- FFL's loss weights at each step: equal as float32 (JAX passes float32
  scalars, the port Python floats that meet float32 tensors);
- the LR at each step, the port's read from its optimizer before the step,
  JAX's the trainer's optax schedule at the step's count: within 1e-7 of
  the base LR (optax evaluates the cosine in float32, so near the
  schedule's end its value is 1.2e-6 relative off; measured 4.7e-12
  absolute, 4.7e-8 of the base LR), and the port's equal to the float64
  cosine to 1e-12 relative;
- the first step's losses, from equal weights on equal batches: 1e-5
  relative (measured ≤ 7.2e-6);
- every loss term and the val loss of each epoch: the largest relative
  difference over the terms within 10 times the control's at that epoch
  (+1e-5), and never above 5e-2. After the first update Adam moves each
  element by about lr·sign(g); where |g| is rounding noise the two sides
  move it apart by up to 2·lr (tests/test_torch_train_ffl.py), and the
  trajectory is chaotic at this scale: measured FFL ≤ 3.9e-4 against the
  control's 3.0e-4 to 7.5e-4, HiSup ≤ 1.8e-2 against the control's
  1.5e-2 at the same epoch (torch's one-thread CPU convolution sums each
  weight gradient in one float32 chain, ROADMAP 3.16);
- the val IoU of each epoch: within 10 times the control's largest
  difference over the run (+1e-6). Measured: FFL equal (0.1387 every
  epoch on both, the young seg head polygonizing every tile), HiSup ≤
  5.7e-3 against the control's 3.7e-3;
- the epochs at which `best_val_iou` and `best_val_loss` were written:
  the port's equal to where JAX's `save_best_and_latest` writes on the
  port's own metrics, and equal to the JAX run's wherever JAX's decision
  was no near-tie (its margin above twice the largest difference between
  the two runs' metric up to that epoch). Measured: equal on every epoch
  for FFL; for HiSup the port also wrote `best_val_iou` at epoch 3 (0.1642
  over 0.1638) where JAX did not (0.1585 under 0.1682), a near-tie.

One process runs the file in about a minute, 40 s of it JAX's compiles.
"""

import json
import math
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
from flax import linen as nn
import numpy as np
import pytest
import torch

import pixelspointspolygons_tpu.models.hisup.factory as jax_hisup_factory
import pixelspointspolygons_tpu.train.trainer as jax_trainer_base
import pixelspointspolygons_tpu.train.trainer_ffl as jax_trainer_ffl
import pixelspointspolygons_tpu.train.trainer_hisup as jax_trainer_hisup
import pixelspointspolygons_tpu.utils.pretrained as jax_pretrained
from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.data import loader as jax_loader
from pixelspointspolygons_tpu.models.ffl import FFL as JaxFFL
from pixelspointspolygons_tpu.models.hisup.model import HiSup as JaxHiSup
from pixelspointspolygons_tpu.parallel import make_mesh
from pixelspointspolygons_tpu.utils import checkpoint as jax_checkpoint
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data import loader as port_loader
from pixelspointspolygons_torch.models.ffl import model as port_ffl_model
from pixelspointspolygons_torch.models.hisup import factory as port_hisup_factory
from pixelspointspolygons_torch.train import trainer_ffl as port_trainer_ffl
from pixelspointspolygons_torch.train import trainer_hisup as port_trainer_hisup
from pixelspointspolygons_torch.utils import checkpoint as port_checkpoint
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_ffl import _random_variables, one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_trainer import TOPO

EPOCHS, STEPS = 4, 2
LR_TOL = 1e-7
FIRST_STEP_RTOL = 1e-5
NUDGE, NOISE_FACTOR = 1e-6, 10.0
LOSS_FLOOR, LOSS_CEILING = 1e-5, 5e-2
IOU_FLOOR = 1e-6
TINY_VIT = {"depth": 1, "num_heads": 2}
FAMILIES = ("ffl", "hisup")
SEED = 3


def overrides(family: str, root) -> list[str]:
    common = [
        "dataset=synthetic",
        "run_type=release",
        "run_type.num_workers=0",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.num_train=4",
        "experiment.dataset.num_val=2",
        "experiment.dataset.num_test=2",
        "experiment.model.batch_size=2",
        f"experiment.model.num_epochs={EPOCHS}",
        "training.val_every=1",
        "training.save_every=0",
        "experiment.encoder.in_size=32",
    ]
    if family == "ffl":
        return ["experiment=ffl_image", *common, "experiment.encoder.patch_feature_dim=32",
                "experiment.model.decoder.in_feature_dim=32", "experiment.polygonization.acm_method.steps=20",
                "experiment.model.loss.multi.epoch_thresholds=[0,1,3]"]
    return ["experiment=hisup_image", *common, "experiment.model.decoder.in_feature_size=32",
            "experiment.model.decoder.in_feature_dim=16"]


def _recorder(mp, record: dict, trainer_cls, loader_cls, manager_cls, lr_of, write: bool = True) -> None:
    """Record what a trainer does: the train loader's tiles per epoch, each
    train step's LR (`lr_of(trainer, state)`) and extra arguments, the first
    step's metrics, and the epochs at which each checkpoint was saved
    (written only with `write`)."""
    def make_batch(self, idxs, run=loader_cls._make_batch):
        if self.dataset.split == "train":
            record["tiles"].setdefault(self.epoch, []).extend(int(i) for i in idxs)
        return run(self, idxs)

    def save(self, name, state, epoch, *args, run=manager_cls.save, **kw):
        record["saved"].setdefault(name, []).append(int(epoch))
        if write:
            run(self, name, state, epoch, *args, **kw)

    def setup(self, run=trainer_cls.setup):
        run(self)
        step = self._train_step

        def recorded(state, batch, *args):
            record["lrs"].append(lr_of(self, state))
            if args:
                record["weights"].append({k: float(v) for k, v in args[0].items()})
            out = step(state, batch, *args)
            if "first" not in record:
                metrics = out[1] if isinstance(out, tuple) else out
                record["first"] = {k: float(v) for k, v in metrics.items()}
            return out

        self._train_step = recorded

    mp.setattr(loader_cls, "_make_batch", make_batch)
    mp.setattr(manager_cls, "save", save)
    mp.setattr(trainer_cls, "setup", setup)


def _metrics_log(cfg) -> list[dict]:
    with open(os.path.join(cfg.output_dir, "runs", f"{cfg.experiment.name}.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [r for r in records if r["_type"] == "metrics"]


def _new_record() -> dict:
    return {"tiles": {}, "lrs": [], "weights": [], "saved": {}}


def _port_run(family: str, root, variables: dict, nudge: float = 0.0) -> dict:
    """The port's trainer from the bridged `variables`, each floating-point
    tensor scaled by (1 + `nudge`)."""
    module = port_trainer_ffl if family == "ffl" else port_trainer_hisup
    cls = module.FFLTrainer if family == "ffl" else module.HiSupTrainer

    def bridged(cfg, model, logger):
        sd = flax_to_state_dict(variables["params"], variables.get("batch_stats"))
        model.load_state_dict({k: v * (1 + nudge) if v.is_floating_point() else v for k, v in sd.items()},
                              strict=True)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "apply_pretrained_encoder", bridged)
        rec = _new_record()
        _recorder(mp, rec, cls, port_loader.Loader, port_checkpoint.CheckpointManager,
                  lambda t, state: float(state.optimizer.param_groups[0]["lr"]))
        cfg = compose(overrides(family, root))
        trainer = cls(cfg, device="cpu")
        trainer.train()
    rec["log"] = _metrics_log(cfg)
    rec["total_steps"] = trainer.steps_per_epoch() * EPOCHS
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each family trained by JAX's trainer, by the port's from the same
    initial weights, and by the port's from those weights nudged by NUDGE
    (the control): {family: (jax, port, nudged)}, each a record of
    `_recorder` with the run's metrics log."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "wandb", None)  # the release run type logs locally, never to wandb
        mp.setattr(jax_trainer_base, "make_mesh", lambda: make_mesh(1))
        # FFL's flax init compiled whole (its seg head starts at 0.5: the val pass polygonizes
        # every tile); HiSup's drawn in init's shapes from a numpy seed (the HRNet's init, op by
        # op, takes 15 s)
        mp.setattr(JaxFFL, "init", lambda self, rng, x: jax.jit(lambda r, v: nn.Module.init(self, r, v))(rng, x))
        mp.setattr(JaxHiSup, "init", lambda self, rng, x: _random_variables(
            SimpleNamespace(init=lambda r, v, self=self: nn.Module.init(self, r, v)), x, SEED))
        build_ffl = jax_trainer_ffl.build_ffl
        mp.setattr(jax_trainer_ffl, "build_ffl", lambda cfg, dtype=jnp.float32: build_ffl(cfg, dtype).clone(
            encoder_cfg={**build_ffl(cfg, dtype).encoder_cfg, **TINY_VIT}))
        port_enc = port_ffl_model.encoder_config
        mp.setattr(port_ffl_model, "encoder_config", lambda cfg: {**port_enc(cfg), **TINY_VIT})
        jax_enc = jax_hisup_factory.encoder_config
        mp.setattr(jax_hisup_factory, "encoder_config", lambda cfg: {**jax_enc(cfg), **TOPO})
        port_hisup_enc = port_hisup_factory.encoder_config
        mp.setattr(port_hisup_factory, "encoder_config", lambda cfg: {**port_hisup_enc(cfg), **TOPO})
        initial = {}
        graft = jax_pretrained.apply_pretrained_encoder

        def keep_initial(cfg, variables, logger):
            variables = graft(cfg, variables, logger)
            initial["variables"] = jax.device_get(variables)
            return variables

        mp.setattr(jax_pretrained, "apply_pretrained_encoder", keep_initial)
        schedules = {}
        for family, jax_cls in (("ffl", jax_trainer_ffl.FFLTrainer), ("hisup", jax_trainer_hisup.HiSupTrainer)):
            root = tmp_path_factory.mktemp(f"epochs_{family}")
            jax_module = sys.modules[jax_cls.__module__]

            def kept_schedule(base_lr, total_steps, *a, run=jax_module.cosine_with_warmup, family=family):
                schedules[family] = run(base_lr, total_steps, *a)
                return schedules[family]

            with pytest.MonkeyPatch.context() as inner:
                inner.setattr(jax_module, "cosine_with_warmup", kept_schedule)
                jax_rec = _new_record()
                _recorder(inner, jax_rec, jax_cls, jax_loader.Loader, jax_checkpoint.CheckpointManager,
                          lambda t, state, family=family: float(schedules[family](int(state.step))), write=False)
                jcfg = jax_compose(overrides(family, root / "jax"))
                jax_cls(jcfg).train()
            jax_rec["log"] = _metrics_log(jcfg)
            out[family] = (jax_rec, _port_run(family, root / "port", initial["variables"]),
                           _port_run(family, root / "nudged", initial["variables"], NUDGE))
    return out


def _gaps(a: list[dict], b: list[dict], keys: set) -> list[float]:
    """Per epoch, the largest relative difference over `keys` between two
    metrics logs."""
    return [max(abs(y[k] - x[k]) / max(abs(x[k]), 1e-12) for k in keys) for x, y in zip(a, b)]


def _loss_keys(log: list[dict]) -> set:
    return {k for k in log[0] if k not in ("_type", "step", "t", "epoch", "val_iou")}


@pytest.mark.parametrize("family", FAMILIES)
def test_each_epoch_trains_on_the_same_tiles(runs, family):
    jax_rec, port_rec, _ = runs[family]
    assert sorted(port_rec["tiles"]) == list(range(EPOCHS))
    assert port_rec["tiles"] == jax_rec["tiles"]
    orders = [tuple(port_rec["tiles"][e]) for e in range(EPOCHS)]
    assert all(sorted(o) == [0, 1, 2, 3] for o in orders) and len(set(orders)) > 1  # shuffled, and anew each epoch


@pytest.mark.parametrize("family", FAMILIES)
def test_each_step_uses_the_same_learning_rate(runs, family):
    jax_rec, port_rec, _ = runs[family]
    base_lr = port_rec["lrs"][0]
    assert len(port_rec["lrs"]) == len(jax_rec["lrs"]) == port_rec["total_steps"] == EPOCHS * STEPS
    np.testing.assert_allclose(port_rec["lrs"], jax_rec["lrs"], rtol=0, atol=LR_TOL * base_lr)
    exact = [base_lr * 0.5 * (1 + math.cos(math.pi * n / (EPOCHS * STEPS))) for n in range(EPOCHS * STEPS)]
    np.testing.assert_allclose(port_rec["lrs"], exact, rtol=1e-12)
    assert base_lr == 1e-4


def test_ffl_steps_use_the_same_loss_weights(runs):
    jax_rec, port_rec, _ = runs["ffl"]
    # JAX passes float32 scalars, the port Python floats that meet float32 tensors: equal as float32
    as_f32 = [{k: np.float32(v) for k, v in w.items()} for w in port_rec["weights"]]
    assert as_f32 == [{k: np.float32(v) for k, v in w.items()} for w in jax_rec["weights"]]
    assert len(as_f32) == EPOCHS * STEPS
    interior = [w["seg_interior_crossfield"] for w in port_rec["weights"][::STEPS]]
    assert interior == pytest.approx([0.0, 0.0, 0.1, 0.2])  # off, on the ramp's start, halfway up, full


@pytest.mark.parametrize("family", FAMILIES)
def test_the_first_step_matches(runs, family):
    jax_rec, port_rec, _ = runs[family]
    assert set(port_rec["first"]) == set(jax_rec["first"]) and len(jax_rec["first"]) >= 6
    for k, want in jax_rec["first"].items():
        np.testing.assert_allclose(port_rec["first"][k], want, rtol=FIRST_STEP_RTOL, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_epochs_losses_match(runs, family):
    jax_rec, port_rec, nudged = runs[family]
    jlog, plog = jax_rec["log"], port_rec["log"]
    assert [r["epoch"] for r in plog] == [r["epoch"] for r in jlog] == list(range(EPOCHS))
    keys = _loss_keys(jlog)
    assert keys == _loss_keys(plog) and {"loss", "val_loss"} <= keys and len(keys) >= 12
    assert all(np.isfinite(r[k]) for r in plog for k in keys)
    gap, spread = _gaps(jlog, plog, keys), _gaps(plog, nudged["log"], keys)
    for e in range(EPOCHS):
        assert gap[e] <= min(NOISE_FACTOR * spread[e] + LOSS_FLOOR, LOSS_CEILING), (e, gap, spread)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_epochs_val_iou_matches(runs, family):
    jax_rec, port_rec, nudged = runs[family]
    got, want, ctrl = ([r["val_iou"] for r in rec["log"]] for rec in (port_rec, jax_rec, nudged))
    assert len(got) == EPOCHS and all(0.0 <= v <= 1.0 for v in got)
    spread = max(abs(g - c) for g, c in zip(got, ctrl))
    for e in range(EPOCHS):
        assert abs(got[e] - want[e]) <= NOISE_FACTOR * spread + IOU_FLOOR, (e, got, want, ctrl)


def _decisions(log: list[dict], key: str, initial: float, larger: bool) -> list[tuple[bool, float]]:
    """Whether each epoch beats the best so far on `key`, and by how much."""
    best, out = initial, []
    for r in log:
        margin = (r[key] - best) if larger else (best - r[key])
        out.append((margin > 0, abs(margin)))
        best = r[key] if margin > 0 else best
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_best_checkpoints_are_written_at_the_same_epochs(runs, family):
    """The port writes `best_val_iou` and `best_val_loss` where JAX's policy
    would on the port's own metrics, and at JAX's epochs wherever JAX's
    decision was no near-tie (its margin above twice the largest gap
    between the two runs' metric up to that epoch)."""
    jax_rec, port_rec, _ = runs[family]
    cfg = compose(overrides(family, "unused"))
    replay = {}
    manager = SimpleNamespace(save=lambda name, state, epoch, *a: replay.setdefault(name, []).append(epoch))
    best = {"val_loss": float(cfg.training.best_val_loss), "val_iou": float(cfg.training.best_val_iou)}
    for r in port_rec["log"]:
        best = jax_checkpoint.save_best_and_latest(manager, None, int(r["epoch"]), cfg, r["val_loss"], r["val_iou"],
                                                   best, save_every=0)
    assert port_rec["saved"] == replay and replay["latest"] == list(range(EPOCHS))
    for key, name, initial, larger in (("val_iou", "best_val_iou", cfg.training.best_val_iou, True),
                                       ("val_loss", "best_val_loss", cfg.training.best_val_loss, False)):
        jd = _decisions(jax_rec["log"], key, float(initial), larger)
        pd = _decisions(port_rec["log"], key, float(initial), larger)
        gap = np.maximum.accumulate([abs(p[key] - j[key]) for p, j in zip(port_rec["log"], jax_rec["log"])])
        decisive = [e for e in range(EPOCHS) if jd[e][1] > 2 * gap[e]]
        assert [pd[e][0] for e in decisive] == [jd[e][0] for e in decisive], (name, jd, pd)
        assert [e for e, (w, _) in enumerate(jd) if w] == jax_rec["saved"].get(name, [])
    assert 0 in port_rec["saved"]["best_val_loss"]
