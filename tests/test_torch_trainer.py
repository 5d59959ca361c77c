"""The port's HiSup trainer end to end on the CPU at a tiny size (HRNet width
4, one module per stage, 32 px, head width 16, batch 2): epoch loop, deferred
metrics, val IoU, checkpoint policy, run log, resume, and the command-line
entry."""

import copy
import json
import os
import re

import numpy as np
import pytest
import torch

from pixelspointspolygons_torch.cli import train as cli_train
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.models.hisup import factory
from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler
from pixelspointspolygons_torch.train.trainer import check_supported
from pixelspointspolygons_torch.train.trainer_hisup import HiSupTrainer
from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager, save_best_and_latest

TOPO = dict(width=4, stage1_planes=4, stage1_blocks=1, num_blocks=1, num_modules=(1, 1, 1), stem_ch=8)


def _overrides(root, extra=()):
    return [
        "experiment=hisup_image",
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
        "experiment.model.num_epochs=1",
        "training.save_every=0",
        "experiment.encoder.in_size=32",
        "experiment.model.decoder.in_feature_size=32",
        "experiment.model.decoder.in_feature_dim=16",
        *extra,
    ]


@pytest.fixture()
def tiny_hrnet(monkeypatch):
    """The config tree sizes HRNet only by `in_size`; shrink its widths."""
    full = factory.encoder_config
    monkeypatch.setattr(factory, "encoder_config", lambda cfg: {**full(cfg), **TOPO})


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.state.model.state_dict().items()}


def test_trainer_end_to_end_and_resume(tiny_hrnet, tmp_path):
    cfg = compose(_overrides(tmp_path))
    trainer = HiSupTrainer(cfg, device="cpu")
    history = trainer.train()
    assert history["epoch"] == 0
    assert set(history) == {"epoch", "val_iou"} | {p + k for p in ("", "val_") for k in (
        "loss", "loss_jloc", "loss_joff", "loss_mask", "loss_afm", "loss_remask")}
    assert all(np.isfinite(v) for v in history.values())
    assert isinstance(history["val_iou"], float) and 0.0 <= history["val_iou"] <= 1.0
    assert trainer.state.step == 2 and trainer.state.scheduler.last_epoch == 2
    assert trainer.manager.exists("latest") and trainer.manager.exists("best_val_loss")
    # best_val_iou when the IoU beats the config's initial best (0.0)
    assert trainer.manager.exists("best_val_iou") == (history["val_iou"] > 0.0)
    assert trainer.best["val_loss"] == pytest.approx(history["val_loss"])
    with open(os.path.join(cfg.output_dir, "runs", f"{cfg.experiment.name}.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["_type"] for r in records] == ["config", "metrics"]
    assert records[1]["loss"] == pytest.approx(history["loss"])

    # resume at the end of the run: nothing to train, the same state comes back
    cfg2 = copy.deepcopy(cfg)
    cfg2.checkpoint = "latest"
    resumed = HiSupTrainer(cfg2, device="cpu")
    resumed.train()
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    want = _params(trainer)
    for k, v in _params(resumed).items():
        assert torch.equal(v, want[k]), k
    assert resumed.best["val_loss"] == pytest.approx(trainer.best["val_loss"])
    assert resumed.best["val_iou"] == pytest.approx(trainer.best["val_iou"])

    # resume and train one more epoch
    cfg2.experiment.model.num_epochs = 2
    longer = HiSupTrainer(cfg2, device="cpu")
    history2 = longer.train()
    assert longer.start_epoch == 1 and history2["epoch"] == 1
    assert longer.state.step == 4 and np.isfinite(history2["loss"])
    assert any(not torch.equal(v, want[k]) for k, v in _params(longer).items())


@pytest.mark.parametrize("initial_best,written", [(-1.0, True), (1.5, False)])
def test_val_iou_and_best_val_iou(initial_best, written, tiny_hrnet, tmp_path):
    """The val pass polygonizes the val split (float32 remask) and its IoU
    reaches the history and, when it beats the initial best, the
    best_val_iou checkpoint; the pass does not touch the weights."""
    cfg = compose(_overrides(tmp_path, [f"training.best_val_iou={initial_best}"]))
    trainer = HiSupTrainer(cfg, device="cpu")
    history = trainer.train()
    assert trainer._predictor.model is trainer.state.model
    assert trainer._predictor.remask_dtype == torch.float32
    assert trainer.manager.exists("best_val_iou") == written
    if written:
        payload = trainer.manager.restore("best_val_iou")
        assert payload["best_val_iou"] == pytest.approx(history["val_iou"])
        assert trainer.best["val_iou"] == pytest.approx(history["val_iou"])
    else:
        assert trainer.best["val_iou"] == initial_best
    before = _params(trainer)
    again = trainer.predict_and_eval(epoch=0)
    assert again == history["val_iou"]
    for k, v in _params(trainer).items():
        assert torch.equal(v, before[k]), k


def test_best_and_latest_policy(tmp_path):
    """latest every epoch, best_val_loss / best_val_iou when they improve
    (an epoch without an IoU never saves best_val_iou), epoch_N every
    save_every epochs; every checkpoint carries the best metrics so far."""
    cfg = compose(_overrides(tmp_path))
    manager = CheckpointManager(str(tmp_path / "run"))
    model = torch.nn.Linear(2, 2)
    opt = make_optimizer("adamw", model.parameters(), 1e-4)
    state = TrainState(model, opt, make_scheduler(opt, lambda n: 1e-4, 1e-4))
    best = {"val_loss": 1e7, "val_iou": 0.0}
    for epoch, (loss, iou) in enumerate([(5.0, None), (7.0, 0.5), (3.0, 0.4)]):
        best = save_best_and_latest(manager, state, epoch, cfg, loss, iou, best, save_every=2)
        latest = manager.restore("latest")
        assert latest["epoch"] == epoch and latest["best_val_loss"] == best["val_loss"]
        assert latest["best_val_iou"] == best["val_iou"]
    assert best == {"val_loss": 3.0, "val_iou": 0.5}
    assert manager.restore("best_val_loss")["epoch"] == 2
    assert manager.restore("best_val_iou")["epoch"] == 1
    assert [manager.exists(f"epoch_{e}") for e in range(3)] == [True, False, True]


def test_cli_trains_hisup_on_cpu(tiny_hrnet, tmp_path):
    history = cli_train.main(_overrides(tmp_path, ["device=cpu"]))
    assert history["epoch"] == 0 and np.isfinite(history["loss"])


@pytest.mark.parametrize("experiment", ["p2p_image", "ffl_image"])
def test_cli_other_models_not_ported(experiment, tmp_path, monkeypatch):
    """Pix2Poly and FFL, each of which once raised here naming its ROADMAP
    item, train through the same entry (a tiny ViT; their parity with the
    JAX trainers is in tests/test_torch_train_pix2poly.py and
    tests/test_torch_train_ffl.py)."""
    if experiment == "ffl_image":
        from pixelspointspolygons_torch.models.ffl import model as ffl_model
        from test_torch_train_ffl import overrides as ffl_overrides

        full = ffl_model.encoder_config
        monkeypatch.setattr(ffl_model, "encoder_config", lambda cfg: {**full(cfg), "depth": 1, "num_heads": 2})
        history = cli_train.main(ffl_overrides(tmp_path, ["experiment.model.num_epochs=1", "device=cpu"]))
        assert history["epoch"] == 0 and np.isfinite(history["loss"]) and 0.0 <= history["val_iou"] <= 1.0
        return
    from pixelspointspolygons_torch.models.pix2poly import factory as p2p_factory
    from test_torch_train_pix2poly import overrides as p2p_overrides

    full = p2p_factory.encoder_config
    monkeypatch.setattr(p2p_factory, "encoder_config", lambda cfg: {**full(cfg), "depth": 1, "num_heads": 2})
    history = cli_train.main(p2p_overrides(tmp_path, ["experiment.model.num_epochs=1", "device=cpu"]))
    assert history["epoch"] == 0 and np.isfinite(history["loss"]) and 0.0 <= history["val_iou"] <= 1.0


@pytest.mark.parametrize(
    "override,item",
    [
        # the device cache and remat once named items 'Device cache' and
        # 'Activation recomputation'; both are ported
        # (tests/test_torch_device_cache.py)
        pytest.param("training.device_cache=true", None, id="training.device_cache=true-Device cache"),
        pytest.param("training.device_cache=auto", None, id="training.device_cache=auto-Device cache"),
        pytest.param("training.remat=true", None, id="training.remat=true-Activation recomputation"),
        # FFL at bfloat16 once named item 'FFL'; every family now runs at it
        # (tests/test_torch_ffl_bf16.py, test_torch_hisup_bf16.py, test_torch_bf16.py)
        pytest.param("experiment.model.name=ffl host.compute_dtype=bfloat16", None,
                     id="host.compute_dtype=bfloat16-bfloat16"),
    ],
)
def test_options_not_ported_raise(override, item, tmp_path):
    cfg = compose(_overrides(tmp_path, override.split()))
    if item is None:
        check_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match=re.escape(f"ROADMAP 'Port queue' item '{item}'")):
        check_supported(cfg)


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HiSupTrainer(compose(_overrides(tmp_path)))
