"""Base trainer — port of pixelspointspolygons_tpu/train/trainer.py: the
template method of reference train/trainer.py:22-220 (seed → model →
loaders → optimizer → train_val_loop → checkpoints) on one device.

Float32 runs as float32: TF32 is off for matmuls and cuDNN convolutions
(the JAX package's host.compute_dtype=float32).

`checkpoint=<name>` resumes a run (weights, optimizer, schedule, epoch);
without it, `init_weights_from=<file>` warm-starts from the weights of
another run's checkpoint, as the JAX trainer does (trainer.py:91-121).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config.engine import Config
from ..device import check_compute_dtype, resolve_device, set_tf32
from ..utils.checkpoint import CheckpointManager, save_best_and_latest, smart_restore_params
from ..utils.logger import make_logger
from ..utils.seeding import seed_everything


def check_supported(cfg: Config) -> None:
    """Raise on the options this slice of the port does not run yet."""
    dc = str(cfg.training.get("device_cache") or "false").lower()
    if dc in ("auto", "true", "1"):
        raise NotImplementedError("training.device_cache: ROADMAP 'Port queue' item 'Device cache'")
    if bool(cfg.training.get("remat") or False):
        raise NotImplementedError("training.remat: ROADMAP 'Port queue' item 'Activation recomputation'")
    check_compute_dtype(cfg)


class Trainer:
    def __init__(self, cfg: Config, device: str | torch.device | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        set_tf32(False)
        self.logger = make_logger(self.__class__.__name__)
        self.manager = CheckpointManager(cfg.output_dir)
        self.best = {
            "val_loss": float(cfg.training.best_val_loss),
            "val_iou": float(cfg.training.best_val_iou),
        }
        self.start_epoch = int(cfg.experiment.model.start_epoch)

    # subclasses implement: setup / train_one_epoch / val_one_epoch /
    # predict_and_eval

    def train(self) -> dict:
        from ..utils.experiment_log import RunLogger

        seed = int(self.cfg.get("seed", 42))
        seed_everything(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.setup()
        self.run_logger = RunLogger(self.cfg)
        num_epochs = int(self.cfg.experiment.model.num_epochs)
        val_every = int(self.cfg.training.val_every)
        history = {}
        for epoch in range(self.start_epoch, num_epochs):
            t0 = time.time()
            train_metrics = self.train_one_epoch(epoch)
            val_metrics = self.val_one_epoch(epoch)
            val_iou = None
            if (epoch + 1) % val_every == 0 or epoch == num_epochs - 1:
                val_iou = self.predict_and_eval(epoch)
            self.best = save_best_and_latest(
                self.manager,
                self.state,
                epoch,
                self.cfg,
                val_metrics.get("loss", np.inf),
                val_iou,
                self.best,
                save_every=int(self.cfg.training.save_every),
            )
            dt = time.time() - t0
            msg = " ".join(
                f"{k}={v:.4f}"
                for k, v in {**train_metrics, **{f"val_{k}": v for k, v in val_metrics.items()}}.items()
            )
            if val_iou is not None:
                msg += f" val_iou={val_iou:.4f}"
            self.logger.info(f"epoch {epoch}: {msg} ({dt:.1f}s)")
            history = {"epoch": epoch, **train_metrics}
            history.update({f"val_{k}": v for k, v in val_metrics.items()})
            if val_iou is not None:
                history["val_iou"] = val_iou
            self.run_logger.log(history, step=epoch)
        self.run_logger.finish()
        return history

    def maybe_resume(self) -> None:
        name = self.cfg.get("checkpoint")
        if not name:
            self._maybe_warm_start()
            return
        payload = self.manager.restore(name, map_location=self.device)
        self.manager.check_modality_compat(payload.get("cfg"), self.cfg)
        self.state.load_state_dict(payload)
        self.start_epoch = int(payload["epoch"]) + 1
        self.best["val_loss"] = float(payload.get("best_val_loss", self.best["val_loss"]))
        self.best["val_iou"] = float(payload.get("best_val_iou", self.best["val_iou"]))
        self.logger.info(f"resumed from {name!r} at epoch {self.start_epoch}")

    def _maybe_warm_start(self) -> None:
        """Weights only from `init_weights_from`, a checkpoint file that the
        port's `CheckpointManager` wrote (`<output_dir>/checkpoints/<name>.pt`):
        parameters and BatchNorm statistics grafted by name and shape
        (`smart_restore_params`; tensors without a match keep their init),
        while the optimizer, the schedule and the epoch start afresh."""
        src = self.cfg.get("init_weights_from")
        if not src:
            return
        path = os.path.abspath(str(src))
        if os.path.isdir(path):
            raise ValueError(
                f"init_weights_from={path} is a directory (an orbax checkpoint of the JAX package?): the port "
                "reads only its own torch.save checkpoints, <output_dir>/checkpoints/<name>.pt"
            )
        if not os.path.isfile(path):
            raise FileNotFoundError(f"init_weights_from checkpoint not found: {path}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model = self.state.model
        model.load_state_dict(smart_restore_params(model.state_dict(), payload["model"], self.logger))
        self.logger.info(f"warm-started weights from {path} (fresh optimizer)")

    @staticmethod
    def summarize_deferred(records: list[dict]) -> dict:
        """Mean of each metric over an epoch's device-resident records, with
        one device→host copy for the whole epoch."""
        if not records:
            return {}
        keys = list(records[0])
        table = torch.stack([torch.stack([r[k].float() for k in keys]) for r in records])
        means = table.double().mean(dim=0).tolist()
        return dict(zip(keys, means))
