"""Base trainer — port of pixelspointspolygons_tpu/train/trainer.py: the
template method of reference train/trainer.py:22-220 (seed → model →
loaders → optimizer → train_val_loop → checkpoints) on one device.

Float32 runs as float32: TF32 is off for matmuls and cuDNN convolutions
(the JAX package's host.compute_dtype=float32).

`checkpoint=<name>` resumes a run (weights, optimizer, schedule, epoch);
without it, `init_weights_from=<file>` warm-starts from the weights of
another run's checkpoint, as the JAX trainer does (trainer.py:91-121).

`training.device_cache` (`auto`, `true`) trains and validates from a split
held on the device (`data/device_cache.py`), with JAX's fallbacks: `auto`
takes the host loader when the cache cannot serve the config, `true` only
when the split would not fit; the val-IoU pass keeps the host loader.

Under a process group (`parallel.init_distributed`, started by the CLIs)
each process trains on its shard of every global batch (`batch_size` is
per process): each trainer wraps its model in DDP after the build, the
grafts and any resume or warm start (`TrainState.wrap`); the epoch
metrics are means over every process's steps; the cache serves one
process only, so `auto` takes the host loader and `true` raises; the
checkpoints and the run log are rank 0's; `train` ends at a barrier.
"""

from __future__ import annotations

import os
import time
from typing import Iterator

import numpy as np
import torch

from ..config.engine import Config
from ..data.device_cache import CacheFitError
from ..data.loader import device_prefetch
from ..device import resolve_device, set_tf32
from ..parallel import all_reduce_mean, sync_processes
from ..utils.checkpoint import CheckpointManager, save_best_and_latest, smart_restore_params
from ..utils.logger import make_logger
from ..utils.seeding import seed_everything


def check_supported(cfg: Config) -> None:
    """Raise on the options this slice of the port does not run yet (none
    of the training block's since `training.device_cache` and
    `training.remat` were ported)."""


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
        self.cache = None  # the device cache's {"train", "val"}, set up by `make_device_caches`

    # subclasses implement: setup / train_one_epoch / val_one_epoch /
    # predict_and_eval

    def make_device_caches(self, build) -> dict | None:
        """{"train": build("train"), "val": build("val")} under
        `training.device_cache` (auto, true), else None (JAX
        trainer_*.py set-up): `auto` falls back to the host loader on
        NotImplementedError or ValueError, `true` only on CacheFitError."""
        dc = str(self.cfg.training.get("device_cache") or "false").lower()
        if dc not in ("auto", "true", "1"):
            return None
        try:
            return {"train": build("train"), "val": build("val")}
        except (NotImplementedError, ValueError) as e:
            if dc != "auto" and not isinstance(e, CacheFitError):
                raise
            self.logger.warning(f"device cache unavailable ({e}); host loader")
            return None

    def epoch_batches(self, split: str, epoch: int, keys: tuple) -> Iterator[dict]:
        """The `keys` leaves of one epoch's batches on the device: from the
        device cache when there is one, else from the host loader one batch
        ahead (`device_prefetch`)."""
        if self.cache:
            return ({k: b[k] for k in keys if k in b} for b in self.cache[split].epoch_batches(epoch))
        if split == "val":
            return device_prefetch(self.val_loader, self.device, keys)
        self.train_loader.set_epoch(epoch)
        return device_prefetch(self.train_loader, self.device, keys)

    def steps_per_epoch(self) -> int:
        """Train steps per epoch, for the schedule: the cache's when there is
        one (it drops the last partial batch; the host loader pads it)."""
        return len(self.cache["train"]) if self.cache else len(self.train_loader)

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
        sync_processes("p3_train_end")
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
        """Mean of each metric over an epoch's device-resident records and
        over every process (each runs as many steps), with one all-reduce
        and one device→host copy for the whole epoch."""
        if not records:
            return {}
        keys = list(records[0])
        table = torch.stack([torch.stack([r[k].float() for k in keys]) for r in records])
        means = all_reduce_mean(table.double().mean(dim=0)).tolist()
        return dict(zip(keys, means))
