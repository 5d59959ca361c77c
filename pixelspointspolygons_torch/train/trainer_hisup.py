"""HiSup trainer: AdamW + cosine schedule, 5-term weighted loss — port of
pixelspointspolygons_tpu/train/trainer_hisup.py (reference
train/trainer_hisup.py:31-63).

Batches reach the device one step ahead, from pinned memory
(`data.loader.device_prefetch`). The val-epoch IoU needs the host
polygonization (cv2 contour tracing, predict/hisup_polygon.py), which comes
with the predictor slice; until then `predict_and_eval` returns None.
"""

from __future__ import annotations

from ..data.loader import build_loader, device_prefetch
from ..models.hisup.factory import build_hisup
from .hisup_step import make_train_step, make_val_step
from .state import TrainState, cosine_with_warmup, make_optimizer, make_scheduler, num_params
from .trainer import Trainer

# batch leaves the steps consume on the device
_DEV_KEYS = ("images", "junctions", "junc_tags", "junc_valid", "edges", "edges_valid", "mask")


class HiSupTrainer(Trainer):
    def setup(self) -> None:
        cfg = self.cfg
        m = cfg.experiment.model
        self.train_loader = build_loader(cfg, "train")
        self.val_loader = build_loader(cfg, "val")

        model = build_hisup(cfg, device=self.device, generator=self.generator)
        total_steps = len(self.train_loader) * int(m.num_epochs)
        base_lr = float(m.learning_rate)
        schedule = cosine_with_warmup(base_lr, total_steps)
        optimizer = make_optimizer("adamw", model.parameters(), base_lr, weight_decay=float(m.weight_decay))
        self.state = TrainState(model, optimizer, make_scheduler(optimizer, schedule, base_lr))
        self.maybe_resume()
        self.logger.info(f"model has {num_params(model)/1e6:.2f}M params on {self.device}")

        weights = {k: float(v) for k, v in m.loss_weights.items()}
        size = int(m.decoder.in_feature_size)
        self._train_step = make_train_step(weights, size)
        self._val_step = make_val_step(weights, size)
        self._iou_note_logged = False

    def train_one_epoch(self, epoch: int) -> dict:
        self.train_loader.set_epoch(epoch)
        records = [
            self._train_step(self.state, batch)
            for batch in device_prefetch(self.train_loader, self.device, _DEV_KEYS)
        ]
        return self.summarize_deferred(records)

    def val_one_epoch(self, epoch: int) -> dict:
        records = [
            self._val_step(self.state, batch)
            for batch in device_prefetch(self.val_loader, self.device, _DEV_KEYS)
        ]
        return self.summarize_deferred(records)

    def predict_and_eval(self, epoch: int) -> None:
        """Val IoU needs the HiSup predictor (junction extraction and
        cv2-free polygonization), which is not ported yet: no IoU is
        computed, and best_val_iou is never saved."""
        if not self._iou_note_logged:
            self.logger.warning(
                "val IoU is not ported yet (ROADMAP 'Port queue' item 'HiSup predictor'); "
                "best_val_iou checkpoints are skipped"
            )
            self._iou_note_logged = True
        return None
