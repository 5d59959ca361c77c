"""HiSup trainer: AdamW + cosine schedule, 5-term weighted loss, val-epoch IoU
through the full polygonization path — port of
pixelspointspolygons_tpu/train/trainer_hisup.py (reference
train/trainer_hisup.py:31-63).

Batches reach the device one step ahead, from pinned memory
(`data.loader.device_prefetch`). The model computes in
`host.compute_dtype` (float32 or bfloat16) with float32 parameters; the
targets, the losses and AdamW's update stay float32. A configured HRNet
checkpoint is grafted in right after the model is built
(`utils/pretrained.py`), before a resume or warm start.
"""

from __future__ import annotations

import torch

from ..data.loader import INPUT_KEYS, build_loader, device_prefetch
from ..eval.metrics import compute_iou_ciou
from ..models.hisup.factory import build_hisup
from ..parallel import all_gather_objects
from ..predict.predictor_hisup import HiSupPredictor, batch_annotations
from ..utils.coco import CocoIndex
from ..utils.pretrained import apply_pretrained_encoder
from .hisup_step import make_train_step, make_val_step
from .state import TrainState, compute_dtype, cosine_with_warmup, make_optimizer, make_scheduler, num_params
from .trainer import Trainer

# batch leaves the steps consume on the device
_DEV_KEYS = INPUT_KEYS + ("junctions", "junc_tags", "junc_valid", "edges", "edges_valid", "mask")


class HiSupTrainer(Trainer):
    def setup(self) -> None:
        cfg = self.cfg
        m = cfg.experiment.model
        self.train_loader = build_loader(cfg, "train")
        self.val_loader = build_loader(cfg, "val")

        model = build_hisup(cfg, device=self.device, generator=self.generator, dtype=compute_dtype(cfg))
        apply_pretrained_encoder(cfg, model, self.logger)
        total_steps = len(self.train_loader) * int(m.num_epochs)
        base_lr = float(m.learning_rate)
        schedule = cosine_with_warmup(base_lr, total_steps)
        optimizer = make_optimizer("adamw", model.parameters(), base_lr, weight_decay=float(m.weight_decay))
        self.state = TrainState(model, optimizer, make_scheduler(optimizer, schedule, base_lr))
        self.maybe_resume()
        self.logger.info(f"model has {num_params(model)/1e6:.2f}M params on {self.device}, "
                         f"computing in {model.compute_dtype}")

        weights = {k: float(v) for k, v in m.loss_weights.items()}
        size = int(m.decoder.in_feature_size)
        self._train_step = make_train_step(weights, size)
        self._val_step = make_val_step(weights, size)

        # the val IoU's predictor shares the model; as in the JAX trainer
        # (trainer_hisup.py:97-116) remask stays float32 and the junctions
        # and simplification take extract_junctions' and the polygonizer's
        # defaults, not the config's eval block
        self._predictor = HiSupPredictor(cfg, device=self.device, model=model)
        self._predictor.remask_dtype = torch.float32
        self._predictor.junc_topk, self._predictor.junc_threshold = 300, 0.008
        self._predictor.dp_tolerance = 1.0

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

    def predict_and_eval(self, epoch: int) -> float:
        """Polygonize the val split and return its IoU (JAX :143-163)."""
        predictions: list[dict] = []
        for batch in self.val_loader:
            predictions.extend(batch_annotations(batch, *self._predictor.predict_batch(batch)))
        gathered = [p for chunk in all_gather_objects(predictions) for p in chunk]
        gt = CocoIndex(self.cfg.experiment.dataset.annotations["val"])
        results = compute_iou_ciou(gt, gt.load_res(gathered))
        self.logger.info(f"epoch {epoch} val IoU={results['IoU']:.4f} C-IoU={results['C-IoU']:.4f}")
        return float(results["IoU"])
