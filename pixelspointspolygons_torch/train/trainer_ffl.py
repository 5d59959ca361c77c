"""FFL trainer: Adam with a cosine schedule, the MultiLoss with
epoch-interpolated weights, a val loss per epoch and, every `val_every`
epochs, the val split polygonized by the ACM and scored — port of
pixelspointspolygons_tpu/train/trainer_ffl.py (:34-181; reference
train/trainer_ffl.py:38-59, :244-253).

Batches reach the device one step ahead, from pinned memory, with the
ground-truth maps rounded to float16 as JAX ships them
(`data.loader.device_prefetch`, `F16_KEYS`). The model computes in
`host.compute_dtype` (float32 or bfloat16) with float32 parameters; the
losses widen its outputs to float32, and Adam's update is float32. With
`loss.multi.normalize` the running norms are updated once per epoch from
the epoch-mean raw losses (JAX :133-143). The val IoU's predictor shares
the model and polygonizes its maps unrounded, as JAX's trainer does
(:109-111): float32, or the bfloat16 values widened to float32.
"""

from __future__ import annotations

import torch

from ..data.loader import INPUT_KEYS, build_loader, device_prefetch
from ..eval.metrics import compute_iou_ciou
from ..models.ffl import build_ffl
from ..models.ffl.losses import LossNormTracker, make_ffl_loss
from ..parallel import all_gather_objects
from ..predict.predictor_ffl import FFLPredictor
from ..utils.coco import CocoIndex, generate_coco_ann
from ..utils.pretrained import apply_pretrained_encoder
from .ffl_step import make_train_step, make_val_step
from .state import TrainState, compute_dtype, cosine_with_warmup, make_optimizer, make_scheduler, num_params
from .trainer import Trainer

# batch leaves the steps consume on the device (JAX's FFL_BATCH_KEYS)
FFL_BATCH_KEYS = INPUT_KEYS + ("gt_polygons_image", "distances", "sizes", "gt_crossfield_angle", "class_freq")


class FFLTrainer(Trainer):
    def setup(self) -> None:
        cfg = self.cfg
        m = cfg.experiment.model
        self.train_loader = build_loader(cfg, "train")
        self.val_loader = build_loader(cfg, "val")

        model = build_ffl(cfg, device=self.device, generator=self.generator, dtype=compute_dtype(cfg))
        apply_pretrained_encoder(cfg, model, self.logger)
        total_steps = len(self.train_loader) * int(m.num_epochs)
        base_lr = float(m.learning_rate)
        optimizer = make_optimizer("adam", model.parameters(), base_lr)
        self.state = TrainState(model, optimizer, make_scheduler(optimizer, cosine_with_warmup(base_lr, total_steps),
                                                                 base_lr))
        self.maybe_resume()
        self.logger.info(f"model has {num_params(model)/1e6:.2f}M params on {self.device}, "
                         f"computing in {model.compute_dtype}")

        loss_fn, self._weights_for_epoch = make_ffl_loss(cfg)
        self._normalize = bool(m.loss.multi.get("normalize") or False)
        self._norm_tracker = LossNormTracker(self._weights_for_epoch(0)) if self._normalize else None
        self._train_step = make_train_step(loss_fn, normalize=self._normalize)
        self._val_step = make_val_step(loss_fn)

        self._predictor = FFLPredictor(cfg, device=self.device, model=model)
        self._predictor.map_dtype = torch.float32

    def train_one_epoch(self, epoch: int) -> dict:
        weights = self._weights_for_epoch(epoch)
        norms = self._norm_tracker.norms() if self._normalize else None
        self.train_loader.set_epoch(epoch)
        records = [
            self._train_step(self.state, batch, weights, norms)
            for batch in device_prefetch(self.train_loader, self.device, FFL_BATCH_KEYS)
        ]
        summary = self.summarize_deferred(records)
        if self._normalize:
            self._norm_tracker.update({k: v for k, v in summary.items() if k != "loss"})
        return summary

    def val_one_epoch(self, epoch: int) -> dict:
        weights = self._weights_for_epoch(epoch)
        records = [
            self._val_step(self.state, batch, weights)
            for batch in device_prefetch(self.val_loader, self.device, FFL_BATCH_KEYS)
        ]
        return self.summarize_deferred(records)

    def predict_and_eval(self, epoch: int) -> float:
        """Polygonize the val split (the ACM's polygons at the eval
        tolerance) and return its IoU (JAX :159-181)."""
        predictions: list[dict] = []
        ev_tol = self.cfg.experiment.polygonization.acm_method.get("eval_tolerance", 1)
        for batch in self.val_loader:
            results = self._predictor.predict_batch(batch)
            method = "acm" if "acm" in results else next(iter(results))
            tols = results[method]
            tol = f"tol_{ev_tol}" if f"tol_{ev_tol}" in tols else next(iter(tols))
            for b, polys in enumerate(tols[tol]):
                if batch["sample_valid"][b]:
                    predictions.extend(generate_coco_ann(polys, int(batch["image_id"][b])))
        gathered = [p for chunk in all_gather_objects(predictions) for p in chunk]
        gt = CocoIndex(self.cfg.experiment.dataset.annotations["val"])
        results = compute_iou_ciou(gt, gt.load_res(gathered))
        self.logger.info(f"epoch {epoch} val IoU={results['IoU']:.4f} C-IoU={results['C-IoU']:.4f}")
        return float(results["IoU"])
