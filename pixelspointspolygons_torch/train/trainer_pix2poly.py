"""Pix2Poly trainer — port of pixelspointspolygons_tpu/train/trainer_pix2poly.py
(reference train/trainer_pix2poly.py):

- AdamW with β = (0.9, 0.95) and a linear warmup-decay with 5 % warmup;
- CE (PAD left out) + Sinkhorn BCE, weighted by the config (`pix2poly_step.py`);
- a teacher-forced train epoch and a val-loss epoch, batches reaching the
  device one step ahead from pinned memory (`data.loader.device_prefetch`)
  or coming from the device cache (`training.device_cache`);
- every `val_every` epochs the val split greedy-decoded (early exit, raw
  scores), assembled into polygons and scored, at the model's compute
  dtype, through a predictor that shares the model, and the last val
  batch's first prediction drawn over its image for the run logger
  (`val_prediction_<epoch>.png`; a figure that fails is logged and never
  stops training, JAX :168-195).

The model computes in `host.compute_dtype` (float32 or bfloat16) with
float32 parameters. A configured ViT checkpoint (`encoder.vit.pretrained`
with a `checkpoint_file`) is grafted in right after the model is built
(`utils/pretrained.py`), before a resume or warm start.
"""

from __future__ import annotations

from ..data.device_cache import P2PDeviceCache
from ..data.loader import INPUT_KEYS, build_loader
from ..eval.metrics import compute_iou_ciou
from ..models.pix2poly import Tokenizer, build_pix2poly
from ..parallel import all_gather_objects
from ..predict.predictor_pix2poly import Pix2PolyPredictor
from ..utils.coco import CocoIndex, generate_coco_ann
from ..utils.pretrained import apply_pretrained_encoder
from .pix2poly_step import make_train_step, make_val_step
from .state import TrainState, compute_dtype, linear_warmup_decay, make_optimizer, make_scheduler, num_params
from .trainer import Trainer

# batch leaves the steps consume on the device
_DEV_KEYS = INPUT_KEYS + ("y", "y_perm")


class Pix2PolyTrainer(Trainer):
    def setup(self) -> None:
        cfg = self.cfg
        m = cfg.experiment.model
        self.tokenizer = Tokenizer(cfg)
        self.train_loader = build_loader(cfg, "train", tokenizer=self.tokenizer)
        self.val_loader = build_loader(cfg, "val", tokenizer=self.tokenizer)
        self.cache = self.make_device_caches(lambda split: P2PDeviceCache(cfg, split, self.tokenizer, self.device))
        if cfg.training.get("remat"):
            self.logger.info("training.remat has no effect on Pix2Poly: only HiSup's step recomputes, as in JAX")

        model = build_pix2poly(cfg, self.tokenizer, device=self.device, generator=self.generator,
                               dtype=compute_dtype(cfg))
        apply_pretrained_encoder(cfg, model, self.logger)
        total_steps = self.steps_per_epoch() * int(m.num_epochs)
        base_lr = float(m.learning_rate)
        schedule = linear_warmup_decay(base_lr, total_steps, 0.05)
        optimizer = make_optimizer("adamw", model.parameters(), base_lr, weight_decay=float(m.weight_decay), b2=0.95)
        self.state = TrainState(model, optimizer, make_scheduler(optimizer, schedule, base_lr))
        self.maybe_resume()
        self.state.wrap()
        self.logger.info(f"model has {num_params(model)/1e6:.2f}M params on {self.device}, "
                         f"computing in {model.compute_dtype}")

        vw, pw = float(m.vertex_loss_weight), float(m.perm_loss_weight)
        self._train_step = make_train_step(vw, pw, self.tokenizer.PAD_code)
        self._val_step = make_val_step(vw, pw, self.tokenizer.PAD_code)
        self._predictor = Pix2PolyPredictor(cfg, device=self.device, model=model)

    def train_one_epoch(self, epoch: int) -> dict:
        records = [self._train_step(self.state, batch, self.generator)
                   for batch in self.epoch_batches("train", epoch, _DEV_KEYS)]
        return self.summarize_deferred(records)

    def val_one_epoch(self, epoch: int) -> dict:
        records = [self._val_step(self.state, batch) for batch in self.epoch_batches("val", epoch, _DEV_KEYS)]
        return self.summarize_deferred(records)

    def predict_and_eval(self, epoch: int) -> float:
        """Greedy-decode the val split and return its mask IoU (JAX :146-166)."""
        predictions: list[dict] = []
        for batch in self.val_loader:
            polys, _ = self._predictor.predict_batch(batch)
            for b, image_polys in enumerate(polys):
                if batch["sample_valid"][b]:
                    predictions.extend(generate_coco_ann(image_polys, int(batch["image_id"][b])))
        gathered = [p for chunk in all_gather_objects(predictions) for p in chunk]
        gt = CocoIndex(self.cfg.experiment.dataset.annotations["val"])
        results = compute_iou_ciou(gt, gt.load_res(gathered))
        self.logger.info(f"epoch {epoch} val IoU={results['IoU']:.4f} C-IoU={results['C-IoU']:.4f}")
        self._log_val_visualization(epoch, polys, batch)
        return float(results["IoU"])

    def _log_val_visualization(self, epoch: int, polys, batch) -> None:
        """The first tile of the last val batch with its predicted polygons,
        through the run logger (the reference pushes it to wandb,
        trainer_pix2poly.py:96-179)."""
        if not getattr(self, "run_logger", None) or not self.run_logger.enabled:
            return
        try:
            from ..utils.visualization import prediction_figure

            image = batch.get("images")
            figure = prediction_figure(None if image is None else image[0], polys[0])
            self.run_logger.log_image("val_prediction", figure, step=epoch)
        except Exception as e:  # a figure must never stop training
            self.logger.debug(f"val visualization failed: {e}")
