"""HiSup train and val steps — port of pixelspointspolygons_tpu/train/hisup_step.py
(reference loss recipe: train/trainer_hisup.py:31-63 LossReducer).

A step builds the targets on the device (`encode_targets`, which launches the
AFM kernel on the card), runs the model, sums the five weighted losses and,
in training, takes one AdamW update. Metrics come back as device tensors so
the host syncs once per epoch, not once per step.
"""

from __future__ import annotations

import torch

from ..data.loader import INPUT_KEYS
from ..models.hisup.model import encode_targets, hisup_losses
from .state import TrainState


def model_inputs(batch: dict) -> dict:
    return {k: batch[k] for k in INPUT_KEYS if k in batch}


def make_train_step(weights: dict, size: int):
    def train_step(state: TrainState, batch: dict) -> dict:
        targets = encode_targets(batch, size)
        state.model.train()
        outputs = state.model(model_inputs(batch))
        losses = hisup_losses(outputs, targets)
        total = sum(weights[k] * v for k, v in losses.items())
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    return train_step


def make_val_step(weights: dict, size: int):
    @torch.no_grad()
    def val_step(state: TrainState, batch: dict) -> dict:
        targets = encode_targets(batch, size)
        state.model.eval()
        outputs = state.model(model_inputs(batch))
        losses = hisup_losses(outputs, targets)
        total = sum(weights[k] * v for k, v in losses.items())
        return {"loss": total, **losses}

    return val_step
