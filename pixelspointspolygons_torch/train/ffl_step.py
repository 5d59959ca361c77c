"""FFL train and val steps — port of pixelspointspolygons_tpu/train/ffl_step.py
(loss recipe: models/ffl/losses.py's MultiLoss, reference
train/trainer_ffl.py:38-59).

A train step runs the model in train mode (BatchNorm on batch statistics,
its running ones updated with flax's momentum 0.9), the loss with the
epoch's weights (and, with `normalize`, the running norms), then one Adam
update and one schedule step. A val step runs the model in eval mode
without gradients. Both return device tensors, so the host syncs once per
epoch (`Trainer.summarize_deferred`).

Under a process group the train step calls the state's DDP wrapper,
built with `find_unused_parameters=False` (the seg and crossfield heads
and every encoder parameter reach the loss) and `broadcast_buffers=False`
(the BatchNorms take global statistics, so their running ones are the
same on every process). Every term of the MultiLoss is a mean over pixels
or images of equal shards, so DDP's average of the gradients is the
gradient of JAX's global loss. With `loss.multi.normalize` the running
norms are fed the epoch means that `Trainer.summarize_deferred` has
already averaged over processes: global, as JAX's are.
"""

from __future__ import annotations

import torch

from ..data.loader import INPUT_KEYS
from .state import TrainState


def model_inputs(batch: dict) -> dict:
    return {k: batch[k] for k in INPUT_KEYS if k in batch}


def make_train_step(loss_fn, normalize: bool = False):
    """`loss_fn` from `make_ffl_loss`; with `normalize` the step takes the
    running norms as its last argument."""

    def train_step(state: TrainState, batch: dict, weights: dict, norms: dict | None = None) -> dict:
        state.model.train()
        outputs = state.train_module(model_inputs(batch))
        if normalize:
            total, losses = loss_fn(outputs, batch, weights, norms)
        else:
            total, losses = loss_fn(outputs, batch, weights)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    return train_step


def make_val_step(loss_fn):
    @torch.no_grad()
    def val_step(state: TrainState, batch: dict, weights: dict) -> dict:
        state.model.eval()
        total, losses = loss_fn(state.model(model_inputs(batch)), batch, weights)
        return {"loss": total, **losses}

    return val_step
