"""HiSup train and val steps — port of pixelspointspolygons_tpu/train/hisup_step.py
(reference loss recipe: train/trainer_hisup.py:31-63 LossReducer).

A step builds the targets on the device (`encode_targets`, which launches the
AFM kernel on the card), runs the model, sums the five weighted losses and,
in training, takes one AdamW update. Metrics come back as device tensors so
the host syncs once per epoch, not once per step.

`remat=True` (`training.remat`) wraps the model's forward, the region that
JAX's `jax.checkpoint` wraps (JAX :18-35), in a non-reentrant
`torch.utils.checkpoint`: the backward recomputes the activations instead
of keeping them. The recomputed forward leaves the BatchNorms' running
statistics as the first forward left them (JAX keeps `batch_stats` from the
one forward whose outputs it uses), and replays any draw from torch's
global generators (`preserve_rng_state`); HiSup's forward passes no
explicit generator.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ..data.loader import INPUT_KEYS
from ..models.hisup.model import encode_targets, hisup_losses
from ..models.layers import running_stats_frozen
from .state import TrainState


def model_inputs(batch: dict) -> dict:
    return {k: batch[k] for k in INPUT_KEYS if k in batch}


def forward(model: torch.nn.Module, inputs: dict, remat: bool = False) -> dict:
    """The model's train-mode outputs; with `remat` recomputed in the
    backward, the recompute's BatchNorms leaving their running statistics."""
    if not remat:
        return model(inputs)
    return checkpoint(model, inputs, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), running_stats_frozen(model)))


def make_train_step(weights: dict, size: int, remat: bool = False):
    def train_step(state: TrainState, batch: dict) -> dict:
        targets = encode_targets(batch, size)
        state.model.train()
        outputs = forward(state.model, model_inputs(batch), remat)
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
