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

Under a process group the step calls the state's DDP wrapper, which
`HiSupTrainer` puts around `train_module(model, remat)`: with remat the
checkpoint sits inside the wrapped module, so DDP's forward runs once per
step and the recompute runs the bare model. DDP is built with
`find_unused_parameters=False`: every parameter of every HiSup encoder
reaches the five losses (the tests run each family's DDP step, and DDP
raises at the next step when one does not). `broadcast_buffers=False`:
the BatchNorms take global statistics (`models/layers.py`), so their
running statistics are the same on every process. The five terms are
means over pixels or images of equal shards, so DDP's average of the
per-process gradients is the gradient of JAX's global loss and each
logged term's mean over processes is its global value.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.loader import INPUT_KEYS
from ..models.hisup.model import encode_targets, hisup_losses
from ..models.layers import running_stats_frozen
from .state import TrainState


def model_inputs(batch: dict) -> dict:
    return {k: batch[k] for k in INPUT_KEYS if k in batch}


class Recomputed(nn.Module):
    """`model` with its forward recomputed in the backward, the recompute's
    BatchNorms leaving their running statistics."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, inputs: dict) -> dict:
        return checkpoint(self.model, inputs, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), running_stats_frozen(self.model)))


def train_module(model: nn.Module, remat: bool = False) -> nn.Module:
    """What a train step runs: the model, or with `remat` the model inside
    its checkpoint."""
    return Recomputed(model) if remat else model


def make_train_step(weights: dict, size: int, remat: bool = False):
    def train_step(state: TrainState, batch: dict) -> dict:
        targets = encode_targets(batch, size)
        state.model.train()
        if state.ddp is None:
            module = train_module(state.model, remat)
        elif isinstance(state.ddp.module, Recomputed) == remat:
            module = state.ddp
        else:
            raise ValueError(f"the DDP wrapper must hold train_module(model, remat={remat})")
        outputs = module(model_inputs(batch))
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
