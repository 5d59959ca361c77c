"""Pix2Poly train and val steps — port of pixelspointspolygons_tpu/train/pix2poly_step.py
(reference train/trainer_pix2poly.py:87-93, 284-351).

Teacher forcing with y[:, :-1] in and y[:, 1:] out; the vertex loss is the
cross-entropy over the tokens with PAD targets left out, the permutation
loss the binary cross-entropy between the Sinkhorn softmax and the ground
truth permutation; total = vertex_loss_weight · CE + perm_loss_weight · BCE.
In training the ScoreNets' BatchNorm takes batch statistics and updates its
running ones (flax's `mutable=["batch_stats"]`), and one AdamW update and
one schedule step follow. The Sinkhorn's gradient comes from autograd
through its 100 iterations, as JAX differentiates its `lax.scan`. Metrics
come back as device tensors, so the host syncs once per epoch.
"""

from __future__ import annotations

import torch

from ..data.loader import INPUT_KEYS
from ..models.layers import widen
from .state import TrainState


def model_inputs(batch: dict) -> dict:
    return {k: batch[k] for k in INPUT_KEYS if k in batch}


def token_ce_loss(logits: torch.Tensor, targets: torch.Tensor, pad_idx: int) -> torch.Tensor:
    """Cross-entropy over tokens on float32 logits, PAD targets left out,
    over max(count, 1): 0 when every target is PAD, where
    `F.cross_entropy(ignore_index=)` gives NaN."""
    logits = logits.to(widen(logits.dtype))
    mask = (targets != pad_idx).to(logits.dtype)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - picked  # optax's integer-label CE
    return (ce * mask).sum() / mask.sum().clamp(min=1.0)


def perm_bce_loss(perm: torch.Tensor, gt_perm: torch.Tensor) -> torch.Tensor:
    """Mean BCE on probabilities clipped to [1e-7, 1 - 1e-7] (JAX's; torch's
    `nn.BCELoss` clamps the log at -100 instead, which differs near 0 and 1
    in value and gradient)."""
    dt = widen(perm.dtype)
    p = perm.to(dt).clamp(1e-7, 1.0 - 1e-7)
    g = gt_perm.to(dt)
    return -(g * torch.log(p) + (1.0 - g) * torch.log(1.0 - p)).mean()


def _losses(model, batch: dict, vertex_w: float, perm_w: float, pad_idx: int,
            generator: torch.Generator | None = None) -> dict:
    y = batch["y"]
    logits, perm = model(model_inputs(batch), y[:, :-1], generator)
    ce = token_ce_loss(logits, y[:, 1:], pad_idx)
    bce = perm_bce_loss(perm, batch["y_perm"])
    return {"loss": vertex_w * ce + perm_w * bce, "vertex_loss": ce, "perm_loss": bce}


def make_train_step(vertex_w: float, perm_w: float, pad_idx: int):
    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None) -> dict:
        """`generator` draws the fusion encoder's LiDAR dropout (JAX's
        per-step "lidar_dropout" rng, pix2poly_step.py:60)."""
        state.model.train()
        metrics = _losses(state.model, batch, vertex_w, perm_w, pad_idx, generator)
        state.optimizer.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_val_step(vertex_w: float, perm_w: float, pad_idx: int):
    @torch.no_grad()
    def val_step(state: TrainState, batch: dict) -> dict:
        state.model.eval()
        return _losses(state.model, batch, vertex_w, perm_w, pad_idx)

    return val_step
