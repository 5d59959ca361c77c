"""FFL loss stack: a MultiLoss with epoch-interpolated weights — port of
pixelspointspolygons_tpu/models/ffl/losses.py (reference models/ffl/losses.py):

- seg: BCE (the ground truth thresholded at 0.98 when loss.seg.type is
  'bool') with optional freq/dist/size pixel weights, plus dice;
- crossfield_align: |f(z_gt)|² on ground-truth edge pixels;
- crossfield_align90: the same for the 90°-rotated direction, on edge
  minus vertex pixels;
- crossfield_smooth: the Laplacian penalty off the edges;
- seg_interior_crossfield / seg_edge_crossfield: the crossfield aligned
  with the seg's normalized Scharr gradients, weighted by their detached
  norm;
- seg_edge_interior: the edge channel against the interior's gradient norm.

Every term is computed on float32 outputs (the model's bfloat16 outputs
widened first, as JAX :46, :66, :82, :89 does; float64 stays float64). The
BCE is JAX's formula on probabilities clipped to [1e-7, 1 - 1e-7], not
`F.binary_cross_entropy`, which clamps the log at -100 and differs in value
and gradient near 0 and 1. Where JAX's gradient takes a side that torch's
does not, the port takes JAX's: `jnp.clip` passes half the gradient at a
bound (`_clip`), `jnp.abs` passes +1 at 0 (`_abs`). The total is
Σ weights[k] · term over every active term, a term of weight 0 included, as
JAX sums it. The complex algebra is `ops/crossfield.py`'s, differentiated
by torch's complex autograd.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ...ops.crossfield import crossfield_to_c0c2, framefield_align_error, laplacian_penalty
from ...ops.spatial_grad import spatial_gradient
from ..layers import widen


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(widen(x.dtype))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip`: a maximum, then a minimum, each splitting the gradient
    at a tie (`clamp` passes all of it at a bound)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with `jnp.abs`'s gradient at 0, +1 (torch's `abs` gives 0)."""
    return torch.where(x >= 0, x, -x)


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-sample dice over all channels (reference measures.py:14-26)."""
    axes = tuple(range(1, pred.ndim))
    inter = (pred * gt).sum(axes)
    denom = pred.sum(axes) + gt.sum(axes)
    return 1.0 - (2.0 * inter + eps) / (denom + eps)


def seg_loss(outputs, batch, *, bce_coef, dice_coef, seg_type, gt_channels, use_weights):
    pred = _wide(outputs["seg"])  # (B, Cs, H, W)
    gt = batch["gt_polygons_image"][:, gt_channels]
    if pred.shape[-2:] != gt.shape[-2:]:
        # JAX's first product of the two fails here too (ROADMAP 3.18): the
        # model's maps are decoder.in_feature_size (encoder.in_size) wide, the
        # ground truth is the tile's size, and nothing resizes either
        raise ValueError(f"FFL seg maps of {tuple(pred.shape[-2:])} against ground truth of "
                         f"{tuple(gt.shape[-2:])}: encoder.in_size must be the tiles' size")
    w = batch.get("seg_loss_weights")
    d = dice_loss(pred, gt).mean()
    if seg_type == "bool":
        gt = (gt > 0.98).to(pred.dtype)
    p = _clip(pred, 1e-7, 1 - 1e-7)
    bce = -(gt * torch.log(p) + (1 - gt) * torch.log(1 - p))
    if use_weights and w is not None:
        bce = bce * w[:, gt_channels]
    return bce_coef * bce.mean() + dice_coef * d


def gt_field(batch) -> torch.Tensor:
    """Unit complex tangent field from the ground-truth angle map."""
    ang = batch["gt_crossfield_angle"][:, 0].float()  # (B, H, W)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def crossfield_align_loss(outputs, batch):
    c0, c2 = crossfield_to_c0c2(_wide(outputs["crossfield"]))
    z = gt_field(batch)
    gt_edges = batch["gt_polygons_image"][:, 1]
    return (framefield_align_error(c0, c2, z) * gt_edges).mean()


def crossfield_align90_loss(outputs, batch):
    c0, c2 = crossfield_to_c0c2(_wide(outputs["crossfield"]))
    z90 = gt_field(batch) * 1j
    img = batch["gt_polygons_image"]
    mask = (img[:, 1] - img[:, 2]).clamp(0.0, 1.0)
    return (framefield_align_error(c0, c2, z90) * mask).mean()


def crossfield_smooth_loss(outputs, batch):
    cf = _wide(outputs["crossfield"])
    gt_edges_inv = 1.0 - batch["gt_polygons_image"][:, 1]
    return (laplacian_penalty(cf) * gt_edges_inv[:, None]).mean()


def compute_seg_grads(outputs) -> dict:
    """2× the normalized Scharr gradients of the seg (ComputeSegGrads
    :221-233), their norm and the gradients over it."""
    seg = _wide(outputs["seg"])
    grads = 2.0 * spatial_gradient(seg)  # (B, C, 2, H, W)
    # a safe norm: d|g|/dg is NaN at exactly-zero gradients (flat seg regions)
    norm = torch.sqrt(torch.sum(grads * grads, dim=2) + 1e-12)
    normed = grads / (norm[:, :, None] + 1e-6)
    return {"seg_grads": grads, "seg_grad_norm": norm, "seg_grads_normed": normed}


def seg_crossfield_loss(outputs, grads, channel: int):
    c0, c2 = crossfield_to_c0c2(_wide(outputs["crossfield"]))
    gn = grads["seg_grads_normed"][:, channel]  # (B, 2, H, W) [di, dj]
    z = torch.complex(gn[:, 0], gn[:, 1])
    norm = grads["seg_grad_norm"][:, channel].detach()
    return (framefield_align_error(c0, c2, z) * norm).mean()


def seg_edge_interior_loss(outputs, grads):
    seg_int = _wide(outputs["seg"][:, 0])
    seg_edge = _wide(outputs["seg"][:, 1])
    gnorm = grads["seg_grad_norm"][:, 0]
    raw = _abs(seg_edge - gnorm)
    outside = (torch.cos(math.pi * seg_int) + 1) / 2
    boundary = (1 - torch.cos(math.pi * gnorm)) / 2
    return (raw * torch.maximum(outside, boundary)).mean()


def compute_seg_loss_weights(batch, cfg) -> torch.Tensor | None:
    """Optional freq/dist/size pixel weights (reference losses.py:147-209)."""
    ls = cfg.experiment.model.loss.seg
    if not (ls.use_freq or ls.use_dist or ls.use_size):
        return None
    img = batch["gt_polygons_image"]
    H = int(cfg.experiment.encoder.in_height)
    W = int(cfg.experiment.encoder.in_width)
    weights = torch.ones_like(img)
    if ls.use_freq:
        mask = (img > 0).float()
        cf = batch["class_freq"]  # (B, 2): [background, interior] fractions
        fg = cf[:, 1][:, None, None, None]
        bg = 1.0 - fg
        pix = mask * fg + (1 - mask) * bg
        weights = 1.0 / pix.clamp(min=1e-4)
    if ls.use_dist:
        d = batch["distances"] * (H + W)
        weights = weights + float(ls.w0) * torch.exp(-(d**2) / float(ls.sigma) ** 2)
    if ls.use_size:
        im_radius = math.sqrt(H * W) / 2
        weights = weights * (1.0 + 1.0 / (im_radius * batch["sizes"]).clamp(min=1e-4))
    return weights


def epoch_weight(spec: Any, epoch: int, thresholds: list[int]) -> float:
    """Scalar weights pass through; list weights interpolate between the
    thresholds (reference MultiLoss :95-118)."""
    if not isinstance(spec, (list, tuple)):
        return float(spec)
    t = list(thresholds)
    vals = list(spec)
    if epoch <= t[0]:
        return float(vals[0])
    for i in range(len(t) - 1):
        if t[i] <= epoch <= t[i + 1]:
            frac = (epoch - t[i]) / max(t[i + 1] - t[i], 1)
            return float(vals[i] + frac * (vals[i + 1] - vals[i]))
    return float(vals[-1])


def make_ffl_loss(cfg):
    """Returns (loss_fn, weights_for_epoch).

    loss_fn(outputs, batch, weights) → (total, {term: value}) takes the
    epoch's weights as Python floats, which weights_for_epoch(epoch) gives.
    With `loss.multi.normalize` it takes a fourth argument, `norms` (a
    `LossNormTracker`'s), and optimizes each term over its running norm
    while it reports the raw terms."""
    m = cfg.experiment.model
    w = m.loss.multi.weights
    thresholds = [int(t) for t in m.loss.multi.epoch_thresholds]
    compute_seg = bool(m.compute_seg)
    compute_cf = bool(m.compute_crossfield)
    has_interior = bool(m.seg.compute_interior)
    has_edge = bool(m.seg.compute_edge)
    gt_channels = [i for i, on in enumerate([has_interior, has_edge, bool(m.seg.compute_vertex)]) if on]
    ls = m.loss.seg
    use_weights = bool(ls.use_freq or ls.use_dist or ls.use_size)

    active = []
    if compute_seg:
        active.append(("seg", w.seg))
    if compute_cf:
        active.append(("crossfield_align", w.crossfield_align))
        active.append(("crossfield_align90", w.crossfield_align90))
        active.append(("crossfield_smooth", w.crossfield_smooth))
    if compute_seg:
        if has_interior and compute_cf:
            active.append(("seg_interior_crossfield", w.seg_interior_crossfield))
        if has_edge and compute_cf:
            active.append(("seg_edge_crossfield", w.seg_edge_crossfield))
        if has_interior and has_edge:
            active.append(("seg_edge_interior", w.seg_edge_interior))

    def weights_for_epoch(epoch: int) -> dict:
        return {k: epoch_weight(spec, epoch, thresholds) for k, spec in active}

    def raw_loss_fn(outputs, batch, weights):
        losses = {}
        if use_weights:
            batch = dict(batch)
            batch["seg_loss_weights"] = compute_seg_loss_weights(batch, cfg)
        if compute_seg:
            losses["seg"] = seg_loss(
                outputs,
                batch,
                bce_coef=float(ls.bce_coef),
                dice_coef=float(ls.dice_coef),
                seg_type=str(ls.type),
                gt_channels=gt_channels,
                use_weights=use_weights,
            )
        if compute_cf:
            losses["crossfield_align"] = crossfield_align_loss(outputs, batch)
            losses["crossfield_align90"] = crossfield_align90_loss(outputs, batch)
            losses["crossfield_smooth"] = crossfield_smooth_loss(outputs, batch)
        if compute_seg and (compute_cf or has_edge):
            grads = compute_seg_grads(outputs)
            ch = -1
            if has_interior and compute_cf:
                ch += 1
                losses["seg_interior_crossfield"] = seg_crossfield_loss(outputs, grads, ch)
            if has_edge and compute_cf:
                ch += 1
                losses["seg_edge_crossfield"] = seg_crossfield_loss(outputs, grads, ch)
            if has_interior and has_edge:
                losses["seg_edge_interior"] = seg_edge_interior_loss(outputs, grads)
        total = sum(weights[k] * v for k, v in losses.items())
        return total, losses

    if not bool(m.loss.multi.get("normalize") or False):
        return raw_loss_fn, weights_for_epoch

    # the reference's norm-normalization (reference models/ffl/losses.py:21-69:
    # each term over a running mean of its own raw value), off by default as
    # the reference trains it; the running norms are updated once per epoch
    # from the epoch-mean raw losses, as in the JAX package
    def loss_fn(outputs, batch, weights, norms=None):
        total_raw, losses = raw_loss_fn(outputs, batch, weights)
        if norms is None:
            return total_raw, losses
        normed = {k: v / max(norms.get(k, 1.0), 1e-9) for k, v in losses.items()}
        total = sum(weights[k] * v for k, v in normed.items())
        # the raw losses are reported (comparable across epochs); the normed
        # total is optimized
        return total, losses

    return loss_fn, weights_for_epoch


class LossNormTracker:
    """Running per-term norm means (reference Loss.norm_meter with
    init_val=1, lydorn_utils/math_utils.py AverageMeter): update() with the
    epoch-mean losses after each epoch; norms() feeds the loss, as float32
    values (JAX passes them as float32 scalars)."""

    def __init__(self, term_keys=()):
        self.sums: dict = {k: 1.0 for k in term_keys}  # the init_val=1 seed
        self.counts: dict = {k: 1 for k in term_keys}

    def update(self, losses: dict) -> None:
        for k, v in losses.items():
            if self.counts and k not in self.counts:
                continue  # a metric of the epoch summary that is no term
            self.sums[k] = self.sums.get(k, 1.0) + float(v)
            self.counts[k] = self.counts.get(k, 1) + 1

    def norms(self) -> dict:
        return {k: float(np.float32(self.sums[k] / self.counts[k])) for k in self.sums}
