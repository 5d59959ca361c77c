"""HiSup: attraction-field + junction + mask heads with ECA cross-attention —
port of pixelspointspolygons_tpu/models/hisup/model.py (:31-247).

The ground-truth targets (jloc/joff/afm/mask) are built on the device inside
the train step from fixed-shape junction and edge arrays (`encode_targets`);
the AFM goes through `ops/afm.py::afm_auto`, which launches the hand-written
CUDA kernel on the card. Head outputs are NCHW, as in the JAX module.
`extract_junctions` (prediction) is plain PyTorch: in the JAX package it is
an XLA fusion, not a Pallas kernel.

`dtype` is the compute dtype, as flax's `dtype=` (JAX model.py:31-64,
:123-247): convolutions cast their input and kernel to it and give it,
BatchNorms compute in float32 and give it, the ECA's gate is a bfloat16
sigmoid at bfloat16, the head outputs are in it, and the losses read them
as float32. The targets (AFM included) are float32 at every dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.afm import afm_auto
from ..layers import BatchNorm, Conv1d, Conv2d, encode_modalities, resize_bilinear


def _conv3(cin: int, cout: int, dtype=None, device=None) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=1, bias=True, dtype=dtype, device=device)


class ConvStack3(nn.Module):
    """3x (conv3x3 + BN + ReLU) — the reference's _make_conv (:152-165).
    Flax names Conv_i / BatchNorm_i are conv{i} / bn{i} here."""

    def __init__(self, cin: int, dim_hid: int, dim_out: int, dtype=None, device=None):
        super().__init__()
        chans = (cin, dim_hid, dim_hid, dim_out)
        for i in range(3):
            self.add_module(f"conv{i}", _conv3(chans[i], chans[i + 1], dtype=dtype, device=device))
            self.add_module(f"bn{i}", BatchNorm(chans[i + 1], dtype=dtype, device=device))

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class Predictor2(nn.Module):
    """conv3x3 → ReLU → conv1x1 (the reference's _make_predictor :167-174)."""

    def __init__(self, cin: int, dim_out: int, dtype=None, device=None):
        super().__init__()
        self.conv0 = _conv3(cin, cin // 4, dtype=dtype, device=device)
        self.conv1 = Conv2d(cin // 4, dim_out, 1, bias=True, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv1(F.relu(self.conv0(x)))


class ECA(nn.Module):
    """Efficient channel attention with adaptive kernel (reference :39-64).
    Flax Conv_0 (the 1-D conv over channels) is `conv1d`, Conv_1 `proj`,
    BatchNorm_0 `bn`."""

    def __init__(self, channels: int, gamma: int = 2, b: int = 1, dtype=None, device=None):
        super().__init__()
        t = int(abs((math.log2(channels) + b) / gamma))
        k = t if t % 2 else t + 1
        self.conv1d = Conv1d(1, 1, k, padding=k // 2, bias=False, dtype=dtype, device=device)
        self.proj = Conv2d(channels, channels, 1, bias=False, dtype=dtype, device=device)
        self.bn = BatchNorm(channels, dtype=dtype, device=device)

    def forward(self, x1, x2):
        y = (x1 + x2).mean(dim=(2, 3))  # (B, C) global average pool
        y = torch.sigmoid(self.conv1d(y[:, None, :])[:, 0, :])[:, :, None, None]
        return F.relu(self.bn(self.proj(x2 * y)))


@torch.no_grad()
def encode_targets(batch: dict, size: int) -> dict:
    """Targets from fixed-shape arrays (AnnotationEncoder :84-120).

    batch: junctions (B,J,2) xy, junc_tags (B,J), junc_valid (B,J),
    edges (B,E,4), edges_valid (B,E), mask (B,S,S).

    Where several junctions fall on one pixel, `jloc` keeps the largest tag
    (JAX `.at[].max`) and `joff` the offset of the junction listed last —
    what JAX's `.at[].set` gives on the CPU — picked deterministically here
    by a max-reduce over junction positions."""
    juncs = batch["junctions"]
    tags = batch["junc_tags"]
    valid = batch["junc_valid"].to(torch.bool)
    B, J, _ = juncs.shape

    xi = juncs[..., 0].to(torch.int32).clamp(0, size - 1)
    yi = juncs[..., 1].to(torch.int32).clamp(0, size - 1)
    offx = torch.where(valid, juncs[..., 0] - xi - 0.5, 0.0)
    offy = torch.where(valid, juncs[..., 1] - yi - 0.5, 0.0)
    flat = (yi * size + xi).to(torch.int64)  # (B, J)

    jloc = torch.zeros((B, size * size), dtype=torch.int32, device=juncs.device)
    # .max keeps a real junction if an invalid (zeroed) one collides at (0,0)
    jloc.scatter_reduce_(1, flat, torch.where(valid, tags.to(torch.int32), 0), "amax")
    pos = torch.arange(J, device=juncs.device).expand(B, J)
    last = torch.full((B, size * size), -1, dtype=torch.int64, device=juncs.device)
    last.scatter_reduce_(1, flat, pos, "amax")
    hit = last >= 0
    src = last.clamp(min=0)
    joff = torch.stack(
        [
            torch.where(hit, torch.gather(offx, 1, src), 0.0),
            torch.where(hit, torch.gather(offy, 1, src), 0.0),
        ],
        dim=1,
    )
    afmap, _ = afm_auto(batch["edges"], batch["edges_valid"], size, size)
    return {
        "jloc": jloc.view(B, size, size),
        "joff": joff.view(B, 2, size, size),
        "afmap": afmap,
        "mask": batch["mask"],
    }


class HiSup(nn.Module):
    """Encoder + multi-head decoder. `forward(batch)` takes NHWC images,
    LiDAR points with their mask, or both, and returns NCHW head outputs:
    joff (B,2,S,S), jloc (B,3,S,S), mask (B,2,S,S), afm (B,2,S,S), remask
    (B,2,S,S)."""

    def __init__(self, encoder: nn.Module, dim: int = 256, pred_size: int = 224, dtype=None, device=None):
        super().__init__()
        self.pred_size = pred_size
        self.compute_dtype = dtype
        self.encoder = encoder
        kw = dict(dtype=dtype, device=device)
        self.mask_head = ConvStack3(dim, dim, dim, **kw)
        self.jloc_head = ConvStack3(dim, dim, dim, **kw)
        self.afm_head = ConvStack3(dim, dim, dim, **kw)
        self.joff_head = Predictor2(dim, 2, **kw)
        self.a2m_att = ECA(dim, **kw)
        self.a2j_att = ECA(dim, **kw)
        self.mask_predictor = Predictor2(dim, 2, **kw)
        self.jloc_predictor = Predictor2(dim, 3, **kw)
        self.afm_predictor = Predictor2(dim, 2, **kw)
        self.refuse_conv = ConvStack3(2, dim // 2, dim, **kw)
        self.final_conv = ConvStack3(2 * dim, dim, 2, **kw)

    def forward(self, batch: dict) -> dict:
        return self.heads(encode_modalities(self.encoder, batch))

    def heads(self, feats: torch.Tensor) -> dict:
        """The head outputs of the encoder's (B, s, s, C) map."""
        feats = resize_bilinear(feats.permute(0, 3, 1, 2), self.pred_size)  # (B, C, S, S)

        joff = self.joff_head(feats)
        mask_f = self.mask_head(feats)
        jloc_f = self.jloc_head(feats)
        afm_f = self.afm_head(feats)

        mask_att = self.a2m_att(afm_f, mask_f)
        jloc_att = self.a2j_att(afm_f, jloc_f)

        mask_pred = self.mask_predictor(mask_f + mask_att)
        jloc_pred = self.jloc_predictor(jloc_f + jloc_att)
        afm_pred = self.afm_predictor(afm_f)

        afm_conv = self.refuse_conv(afm_pred)
        remask_pred = self.final_conv(torch.cat([feats, afm_conv], dim=1))
        return {
            "joff": joff,
            "jloc": jloc_pred,
            "mask": mask_pred,
            "afm": afm_pred,
            "remask": remask_pred,
        }


# --- losses (reference :20-37, :300-306) -----------------------------------


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1; torch.abs gives 0). Pixels where
    the afm head's output equals its target exactly (both 0: an all-ReLU-off
    predictor with zero bias on a pixel that lies on a segment) would
    otherwise take another gradient than in the JAX package."""
    return torch.where(x >= 0, x, -x)


def ce_loss_2d(logits_nchw: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """JAX's (:216-220): log_softmax over the classes in float32, the
    one-hot product and the mean. `F.cross_entropy` on NCHW logits is
    `nll_loss2d`, whose reduction on the card has no ordered form."""
    logp = torch.log_softmax(logits_nchw.float(), dim=1)
    classes = torch.arange(logits_nchw.shape[1], device=labels.device)
    onehot = (labels.long()[:, None] == classes[None, :, None, None]).to(logp.dtype)
    return -(onehot * logp).sum(dim=1).mean()


def sigmoid_l1_loss(logits, targets, offset: float = 0.0, mask=None):
    """|sigmoid(x) + offset − t|, weighted by junction-pixel density per image
    (reference sigmoid_l1_loss :27-37; mask = jloc labels)."""
    pred = torch.sigmoid(logits.float()) + offset
    loss = _abs(pred - targets)
    if mask is not None:
        t = ((mask == 1) | (mask == 2)).float()[:, None]
        w = t.mean(dim=(2, 3), keepdim=True)
        w = torch.where(w == 0, 1.0, w)
        loss = loss * (t / w)
    return loss.mean()


def hisup_losses(outputs: dict, targets: dict) -> dict:
    return {
        "loss_jloc": ce_loss_2d(outputs["jloc"], targets["jloc"]),
        "loss_joff": sigmoid_l1_loss(outputs["joff"], targets["joff"], -0.5, targets["jloc"]),
        "loss_mask": ce_loss_2d(outputs["mask"], targets["mask"]),
        "loss_afm": _abs(outputs["afm"].float() - targets["afmap"]).mean(),
        "loss_remask": ce_loss_2d(outputs["remask"], targets["mask"]),
    }


# --- junction extraction (reference polygon.py:8-40; JAX :253-288) --------


def nms_2d(x: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool NMS on (B, H, W); the pool pads with −inf."""
    mp = F.max_pool2d(x[:, None], 3, 1, 1)[:, 0]
    return torch.where(x == mp, x, 0.0)


def extract_junctions(jloc_softmax: torch.Tensor, joff: torch.Tensor, topk: int = 300, th: float = 0.008):
    """jloc_softmax: (B, 3, S, S); joff: (B, 2, S, S) already sigmoid−0.5.

    Returns (points (B, 2*topk, 2) xy, scores (B, 2*topk)) — concave then
    convex candidates; entries below threshold have score 0 and must be
    filtered by the host.

    NMS leaves plateaus of equal scores, and the order of the candidates
    reaches the polygons (snapping keeps the junction order). `lax.top_k`
    puts the lower index first among equal scores and `torch.topk` keeps no
    set order, so the candidates come from a stable descending sort.
    """
    B, _, H, W = jloc_softmax.shape
    topk = min(topk, H * W)  # tiny decoder maps (CPU smoke configs) have < topk pixels

    def one_class(prob):
        flat = nms_2d(prob).reshape(B, -1)
        scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        scores, idx = scores[:, :topk], idx[:, :topk]
        y = torch.div(idx, W, rounding_mode="floor").float()
        x = (idx % W).float()
        offx = torch.gather(joff[:, 0].reshape(B, -1), 1, idx)
        offy = torch.gather(joff[:, 1].reshape(B, -1), 1, idx)
        pts = torch.stack([x + offx + 0.5, y + offy + 0.5], dim=-1)
        return pts, torch.where(scores > th, scores, 0.0)

    p_cc, s_cc = one_class(jloc_softmax[:, 1])
    p_cv, s_cv = one_class(jloc_softmax[:, 2])
    return torch.cat([p_cc, p_cv], dim=1), torch.cat([s_cc, s_cv], dim=1)
