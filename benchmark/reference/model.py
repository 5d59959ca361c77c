"""Plain PyTorch Pix2Poly, the benchmark's reference: the image encoder
(ViT-S/8), the early-fusion encoder (pillar voxelizer, PillarFeatureNet,
fusion conv), the post-norm token decoder, the two ScoreNets, the Sinkhorn
head and the two losses, written from the published architecture
(Pix2Poly, arXiv:2412.07899; P3's early fusion, arXiv:2505.15379) with no
kernel, cache or batching of the program's.

Parameter and buffer names are those of the program's checkpoints, so one
checkpoint file, made by the benchmark, loads into both. Semantics that the
two must share, each as the published code has it: LayerNorm eps 1e-6,
exact GELU in the ViT and ReLU in the decoder, attention logits divided by
sqrt(head dim) with an additive -1e9 mask, BatchNorm with the biased batch
variance in training, the channel bottleneck 384 -> 256 as adaptive average
pooling, a pillar's first 64 points (in input order) kept, the PFN's
statistics over every point row of the batch (padding and the points past
a pillar's cap included, as zero rows).

Departures from the program, on purpose: the pillar centroids are one
`index_add_`, the pillar max is a max over a dense (pillar, slot) table, and
the decode is teacher-forced over the program's tokens, not cached.
Everything computes in the parameters' dtype (float32), with TF32 as the
caller sets it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
BN_EPS = 1e-5
NEG = -1e9


def adaptive_avg_pool_last(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """AdaptiveAvgPool1d over the last axis: output i averages
    [floor(i·n/out), ceil((i+1)·n/out))."""
    n = x.shape[-1]
    if n == out_size:
        return x
    cols = []
    for i in range(out_size):
        lo, hi = (i * n) // out_size, -((-(i + 1) * n) // out_size)
        cols.append(x[..., lo:hi].mean(dim=-1))
    return torch.stack(cols, dim=-1)


def batch_norm(x: torch.Tensor, bn: dict, training: bool) -> torch.Tensor:
    """BatchNorm over every axis but the channel axis 1; train mode uses the
    batch's mean and biased variance, eval mode the running statistics."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    if training:
        mean = x.mean(dim=dims, keepdim=True)
        var = (x - mean).square().mean(dim=dims, keepdim=True)
    else:
        mean, var = bn["running_mean"].view(shape), bn["running_var"].view(shape)
    return (x - mean) / torch.sqrt(var + BN_EPS) * bn["weight"].view(shape) + bn["bias"].view(shape)


class BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, {"weight": self.weight, "bias": self.bias, "running_mean": self.running_mean,
                              "running_var": self.running_var}, self.training)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = x @ self.weight.T
        return y if self.bias is None else y + self.bias


class LN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * self.weight + self.bias


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.o = (Linear(dim, dim) for _ in range(4))

    def forward(self, xq, xkv, bias=None):
        B, Lq, D = xq.shape
        H, Dh = self.heads, D // self.heads
        q = self.q(xq).view(B, Lq, H, Dh).transpose(1, 2)
        k = self.k(xkv).view(B, -1, H, Dh).transpose(1, 2)
        v = self.v(xkv).view(B, -1, H, Dh).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
        if bias is not None:
            logits = logits + bias
        out = torch.softmax(logits, dim=-1) @ v
        return self.o(out.transpose(1, 2).reshape(B, Lq, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.dense0, self.dense1, self.act = Linear(dim, hidden), Linear(hidden, dim), act

    def forward(self, x):
        return self.dense1(self.act(self.dense0(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.ln0, self.attn, self.ln1 = LN(dim), Attention(dim, heads), LN(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, lambda h: F.gelu(h))

    def forward(self, x):
        h = self.ln0(x)
        x = x + self.attn(h, h)
        return x + self.mlp(self.ln1(x))


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, pad: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.pad = stride, pad

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.pad)


class ViTTrunk(nn.Module):
    """CLS token, position embeddings, pre-norm blocks, final LayerNorm;
    with `patch` an 8x8 conv patch embedding of its own."""

    def __init__(self, n_tokens: int, dim: int, depth: int, heads: int, mlp_ratio: int, patch: int | None):
        super().__init__()
        self.depth = depth
        if patch:
            self.patch_embed = Conv(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens + 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, heads, mlp_ratio))
        self.norm = LN(dim)

    def forward(self, images=None, tokens=None):
        if tokens is None:
            tokens = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(tokens.shape[0], -1, -1), tokens], dim=1) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x)


class ImageEncoder(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        self.out_dim = s["decoder_dim"]
        self.vit = ViTTrunk(s["num_patches"], s["vit_dim"], s["vit_depth"], s["vit_heads"], s["vit_mlp_ratio"],
                            s["patch_size"])

    def forward(self, batch):
        return adaptive_avg_pool_last(self.vit(images=batch["images"])[:, 1:], self.out_dim)


class PFN(nn.Module):
    """Per-point Dense (no bias), BatchNorm, ReLU, the pillar max, the max
    gathered back beside each point for every layer but the last."""

    def __init__(self, channels):
        super().__init__()
        self.n = len(channels)
        cin = 8
        for i, c in enumerate(channels):
            self.add_module(f"dense{i}", Linear(cin, c, bias=False))
            self.add_module(f"bn{i}", BN(c))
            cin = 2 * c


def voxelize(points: torch.Tensor, valid: torch.Tensor, s: dict) -> dict:
    """Pillar assignment of (B, N, 3) points: a stable sort by pillar id,
    each pillar's first `cap` points kept, the decorated features
    [x, y, z, x-xc, y-yc, z-zc, x-xp, y-yp] (centroid of the kept points,
    pillar centre), zero off the kept points."""
    B, N, _ = points.shape
    vx, vy, cap = float(s["voxel_x"]), float(s["voxel_y"]), int(s["max_points_per_voxel"])
    nx, ny = int(round(s["width"] / vx)), int(round(s["height"] / vy))
    n_cells = nx * ny
    ix = torch.floor(points[..., 0] / vx).long()
    iy = torch.floor(points[..., 1] / vy).long()
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & valid
    pid = torch.where(inside, iy * nx + ix, n_cells)
    pid_s, order = torch.sort(pid, dim=1, stable=True)
    pts = torch.gather(points, 1, order[..., None].expand(-1, -1, 3))
    pos = torch.arange(N, device=points.device).expand(B, N)
    start = torch.cat([torch.ones_like(pid_s[:, :1], dtype=torch.bool), pid_s[:, 1:] != pid_s[:, :-1]], dim=1)
    rank = pos - torch.where(start, pos, 0).cummax(dim=1).values
    keep = (pid_s < n_cells) & (rank < cap)
    flat = (pid_s + torch.arange(B, device=points.device)[:, None] * (n_cells + 1)).reshape(-1)
    kf = keep.reshape(-1)
    sums = points.new_zeros((B * (n_cells + 1), 3)).index_add_(0, flat[kf], pts.reshape(-1, 3)[kf])
    counts = torch.zeros(B * (n_cells + 1), device=points.device).index_add_(
        0, flat[kf], torch.ones(int(kf.sum()), device=points.device))
    centroid = sums / counts.clamp(min=1.0)[:, None]
    c = centroid[flat].view(B, N, 3)
    cx = (pid_s % nx).to(points.dtype) * vx + vx / 2
    cy = (pid_s // nx).to(points.dtype) * vy + vy / 2
    feats = torch.cat([pts, pts - c, (pts[..., 0] - cx)[..., None], (pts[..., 1] - cy)[..., None]], dim=-1)
    return {"features": feats * keep[..., None].to(points.dtype), "keep": keep, "pid": pid_s, "rank": rank,
            "n_cells": n_cells, "nx": nx, "ny": ny, "cap": cap, "sums": sums, "counts": counts}


def pillar_max(x: torch.Tensor, vox: dict) -> torch.Tensor:
    """(B·(n_cells+1), C) max over each pillar's kept rows of x (B·N, C)
    (0 for a pillar with none), through a dense (pillar, slot) table."""
    B, N = vox["keep"].shape
    cells, cap = vox["n_cells"] + 1, vox["cap"]
    keep = vox["keep"].reshape(-1)
    pid = (vox["pid"] + torch.arange(B, device=x.device)[:, None] * cells).reshape(-1)
    slot = pid[keep] * cap + vox["rank"].reshape(-1)[keep]
    neg = torch.finfo(x.dtype).min
    table = x.new_full((B * cells * cap, x.shape[1]), neg).index_put((slot,), x[keep])
    pooled = table.view(B * cells, cap, -1).amax(dim=1)
    return torch.where(pooled > neg / 2, pooled, 0.0)


class FusionEncoder(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        dim = s["vit_dim"]
        self.s, self.out_dim = s, s["decoder_dim"]
        self.patch_embed = Conv(3, dim, s["patch_size"], stride=s["patch_size"])
        self.pillar_canvas = nn.Module()
        self.pillar_canvas.pfn = PFN(tuple(s["pfn_channels"]))
        self.fusion_conv = Conv(2 * dim, dim, 3, pad=1)
        self.fusion_bn = BN(dim)
        self.vit = ViTTrunk(s["num_patches"], dim, s["vit_depth"], s["vit_heads"], s["vit_mlp_ratio"], None)

    def canvas(self, points, valid):
        vox = voxelize(points, valid, self.s)
        B, N = valid.shape
        pfn = self.pillar_canvas.pfn
        keep = vox["keep"].reshape(-1, 1).to(points.dtype)
        # a point that is not kept reads its sample's empty dump cell: zero
        cell = torch.where(vox["keep"], vox["pid"], vox["n_cells"])
        pid = (cell + torch.arange(B, device=points.device)[:, None] * (vox["n_cells"] + 1)).reshape(-1)
        x = vox["features"].reshape(B * N, -1)
        for i in range(pfn.n):
            dense, bn = getattr(pfn, f"dense{i}"), getattr(pfn, f"bn{i}")
            x = F.relu(bn(dense(x))) * keep
            pooled = pillar_max(x, vox)
            if i < pfn.n - 1:
                x = torch.cat([x, pooled[pid]], dim=-1)
        canvas = pooled.view(B, vox["n_cells"] + 1, -1)[:, : vox["n_cells"]]
        return canvas.reshape(B, vox["ny"], vox["nx"], -1), vox

    def forward(self, batch):
        x_img = self.patch_embed(batch["images"].permute(0, 3, 1, 2))
        canvas, _ = self.canvas(batch["lidar"], batch["lidar_mask"])
        x = torch.cat([x_img, canvas.permute(0, 3, 1, 2)], dim=1)
        x = F.relu(self.fusion_bn(self.fusion_conv(x)))
        x = self.vit(tokens=x.flatten(2).transpose(1, 2))[:, 1:]
        return adaptive_avg_pool_last(x, self.out_dim)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn, self.cross_attn = Attention(dim, heads), Attention(dim, heads)
        self.ffn = Mlp(dim, ffn, F.relu)
        self.norm1, self.norm2, self.norm3 = LN(dim), LN(dim), LN(dim)

    def forward(self, x, memory, bias):
        x = self.norm1(x + self.self_attn(x, x, bias))
        x = self.norm2(x + self.cross_attn(x, memory))
        return self.norm3(x + self.ffn(x))


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    def forward(self, idx):
        return self.weight[idx]


class Decoder(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        dim, self.n_layers = s["decoder_dim"], s["decoder_layers"]
        self.embedding = Embedding(s["vocab_size"], dim)
        self.decoder_pos_embed = nn.Parameter(torch.zeros(1, s["max_len"] - 1, dim))
        self.encoder_pos_embed = nn.Parameter(torch.zeros(1, s["num_patches"], dim))
        for i in range(self.n_layers):
            self.add_module(f"layer{i}", DecoderLayer(dim, s["decoder_heads"], s["decoder_ffn"]))
        self.output = Linear(dim, s["vocab_size"])

    def forward(self, enc, tgt, pad_idx: int | None):
        """Teacher-forced pass over tgt (B, L): (logits, features). PAD
        inputs are masked as keys where `pad_idx` is given (training); the
        greedy decode masks nothing but the future."""
        L = tgt.shape[1]
        x = self.embedding(tgt) + self.decoder_pos_embed[:, :L]
        memory = enc + self.encoder_pos_embed
        bias = torch.zeros(L, L, device=tgt.device).masked_fill(
            torch.ones(L, L, dtype=torch.bool, device=tgt.device).triu(1), NEG)[None, None]
        if pad_idx is not None:
            bias = bias + torch.zeros(tgt.shape, device=tgt.device).masked_fill(tgt == pad_idx, NEG)[:, None, None]
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, memory, bias)
        return self.output(x), x


class ScoreNet(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        chans = (2 * dim, 256, 128, 64)
        for i in range(3):
            self.add_module(f"dense{i}", Linear(chans[i], chans[i + 1]))
            self.add_module(f"bn{i}", BN(chans[i + 1]))
        self.dense3 = Linear(64, 1)

    def forward(self, feats):
        x = feats[:, 1:]
        B, L, D = x.shape
        x = x.reshape(B, L // 2, 2, D).mean(dim=2)
        V = x.shape[1]
        x = torch.cat([x[:, :, None].expand(B, V, V, D), x[:, None].expand(B, V, V, D)], dim=-1)
        for i in range(3):
            x = getattr(self, f"dense{i}")(x)
            x = F.relu(getattr(self, f"bn{i}")(x.reshape(-1, x.shape[-1])).reshape(x.shape))
        return self.dense3(x)[..., 0]


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor, iters: int) -> torch.Tensor:
    """SuperGlue's Sinkhorn with a dustbin row and column of score alpha, in
    log space; (B, M+1, N+1)."""
    b, m, n = scores.shape
    one = scores.new_tensor(1.0)
    ms, ns = one * m, one * n
    bins0 = alpha.expand(b, m, 1)
    bins1 = alpha.expand(b, 1, n)
    couplings = torch.cat([torch.cat([scores, bins0], -1), torch.cat([bins1, alpha.expand(b, 1, 1)], -1)], 1)
    norm = -(ms + ns).log()
    log_mu = torch.cat([norm.expand(m), ns.log()[None] + norm])
    log_nu = torch.cat([norm.expand(n), ms.log()[None] + norm])
    u = torch.zeros(b, m + 1, device=scores.device, dtype=scores.dtype)
    v = torch.zeros(b, n + 1, device=scores.device, dtype=scores.dtype)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm


class Pix2Poly(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        self.s = s
        self.encoder = FusionEncoder(s) if s["encoder"] == "early_fusion_vit" else ImageEncoder(s)
        self.decoder = Decoder(s)
        self.scorenet1, self.scorenet2 = ScoreNet(s["decoder_dim"]), ScoreNet(s["decoder_dim"])
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def raw_scores(self, feats):
        return self.scorenet1(feats) + self.scorenet2(feats).transpose(1, 2)

    def forward(self, batch, y_in, pad_idx):
        logits, feats = self.decoder(self.encoder(batch), y_in, pad_idx)
        scores = self.raw_scores(feats)
        Z = log_optimal_transport(scores, self.bin_score, self.s["sinkhorn_iterations"])
        return logits, torch.softmax(Z[:, :-1, :-1], dim=-1)


def losses(logits, perm, y, y_perm, pad_idx: int, vertex_w: float, perm_w: float) -> dict:
    """Cross-entropy over the non-PAD target tokens and the binary
    cross-entropy of the Sinkhorn permutation (probabilities clipped to
    [1e-7, 1 - 1e-7])."""
    targets = y[:, 1:]
    mask = (targets != pad_idx).to(logits.dtype)
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, targets[..., None])[..., 0]
    ce = (ce * mask).sum() / mask.sum().clamp(min=1.0)
    p = perm.clamp(1e-7, 1.0 - 1e-7)
    bce = -(y_perm * torch.log(p) + (1.0 - y_perm) * torch.log(1.0 - p)).mean()
    return {"loss": vertex_w * ce + perm_w * bce, "vertex_loss": ce, "perm_loss": bce}
