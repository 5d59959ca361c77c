"""HRNetV2-W48 encoder — port of pixelspointspolygons_tpu/models/hrnet.py
(`HRNetEncoder`, :165-229, and the blocks it is built from), and the
early-fusion `FusionHRNetEncoder` (:232-285).

Module names are the JAX package's (`stage3_m2.branch1_b0.conv1`,
`fuse2_0_1_conv`, `last_conv2`, ...), so `utils/bridge.py` maps a flax tree
leaf for leaf. The public forward takes and returns NHWC as the JAX module
does; inside, tensors are NCHW (the NHWC input viewed as NCHW is already in
torch's channels_last layout, which the convolutions keep).

`dtype` is the compute dtype, as flax's `dtype=` (JAX hrnet.py:69-229):
each convolution casts its input and kernel to it and gives it, each
BatchNorm computes in float32 and gives it (`layers.py`).

The align-corners bilinear resize is JAX's two products with interpolation
matrices (hrnet.py:39-66) built in the input's dtype: at bfloat16 the
weights are rounded and each product is rounded to bfloat16, which
`F.interpolate` (one rounding, exact weights) does not reproduce. At
float32 and float64 the forward is `F.interpolate(..., align_corners=True)`,
which agrees with the products to the last bits, and the backward is the
transposed products (`layers.InterpolateByProducts`), as JAX's gradient
is: `upsample_bilinear2d`'s own backward adds with atomics on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, InterpolateByProducts, cached_matrix, layout_of
from .pointpillars import PointPillarsViTEncoder


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False, dtype=None, device=None) -> Conv2d:
    # explicit symmetric k//2 padding: torch's pad-1 grid at stride 2
    return Conv2d(cin, cout, k, stride, padding=k // 2, bias=bias, dtype=dtype, device=device)


@cached_matrix
def _interp_matrix(n_out: int, n_in: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """(n_out, n_in) align-corners interpolation matrix, with JAX's
    arithmetic (hrnet.py:39-52): positions in float32, the fraction `w` and
    `1 - w` in `dtype`."""
    if n_in == 1:
        return torch.ones(n_out, 1, dtype=dtype, device=device)
    if n_out == 1:
        m = torch.zeros(1, n_in, dtype=dtype, device=device)
        m[0, 0] = 1
        return m
    pos = torch.arange(n_out, dtype=torch.float32, device=device) * (n_in - 1) / (n_out - 1)
    lo = pos.floor().long().clamp(0, n_in - 1)
    hi = (lo + 1).clamp(max=n_in - 1)
    w = (pos - lo.float()).to(dtype)
    rows = torch.arange(n_out, device=device)
    m = torch.zeros(n_out, n_in, dtype=dtype, device=device)
    m.index_put_((rows, lo), 1 - w, accumulate=True)
    m.index_put_((rows, hi), w, accumulate=True)
    return m


def resize_align_corners(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """Bilinear NCHW resize with align_corners=True."""
    H2, W2 = int(out_hw[0]), int(out_hw[1])
    H, W = x.shape[2:]
    if (H, W) == (H2, W2):
        return x
    if x.dtype in (torch.float32, torch.float64):
        return InterpolateByProducts.apply(x, _interp_matrix(H2, H, x.dtype, x.device),
                                           _interp_matrix(W2, W, x.dtype, x.device), True)
    # JAX's einsum contracts H first, then W, each product rounded to x.dtype;
    # the result in x's memory layout, as F.interpolate gives it
    y = torch.matmul(_interp_matrix(H2, H, x.dtype, x.device), x)
    y = torch.matmul(y, _interp_matrix(W2, W, x.dtype, x.device).T)
    return y.contiguous(memory_format=layout_of(x))


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual (reference hrnet48v2.py:37-66)."""

    def __init__(self, cin: int, ch: int, stride: int = 1, dtype=None, device=None):
        super().__init__()
        self.conv1 = _conv(cin, ch, 3, stride, dtype=dtype, device=device)
        self.bn1 = BatchNorm(ch, dtype=dtype, device=device)
        self.conv2 = _conv(ch, ch, 3, dtype=dtype, device=device)
        self.bn2 = BatchNorm(ch, dtype=dtype, device=device)
        self.down = stride != 1 or cin != ch
        if self.down:
            self.down_conv = _conv(cin, ch, 1, stride, dtype=dtype, device=device)
            self.down_bn = BatchNorm(ch, dtype=dtype, device=device)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + h)


class Bottleneck(nn.Module):
    """1x1 → 3x3 → 1x1(×4) + residual (reference hrnet48v2.py:69-107)."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dtype=None, device=None):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = _conv(cin, planes, 1, dtype=dtype, device=device)
        self.bn1 = BatchNorm(planes, dtype=dtype, device=device)
        self.conv2 = _conv(planes, planes, 3, stride, dtype=dtype, device=device)
        self.bn2 = BatchNorm(planes, dtype=dtype, device=device)
        self.conv3 = _conv(planes, out_ch, 1, dtype=dtype, device=device)
        self.bn3 = BatchNorm(out_ch, dtype=dtype, device=device)
        self.down = stride != 1 or cin != out_ch
        if self.down:
            self.down_conv = _conv(cin, out_ch, 1, stride, dtype=dtype, device=device)
            self.down_bn = BatchNorm(out_ch, dtype=dtype, device=device)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + h)


class HRModule(nn.Module):
    """One HighResolutionModule: per-branch residual blocks, then full
    cross-resolution fusion (reference hrnet48v2.py:110-254)."""

    def __init__(self, widths: Sequence[int], num_blocks: int = 4, dtype=None, device=None):
        super().__init__()
        self.widths = list(widths)
        self.num_blocks = num_blocks
        n = len(widths)
        for i, w in enumerate(widths):
            for k in range(num_blocks):
                self.add_module(f"branch{i}_b{k}", BasicBlock(w, w, dtype=dtype, device=device))
        if n == 1:
            return
        for i in range(n):
            for j in range(n):
                if j > i:  # coarser → finer: 1x1 conv + BN, then upsample
                    self.add_module(f"fuse{i}_{j}_conv", _conv(widths[j], widths[i], 1, dtype=dtype, device=device))
                    self.add_module(f"fuse{i}_{j}_bn", BatchNorm(widths[i], dtype=dtype, device=device))
                elif j < i:  # finer → coarser: chain of stride-2 3x3 convs
                    for k in range(i - j):
                        ch = widths[i] if k == i - j - 1 else widths[j]
                        self.add_module(f"fuse{i}_{j}_{k}_conv", _conv(widths[j], ch, 3, 2, dtype=dtype, device=device))
                        self.add_module(f"fuse{i}_{j}_{k}_bn", BatchNorm(ch, dtype=dtype, device=device))

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        n = len(self.widths)
        xs = list(xs)
        for i in range(n):
            for k in range(self.num_blocks):
                xs[i] = getattr(self, f"branch{i}_b{k}")(xs[i])
        if n == 1:
            return xs
        outs = []
        for i in range(n):
            acc = None
            for j in range(n):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = getattr(self, f"fuse{i}_{j}_bn")(getattr(self, f"fuse{i}_{j}_conv")(xs[j]))
                    t = resize_align_corners(t, xs[i].shape[2:])
                else:
                    t = xs[j]
                    for k in range(i - j):
                        t = getattr(self, f"fuse{i}_{j}_{k}_bn")(getattr(self, f"fuse{i}_{j}_{k}_conv")(t))
                        if k != i - j - 1:
                            t = F.relu(t)
                acc = t if acc is None else acc + t
            outs.append(F.relu(acc))
        return outs


class HRNetEncoder(nn.Module):
    """HRNetV2 trunk + head: (B, S, S, 3) NHWC → (B, S/4, S/4, out_dim) NHWC.

    Defaults are HRNetV2-W48; the size knobs let tests build a tiny variant
    with the same topology (as in the JAX module)."""

    def __init__(
        self,
        in_size: int = 224,
        out_dim: int = 256,
        width: int = 48,
        stage1_planes: int = 64,
        stage1_blocks: int = 4,
        num_blocks: int = 4,
        num_modules: Sequence[int] = (1, 4, 3),
        stem_ch: int = 64,
        in_ch: int = 3,
        dtype=None,
        device=None,
    ):
        super().__init__()
        self.in_size = in_size
        self.stage1_blocks = stage1_blocks
        self.num_modules = tuple(num_modules)
        self.conv1 = _conv(in_ch, stem_ch, 3, 2, dtype=dtype, device=device)
        self.bn1 = BatchNorm(stem_ch, dtype=dtype, device=device)
        self.conv2 = _conv(stem_ch, stem_ch, 3, 2, dtype=dtype, device=device)
        self.bn2 = BatchNorm(stem_ch, dtype=dtype, device=device)
        cin = stem_ch
        for k in range(stage1_blocks):
            self.add_module(f"layer1_b{k}", Bottleneck(cin, stage1_planes, dtype=dtype, device=device))
            cin = stage1_planes * 4

        widths = [width * (2**i) for i in range(1 + len(num_modules))]
        pre = [cin]
        # per stage: ("keep" | "conv" | "chain", n_chain) for each branch
        self._transitions: list[list[tuple[str, int]]] = []
        for stage, nmod in zip(range(2, 2 + len(num_modules)), num_modules):
            cur = widths[:stage]
            t_idx = stage - 1
            plan = []
            for i in range(len(cur)):
                if i < len(pre):
                    if pre[i] != cur[i]:
                        self.add_module(f"transition{t_idx}_{i}_conv", _conv(pre[i], cur[i], 3, dtype=dtype, device=device))
                        self.add_module(f"transition{t_idx}_{i}_bn", BatchNorm(cur[i], dtype=dtype, device=device))
                        plan.append(("conv", 0))
                    else:
                        plan.append(("keep", 0))
                else:  # new branch: chained stride-2 convs from the coarsest
                    n_chain = i + 1 - len(pre)
                    for j in range(n_chain):
                        ch = cur[i] if j == i - len(pre) else pre[-1]
                        self.add_module(f"transition{t_idx}_{i}_{j}_conv", _conv(pre[-1], ch, 3, 2, dtype=dtype, device=device))
                        self.add_module(f"transition{t_idx}_{i}_{j}_bn", BatchNorm(ch, dtype=dtype, device=device))
                    plan.append(("chain", n_chain))
            self._transitions.append(plan)
            for m in range(nmod):
                self.add_module(f"stage{stage}_m{m}", HRModule(cur, num_blocks, dtype=dtype, device=device))
            pre = cur
        c = sum(pre)
        self.last_conv1 = Conv2d(c, c, 1, bias=True, dtype=dtype, device=device)
        self.last_bn = BatchNorm(c, dtype=dtype, device=device)
        self.last_conv2 = Conv2d(c, out_dim, 1, bias=True, dtype=dtype, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)  # NHWC → NCHW view (channels_last strides)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for k in range(self.stage1_blocks):
            x = getattr(self, f"layer1_b{k}")(x)
        xs = [x]
        for s, (plan, nmod) in enumerate(zip(self._transitions, self.num_modules)):
            stage, t_idx = s + 2, s + 1
            new_xs = []
            for i, (kind, n_chain) in enumerate(plan):
                if kind == "keep":
                    new_xs.append(xs[i])
                elif kind == "conv":
                    h = getattr(self, f"transition{t_idx}_{i}_conv")(xs[i])
                    new_xs.append(F.relu(getattr(self, f"transition{t_idx}_{i}_bn")(h)))
                else:
                    h = xs[-1]
                    for j in range(n_chain):
                        h = getattr(self, f"transition{t_idx}_{i}_{j}_conv")(h)
                        h = F.relu(getattr(self, f"transition{t_idx}_{i}_{j}_bn")(h))
                    new_xs.append(h)
            xs = new_xs
            for m in range(nmod):
                xs = getattr(self, f"stage{stage}_m{m}")(xs)
        # HRNetV2 head (reference :521-529): concat at 1/4 res, 1x1 convs
        tgt = xs[0].shape[2:]
        x = torch.cat([xs[0]] + [resize_align_corners(h, tgt) for h in xs[1:]], dim=1)
        x = F.relu(self.last_bn(self.last_conv1(x)))
        return self.last_conv2(x).permute(0, 2, 3, 1)


class FusionHRNetEncoder(nn.Module):
    """HRNet image features ⊕ pillar-ViT LiDAR features → conv fusion (JAX
    hrnet.py:232-285; reference models/fusion_layers/fusion_hrnet.py:13-77):
    the HRNet map (B, D, S/4, S/4) (`hrnet`) and the pillar-ViT tokens
    (`pp_vit`, no bottleneck, the pillar grid over in_size x in_size) as a
    map resized align-corners to S/4, concatenated, then Conv3×3,
    BatchNorm and ReLU (`conv0`, `bn0`) → (B, S/4, S/4, out_dim) NHWC."""

    def __init__(self, in_size: int = 224, out_dim: int = 256, width: int = 48, stage1_planes: int = 64,
                 stage1_blocks: int = 4, num_blocks: int = 4, num_modules: Sequence[int] = (1, 4, 3),
                 vit_dim: int = 384, vit_depth: int = 12, voxel_x: float = 8.0, voxel_y: float = 8.0,
                 max_points_per_voxel: int = 64, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.hrnet = HRNetEncoder(in_size=in_size, out_dim=out_dim, width=width, stage1_planes=stage1_planes,
                                  stage1_blocks=stage1_blocks, num_blocks=num_blocks, num_modules=num_modules, **kw)
        self.pp_vit = PointPillarsViTEncoder(img_size=in_size, dim=vit_dim, depth=vit_depth, out_dim=None,
                                             width=float(in_size), height=float(in_size), voxel_x=voxel_x,
                                             voxel_y=voxel_y, max_points_per_voxel=max_points_per_voxel, **kw)
        self.conv0 = Conv2d(out_dim + vit_dim, out_dim, 3, padding=1, bias=True, **kw)
        self.bn0 = BatchNorm(out_dim, **kw)

    def forward(self, images: torch.Tensor, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        img_f = self.hrnet(images).permute(0, 3, 1, 2)  # (B, D, S/4, S/4)
        tokens = self.pp_vit(points, valid)
        B, N, C = tokens.shape
        g = int(round(N ** 0.5))
        lid_f = resize_align_corners(tokens.transpose(1, 2).reshape(B, C, g, g), img_f.shape[2:])
        x = torch.cat([img_f, lid_f], dim=1)
        return F.relu(self.bn0(self.conv0(x))).permute(0, 2, 3, 1)
