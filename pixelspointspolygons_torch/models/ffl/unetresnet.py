"""UNet over a ResNet trunk (FFL's `unetresnet101`) — port of
pixelspointspolygons_tpu/models/ffl/unetresnet.py (`Bottleneck`,
`UNetResNetEncoder`, :20-77): ResNet bottleneck stages (ResNet101's
(3, 4, 23, 3) at base width 64 by default) and a UNet decoder that climbs
back to the input's resolution through six skips (the input, the stem and
the four stages).

flax's "SAME" padding puts the odd pixel after: the 7×7/2 stem on 224 pads
(2, 3), a 3×3/2 convolution on an even size (0, 1), and the 3×3/2 max pool
pads (0, 1) with -inf. Torch's symmetric `padding=` would sample another
grid, so every convolution here is `layers.SameConv2d` and the pool
`layers.max_pool_same`.

Module names are the flax auto-names as `utils/bridge.py` maps them: the
stem `conv0`/`bn0`, `Bottleneck_k` → `block{k}` numbered over all stages,
the decoder's `conv1`…`conv5`/`bn1`…`bn5` and the last `conv6`/`bn6`; in a
block `conv0`…`conv2`/`bn0`…`bn2` and the projection shortcut
`conv3`/`bn3`. The encoder takes and gives NHWC; inside, NCHW views in the
channels_last layout. `dtype` is the compute dtype, as in the other
encoders.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm, SameConv2d, max_pool_same, resize_bilinear


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride) → 1×1 to 4·ch, each with BatchNorm, and a 1×1
    projection shortcut with BatchNorm where the width or the stride
    changes."""

    def __init__(self, cin: int, ch: int, stride: int = 1, dtype=None, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        bn = dict(dtype=dtype, device=device)
        self.conv0, self.bn0 = SameConv2d(cin, ch, 1, **kw), BatchNorm(ch, **bn)
        self.conv1, self.bn1 = SameConv2d(ch, ch, 3, stride, **kw), BatchNorm(ch, **bn)
        self.conv2, self.bn2 = SameConv2d(ch, 4 * ch, 1, **kw), BatchNorm(4 * ch, **bn)
        self.project = cin != 4 * ch or stride != 1
        if self.project:
            self.conv3, self.bn3 = SameConv2d(cin, 4 * ch, 1, stride, **kw), BatchNorm(4 * ch, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn0(self.conv0(x)))
        h = F.relu(self.bn1(self.conv1(h)))
        h = self.bn2(self.conv2(h))
        if self.project:
            x = self.bn3(self.conv3(x))
        return F.relu(x + h)


class UNetResNetEncoder(nn.Module):
    """(B, S, S, 3) → (B, S, S, out_dim)."""

    def __init__(self, in_size: int = 512, out_dim: int = 32, base_width: int = 64,
                 stage_blocks: Sequence[int] = (3, 4, 23, 3), dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.in_size = in_size
        self.conv0 = SameConv2d(3, base_width, 7, 2, bias=False, **kw)
        self.bn0 = BatchNorm(base_width, **kw)
        widths = [base_width * 2 ** i for i in range(4)]
        cin, k = base_width, 0
        for si, (n, ch) in enumerate(zip(stage_blocks, widths)):
            for bi in range(n):
                self.add_module(f"block{k}", Bottleneck(cin, ch, 2 if (bi == 0 and si > 0) else 1, **kw))
                cin, k = 4 * ch, k + 1
        self.n_blocks = k
        self.stage_ends = {sum(stage_blocks[:i + 1]) - 1 for i in range(len(stage_blocks))}
        # the decoder from the last stage up through s3, s2, s1, the stem and the input
        skips = [4 * w for w in reversed(widths[:-1])] + [base_width, 3]
        for level, skip in enumerate(skips, start=1):
            ch = max(out_dim, skip)
            self.add_module(f"conv{level}", SameConv2d(cin + skip, ch, 3, bias=False, **kw))
            self.add_module(f"bn{level}", BatchNorm(ch, **kw))
            cin = ch
        self.n_levels = len(skips)
        last = self.n_levels + 1
        self.add_module(f"conv{last}", SameConv2d(cin, out_dim, 3, **kw))
        self.add_module(f"bn{last}", BatchNorm(out_dim, **kw))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        stem = F.relu(self.bn0(self.conv0(x)))  # 1/2
        skips = [x, stem]
        x = max_pool_same(stem, 3, 2)  # 1/4
        for k in range(self.n_blocks):
            x = getattr(self, f"block{k}")(x)
            if k in self.stage_ends:
                skips.append(x)
        # skips: [input (1), stem (1/2), s1 (1/4), s2 (1/8), s3 (1/16), s4 (1/32)]
        x = skips[-1]
        for level, skip in enumerate(reversed(skips[:-1]), start=1):
            x = torch.cat([resize_bilinear(x, skip.shape[-1]), skip], dim=1)
            x = F.relu(getattr(self, f"bn{level}")(getattr(self, f"conv{level}")(x)))
        last = self.n_levels + 1
        x = F.relu(getattr(self, f"bn{last}")(getattr(self, f"conv{last}")(x)))
        return x.permute(0, 2, 3, 1)
