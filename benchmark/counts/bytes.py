"""The bytes that the port's two LiDAR kernels need from their inputs, each
input byte read once and each output byte written once, whatever the kernel
reads again, and their least time on an NVIDIA H100 SXM (3.35 TB/s).

- Pillar sums (`csrc/pillar_sums.cu`): the kept points' coordinates and the
  per-pillar sums and counts (B · (cells + 1) pillars, each sample's dump
  cell included).
- Run sums (`csrc/run_sums.cu`): per launch, the int64 id of every row of
  the padded clouds (what tells a kept point from the rest), the channels
  of the kept points' rows and the sums of the pillars, once each. The
  other rows (padding, points past a pillar's kept ones) only feed each
  sample's dump cell, whose sums nothing reads, so neither their channels
  nor the dump cells' sums are counted. A PillarFeatureNet train step
  launches it for each layer's tie counts and for every layer but the
  last its gather's gradient, each at the layer's width."""

from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12


def pillar_sums(kept_points: int, samples: int, cells: int, coords: int = 3, item: int = 4) -> int:
    pillars = samples * (cells + 1)
    return kept_points * coords * item + pillars * (coords * item + 4)


def run_sums(kept_rows: int, rows: int, pillars: int, channels: int, item: int = 4) -> int:
    return kept_rows * channels * item + rows * 8 + pillars * channels * item


def pfn_run_sums(kept_rows: int, rows: int, pillars: int, pfn_channels: list[int], item: int = 4) -> int:
    """The launches of PillarFeatureNet backwards over these rows: each
    layer's tie counts, and every layer but the last its gather's gradient."""
    last = len(pfn_channels) - 1
    return sum((1 if i == last else 2) * run_sums(kept_rows, rows, pillars, c, item)
               for i, c in enumerate(pfn_channels))


def least_seconds(nbytes: int) -> float:
    return nbytes / H100_HBM_BYTES_PER_S
