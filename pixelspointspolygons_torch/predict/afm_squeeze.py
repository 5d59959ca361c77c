"""AFM → line segments ("squeeze" region growing) — the port's own numpy
copy of pixelspointspolygons_tpu/predict/afm_squeeze.py, held to it by
tests/test_torch_entrypoints.py on the same map.

The reference's Cython/C++ `squeeze.region_grow` (models/hisup/afm_module/
squeeze/kernel.cpp), consumed only by squeeze_to_lsg.py: off the train and
predict paths. Each pixel of the attraction-field map votes for a line
point p = pixel + offset with a line direction orthogonal to the offset;
points are bucketed on a grid and grown greedily into regions of aligned
neighbours (angle tolerance), each region summarized by a least-squares
segment.
"""

from __future__ import annotations

import numpy as np


def afm_to_points(afmap: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode the signed-log AFM encoding back to attraction points.

    afmap: (2, H, W) with enc(a) = -sign(a)·log(|a/size| + 1e-6).
    Returns (points (N, 2) xy, angles (N,) of the implied line direction).
    """
    _, H, W = afmap.shape
    ex, ey = afmap[0], afmap[1]
    # enc is monotone: |a| = (exp(-|enc|) - 1e-6) * size with sign -sign(enc)
    ax = -np.sign(ex) * np.maximum(np.exp(-np.abs(ex)) - 1e-6, 0.0) * W
    ay = -np.sign(ey) * np.maximum(np.exp(-np.abs(ey)) - 1e-6, 0.0) * H
    ys, xs = np.mgrid[0:H, 0:W]
    px = xs + ax
    py = ys + ay
    # line direction ⟂ offset vector
    ang = np.arctan2(ax, -ay)  # ⟂ to (ax, ay)
    mag = np.sqrt(ax**2 + ay**2)
    keep = (mag > 0.05) & (mag < max(H, W) * 0.2)
    return (
        np.stack([px[keep], py[keep]], axis=1),
        ang[keep] % np.pi,
    )


def region_grow(
    points: np.ndarray,
    angles: np.ndarray,
    cell: float = 2.0,
    angle_tol: float = np.pi / 8,
    min_points: int = 12,
) -> list[np.ndarray]:
    """Greedy growth of angle-aligned point regions → line segments
    [x1, y1, x2, y2]."""
    if len(points) == 0:
        return []
    keys = np.floor(points / cell).astype(np.int64)
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, (kx, ky) in enumerate(keys):
        buckets.setdefault((int(kx), int(ky)), []).append(i)

    used = np.zeros(len(points), bool)
    segments = []
    order = np.argsort(keys[:, 1] * 1_000_003 + keys[:, 0])
    for seed in order:
        if used[seed]:
            continue
        base_ang = angles[seed]
        region = [seed]
        used[seed] = True
        stack = [seed]
        sum_cos = np.cos(2 * base_ang)
        sum_sin = np.sin(2 * base_ang)
        while stack:
            i = stack.pop()
            kx, ky = keys[i]
            mean_ang = 0.5 * np.arctan2(sum_sin, sum_cos) % np.pi
            for nx in range(int(kx) - 1, int(kx) + 2):
                for ny in range(int(ky) - 1, int(ky) + 2):
                    for j in buckets.get((nx, ny), []):
                        if used[j]:
                            continue
                        d = abs(angles[j] - mean_ang) % np.pi
                        if min(d, np.pi - d) < angle_tol:
                            used[j] = True
                            region.append(j)
                            stack.append(j)
                            sum_cos += np.cos(2 * angles[j])
                            sum_sin += np.sin(2 * angles[j])
        if len(region) < min_points:
            continue
        pts = points[region]
        centroid = pts.mean(0)
        u, s, vt = np.linalg.svd(pts - centroid, full_matrices=False)
        direction = vt[0]
        t = (pts - centroid) @ direction
        a = centroid + t.min() * direction
        b = centroid + t.max() * direction
        if np.linalg.norm(b - a) < 2 * cell:
            continue
        segments.append(np.array([a[0], a[1], b[0], b[1]]))
    return segments


def afm_to_line_segments(afmap: np.ndarray, **kw) -> list[np.ndarray]:
    """Full squeeze pipeline: AFM (2, H, W) → list of [x1, y1, x2, y2]."""
    pts, angs = afm_to_points(afmap)
    return region_grow(pts, angs, **kw)
