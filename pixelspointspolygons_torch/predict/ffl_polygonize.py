"""Polyline simplification shared with the HiSup polygonizer — the port's
copy of `douglas_peucker` from pixelspointspolygons_tpu/predict/ffl_polygonize.py
(:278-303). The rest of that module, the FFL polygonization, comes with
ROADMAP 'Port queue' item 'FFL'."""

from __future__ import annotations

import numpy as np


def douglas_peucker(points: np.ndarray, tol: float) -> np.ndarray:
    """Iterative DP simplification of an open polyline (keeps endpoints)."""
    if len(points) < 3:
        return points
    keep = np.zeros(len(points), bool)
    keep[0] = keep[-1] = True
    stack = [(0, len(points) - 1)]
    while stack:
        a, b = stack.pop()
        if b <= a + 1:
            continue
        seg = points[b] - points[a]
        seg_len = np.linalg.norm(seg)
        pts = points[a + 1 : b]
        if seg_len < 1e-12:
            d = np.linalg.norm(pts - points[a], axis=1)
        else:
            u = seg / seg_len
            rel = pts - points[a]
            d = np.abs(u[0] * rel[:, 1] - u[1] * rel[:, 0])
        i = int(np.argmax(d))
        if d[i] > tol:
            keep[a + 1 + i] = True
            stack.append((a, a + 1 + i))
            stack.append((a + 1 + i, b))
    return points[keep]
