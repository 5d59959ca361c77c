"""HiSup host-side polygonization: mask components → lattice boundary
tracing → junction snapping → angle simplification. The port's own copy of
pixelspointspolygons_tpu/predict/hisup_polygon.py (cv2/numpy/scipy, no
torch).

Behavioral spec (reference models/hisup/polygon.py, re-implemented on
cv2/numpy without skimage/shapely):
- per connected component of (remask > 0.5): trace the pixel-boundary
  polygon on the half-integer lattice (ext_c_to_poly_coco :56-69 — the mask
  is dilated one pixel down-right so contour coordinates land on pixel
  corners, then diagonal steps are squared off, diagonal_to_square :71-95);
- inner contours (holes, area ≥ 50) traced analogously (:97-109);
- boundary vertices within 5 px of a predicted junction are snapped to the
  (order-preserved, deduplicated) junction sequence when >2 match (:158-164);
- near-collinear vertices (<10° direction change) are dropped
  (simple_polygon :111-125);
- component score = mean remask probability over the component.

The production path is vectorized and crops every per-component operation
to the component's bounding box. `reference_mirror=True` keeps the
loop-per-point, full-tile variant that mirrors the reference's polygon.py;
both give identical output, and the tests use the mirror as the oracle.
"""

from __future__ import annotations

import cv2
import numpy as np
from scipy.spatial.distance import cdist

from .ffl_polygonize import douglas_peucker


def diagonal_to_square_loop(poly: np.ndarray) -> np.ndarray:
    """Reference-mirror per-point loop (reference polygon.py:71-95); see
    diagonal_to_square for the vectorized production equivalent."""
    out = []
    for i, p in enumerate(poly[:-1]):
        q = poly[i + 1]
        dx, dy = q[0] - p[0], q[1] - p[1]
        if abs(dx) + abs(dy) <= 1:
            out.append(p)
        elif dx == 1 and dy == 1:
            out.append(p)
            out.append([p[0] + 1, p[1]])
        elif dx == -1 and dy == -1:
            out.append(p)
            out.append([p[0] - 1, p[1]])
        elif dx == 1 and dy == -1:
            out.append(p)
            out.append([p[0], p[1] - 1])
        else:
            out.append(p)
            out.append([p[0], p[1] + 1])
    out = np.asarray(out)
    return np.concatenate([out, out[:1]], axis=0)


def diagonal_to_square(poly: np.ndarray) -> np.ndarray:
    """Insert lattice corners so every step is axis-aligned (closed input).
    Vectorized: one extra vertex per diagonal step, scattered in place."""
    p = np.asarray(poly[:-1])
    d = np.asarray(poly[1:]) - p
    diag = (np.abs(d[:, 0]) + np.abs(d[:, 1])) > 1
    if not diag.any():
        out = p
    else:
        pp = (d[:, 0] == 1) & (d[:, 1] == 1)
        mm = (d[:, 0] == -1) & (d[:, 1] == -1)
        pm = (d[:, 0] == 1) & (d[:, 1] == -1)
        off = np.zeros_like(p)
        off[diag] = (0, 1)  # the reference's else-branch default
        off[pp] = (1, 0)
        off[mm] = (-1, 0)
        off[pm] = (0, -1)
        counts = 1 + diag.astype(np.int64)
        starts = np.cumsum(counts) - counts
        out = np.empty((int(counts.sum()), 2), p.dtype)
        out[starts] = p
        out[starts[diag] + 1] = (p + off)[diag]
    return np.concatenate([out, out[:1]], axis=0)


def _square(poly: np.ndarray, reference_mirror: bool) -> np.ndarray:
    return diagonal_to_square_loop(poly) if reference_mirror else diagonal_to_square(poly)


def ext_contour_to_poly(
    contour: np.ndarray, im_h: int, im_w: int, reference_mirror: bool = False
) -> np.ndarray:
    mask = np.zeros((im_h + 1, im_w + 1), np.uint8)
    cv2.drawContours(mask, [contour.reshape(-1, 1, 2).astype(np.int32)], -1, 1, -1)
    t = mask.copy()
    fy, fx = np.where(mask == 1)
    t[np.minimum(fy + 1, im_h), fx] = 1
    t[fy, np.minimum(fx + 1, im_w)] = 1
    t[np.minimum(fy + 1, im_h), np.minimum(fx + 1, im_w)] = 1
    cs, _ = cv2.findContours(t, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    c = cs[0].reshape(-1, 2)
    poly = np.concatenate([c, c[:1]], axis=0)
    return _square(poly, reference_mirror)


def inn_contour_to_poly(
    contour: np.ndarray, im_h: int, im_w: int, reference_mirror: bool = False
) -> np.ndarray:
    mask = np.zeros((im_h + 1, im_w + 1), np.uint8)
    cv2.drawContours(mask, [contour.reshape(-1, 1, 2).astype(np.int32)], -1, 1, -1)
    t = mask.copy()
    fy, fx = np.where(mask == 1)
    t[fy[fy == fy.min()], fx[fy == fy.min()]] = 0
    t[fy[fx == fx.min()], fx[fx == fx.min()]] = 0
    cs, _ = cv2.findContours(t, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    if not cs:
        return np.zeros((0, 2))
    c = cs[0].reshape(-1, 2)[::-1]
    poly = np.concatenate([c, c[:1]], axis=0)
    return _square(poly, reference_mirror)


def simple_polygon(poly: np.ndarray, thres: float = 10.0) -> np.ndarray:
    """Drop vertices whose incident edges differ by < thres degrees."""
    if len(poly) >= 2 and (poly[0] == poly[-1]).all():
        poly = poly[:-1]
    if len(poly) < 3:
        return np.concatenate([poly, poly[:1]], axis=0) if len(poly) else poly
    vec0 = np.roll(poly, -1, axis=0) - poly
    vec1 = np.roll(vec0, -1, axis=0)
    a0 = np.degrees(np.arctan2(vec0[:, 1], vec0[:, 0]))
    a1 = np.degrees(np.arctan2(vec1[:, 1], vec1[:, 0]))
    ang = np.abs(a0 - a1)
    keep = np.roll((ang > thres) & (ang < 360 - thres), 1, axis=0)
    out = poly[keep]
    if len(out) == 0:
        return np.zeros((0, 2))
    return np.concatenate([out, out[:1]], axis=0)


def snap_to_junctions(
    poly: np.ndarray, junctions: np.ndarray, radius: float = 5.0
) -> tuple[np.ndarray, bool]:
    """Replace a traced boundary with the ordered nearby-junction cycle.
    Returns (ring, snapped)."""
    if len(junctions) == 0 or len(poly) == 0:
        return poly, False
    d = cdist(poly, junctions)
    match = d.argmin(1)
    dist = d[np.arange(len(match)), match]
    close = match[dist < radius]
    u, ind = np.unique(close, return_index=True)
    if len(u) > 2:
        pp = junctions[u[np.argsort(ind)]]
        return np.concatenate([pp, pp[:1]], axis=0), True
    return poly, False


def polygons_from_masks(
    remask: np.ndarray,
    junctions: np.ndarray,
    min_hole_area: float = 50.0,
    dp_tol: float = 1.0,
    reference_mirror: bool = False,
) -> tuple[list[np.ndarray], list[float]]:
    """remask: (H, W) prob map; junctions: (J, 2) xy. Returns (rings, scores);
    rings are open (x, y) polygons, exterior rings only in ring list, holes
    appended as separate rings (matching the reference's flat 'poly' output).

    reference_mirror=True runs the full-tile, loop-per-point variant that
    mirrors reference polygon.py's cost shape; both variants produce
    identical output (tests/test_torch_predict.py pins this)."""
    H, W = remask.shape
    binary = (remask > 0.5).astype(np.uint8)
    polys: list[np.ndarray] = []
    scores: list[float] = []

    if reference_mirror:
        n, labels = cv2.connectedComponents(binary)
        comps = []
        for comp in range(1, n):
            comp_mask = (labels == comp).astype(np.uint8)
            if comp_mask.sum() == 0:
                continue
            score = float(remask[comp_mask > 0].mean())
            comps.append((comp_mask, score, 0, 0, H, W))
    else:
        # crop every per-component op to the component's bounding box: the
        # full-tile rescan per component was O(n_components · H · W)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(binary)
        comps = []
        for comp in range(1, n):
            x, y, w, h, area = stats[comp]
            if area == 0:
                continue
            sub = (labels[y : y + h, x : x + w] == comp).astype(np.uint8)
            score = float(remask[y : y + h, x : x + w][sub > 0].mean())
            comps.append((sub, score, x, y, h, w))

    for comp_mask, score, ox, oy, ch, cw in comps:
        contours, hierarchy = cv2.findContours(
            comp_mask, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE
        )
        if hierarchy is None:
            continue
        comp_rings: list[np.ndarray] = []
        for contour, h in zip(contours, hierarchy[0]):
            contour = contour.reshape(-1, 2)
            if h[3] == -1:
                ring = ext_contour_to_poly(contour, ch, cw, reference_mirror)
            else:
                if cv2.contourArea(contour.astype(np.int32)) < min_hole_area:
                    continue
                ring = inn_contour_to_poly(contour, ch, cw, reference_mirror)
            if len(ring) <= 3:
                continue
            ring = ring.astype(np.float64)
            ring[:, 0] += ox
            ring[:, 1] += oy
            ring, snapped = snap_to_junctions(ring, junctions)
            if not snapped and dp_tol > 0:
                # unsnapped boundaries are 1-px lattice staircases where every
                # vertex is a 90-degree turn simple_polygon keeps — DP first
                ring = douglas_peucker(ring, dp_tol)
            ring = simple_polygon(ring, thres=10)
            if len(ring) > 3:
                comp_rings.append(ring[:-1])  # open ring
        if comp_rings:
            polys.append(comp_rings[0])
            scores.append(score)
            for hole in comp_rings[1:]:
                polys.append(hole)
                scores.append(score)
    return polys, scores
