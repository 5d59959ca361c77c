"""Synthetic P3-style tiles: a frozen copy of the port's tile and LiDAR
arithmetic (`pixelspointspolygons_torch/data/synthetic.py`, generator "v2"),
so the benchmark's inputs cannot change when the program's generator does.

A tile is a 224 px aerial image with 1 to 7 rectangular or L-shaped
buildings (some crossing the tile border, some row-house pairs sharing a
wall), its LiDAR cloud of 0.5 to 1.0 x `max_points` points whose z carries
the roof heights, and its building polygons. Everything is drawn from one
`numpy.random.RandomState`, in the same order as the original, so one seed
gives the same tiles as the port's generator.
"""

from __future__ import annotations

import cv2
import numpy as np


def poly_area(pts: np.ndarray) -> float:
    """Signed shoelace area of (V, 2) (x, y) points."""
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _rot(pts: np.ndarray, angle: float, center: np.ndarray) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    return (pts - center) @ R.T + center


def clip_to_box(poly: np.ndarray, xmax: float, ymax: float) -> np.ndarray:
    """Sutherland-Hodgman clip of a polygon to [0, xmax] x [0, ymax]."""

    def clip_edge(pts, inside, intersect):
        out = []
        n = len(pts)
        for i in range(n):
            a, b = pts[i], pts[(i + 1) % n]
            ia, ib = inside(a), inside(b)
            if ia:
                out.append(a)
                if not ib:
                    out.append(intersect(a, b))
            elif ib:
                out.append(intersect(a, b))
        return np.asarray(out) if out else np.zeros((0, 2))

    def x_cut(a, b, x):
        t = (x - a[0]) / (b[0] - a[0])
        return np.array([x, a[1] + t * (b[1] - a[1])])

    def y_cut(a, b, y):
        t = (y - a[1]) / (b[1] - a[1])
        return np.array([a[0] + t * (b[0] - a[0]), y])

    for inside, cut in (
        (lambda p: p[0] >= 0, lambda a, b: x_cut(a, b, 0.0)),
        (lambda p: p[0] <= xmax, lambda a, b: x_cut(a, b, xmax)),
        (lambda p: p[1] >= 0, lambda a, b: y_cut(a, b, 0.0)),
        (lambda p: p[1] <= ymax, lambda a, b: y_cut(a, b, ymax)),
    ):
        if len(poly) < 3:
            return np.zeros((0, 2))
        poly = clip_edge(poly, inside, cut)
    if len(poly) >= 2:
        keep = np.linalg.norm(poly - np.roll(poly, 1, axis=0), axis=1) > 1e-6
        poly = poly[keep]
    return poly


def random_building(rng: np.random.RandomState, size: int, at_border: bool = False) -> np.ndarray:
    """One building polygon (V, 2) (x, y), an open ring."""
    w = rng.uniform(0.08, 0.25) * size
    h = rng.uniform(0.08, 0.25) * size
    if at_border:
        side = rng.randint(4)
        t = rng.uniform(0.15, 0.85) * size
        m = rng.uniform(-0.3, 0.2)
        if side == 0:
            cx, cy = t, m * h
        elif side == 1:
            cx, cy = t, size - 1 + (-m) * h
        elif side == 2:
            cx, cy = m * w, t
        else:
            cx, cy = size - 1 + (-m) * w, t
    else:
        cx = rng.uniform(0.15 * size, 0.85 * size)
        cy = rng.uniform(0.15 * size, 0.85 * size)
    base = np.array([[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2], [cx + w / 2, cy + h / 2],
                     [cx - w / 2, cy + h / 2]])
    if rng.rand() < 0.4:  # L-shape: a corner notch
        nx = rng.uniform(0.3, 0.6) * w
        ny = rng.uniform(0.3, 0.6) * h
        base = np.array([
            [cx - w / 2, cy - h / 2],
            [cx + w / 2, cy - h / 2],
            [cx + w / 2, cy + h / 2 - ny],
            [cx + w / 2 - nx, cy + h / 2 - ny],
            [cx + w / 2 - nx, cy + h / 2],
            [cx - w / 2, cy + h / 2],
        ])
    angle = rng.uniform(0, np.pi / 2) if rng.rand() < 0.5 else 0.0
    poly = _rot(base, angle, np.array([cx, cy]))
    return clip_to_box(poly, size - 1.0, size - 1.0)


def _poly_overlaps(poly: np.ndarray, others: list[np.ndarray], size: int) -> bool:
    m = np.zeros((size, size), np.uint8)
    cv2.fillPoly(m, [np.round(poly).astype(np.int32)], 1)
    for o in others:
        m2 = np.zeros((size, size), np.uint8)
        cv2.fillPoly(m2, [np.round(o).astype(np.int32)], 1)
        if (m & m2).any():
            return True
    return False


def generate_tile(rng: np.random.RandomState, size: int = 224, max_points: int = 60000):
    """(image uint8 (S, S, 3), points (N, 3) float32 in pixel coordinates,
    list of (V, 2) polygons)."""
    polygons: list[np.ndarray] = []
    heights: list[float] = []
    n_buildings = rng.randint(1, 8)
    for _ in range(n_buildings * 3):
        if len(polygons) >= n_buildings:
            break
        poly = random_building(rng, size, at_border=rng.rand() < 0.25)
        if len(poly) < 3 or abs(poly_area(poly)) < 40:
            continue
        if not _poly_overlaps(poly, polygons, size):
            polygons.append(poly)
            heights.append(rng.uniform(4.0, 15.0))
            if rng.rand() < 0.3:  # a row-house neighbour sharing a wall
                x1 = poly[:, 0].max()
                y0, y1 = poly[:, 1].min(), poly[:, 1].max()
                w2 = rng.uniform(0.06, 0.18) * size
                h2 = (y1 - y0) * rng.uniform(0.6, 1.0)
                yc = rng.uniform(y0, y1 - h2) if y1 - y0 > h2 else y0
                nb = np.array([[x1, yc], [x1 + w2, yc], [x1 + w2, yc + h2], [x1, yc + h2]])
                nb = clip_to_box(nb, size - 1.0, size - 1.0)
                if len(nb) >= 3 and abs(poly_area(nb)) > 40 and not _poly_overlaps(nb, polygons[:-1], size):
                    polygons.append(nb)
                    heights.append(rng.uniform(4.0, 15.0))

    img = rng.normal(110, 18, (size, size, 3)).astype(np.float32)
    img += rng.normal(0, 10, (size // 8, size // 8, 3)).repeat(8, 0).repeat(8, 1)
    hmap = np.zeros((size, size), np.float32)
    for poly, hgt in zip(polygons, heights):
        pts = np.round(poly).astype(np.int32)
        roof = np.array([120 + hgt * 6, 90 + hgt * 4, 80 + hgt * 3], np.float32)
        roof += rng.normal(0, 8, 3)
        cv2.fillPoly(hmap, [pts], float(hgt))
        mask = np.zeros((size, size), np.uint8)
        cv2.fillPoly(mask, [pts], 1)
        img[mask > 0] = roof + rng.normal(0, 4, (int(mask.sum()), 3))
        cv2.polylines(img, [pts], True, (200, 200, 200), 1)
    image = np.clip(img, 0, 255).astype(np.uint8)

    n_pts = int(rng.uniform(0.5, 1.0) * max_points)
    xy = rng.uniform(0, size - 1e-3, (n_pts, 2)).astype(np.float32)
    gi = np.clip(xy[:, 1].astype(int), 0, size - 1)
    gj = np.clip(xy[:, 0].astype(int), 0, size - 1)
    z = hmap[gi, gj] + rng.normal(0, 0.15, n_pts).astype(np.float32)
    z += rng.uniform(0.0, 1.5)
    points = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
    return image, points, polygons
