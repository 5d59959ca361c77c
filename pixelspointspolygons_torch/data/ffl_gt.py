"""FFL ground truth: polygon rasterization and the angle field — the port's
own copy of pixelspointspolygons_tpu/data/ffl_gt.py (numpy and cv2; the JAX
package re-implements the reference's offline FFL preprocessing,
data_preprocess/ffl/preprocess_ffl.py:32-61 with Rasterize(line_width=4) and
AngleFieldInit(line_width=6)):

- gt_polygons_image: uint8 (H, W, 3) channels [interior, edge, vertex] 0/255,
  border edge pixels zeroed (cut buildings);
- distances: float (H, W) = sum of distances to the closest and 2nd-closest
  polygon, normalized by (H + W), capped at 1 (the optional U-Net-style
  seg-loss weighting reads it);
- sizes: float (H, W) = polygon area / image area near each polygon, 1
  elsewhere;
- gt_crossfield_angle: uint8 (H, W) edge-tangent angle field, angle(ij
  coords) in [0, π) scaled to 0..255, drawn along edges with width 6.

Polygons are (V, 2) float arrays in (x, y), open rings (no repeated last
vertex).
"""

from __future__ import annotations

import numpy as np
import cv2

RASTER_LINE_WIDTH = 4
ANGLE_LINE_WIDTH = 6


def polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def draw_polygons(
    polygons: list[np.ndarray],
    shape: tuple[int, int],
    line_width: int = RASTER_LINE_WIDTH,
) -> np.ndarray:
    """(H, W, 3) uint8 raster: [interior, edges, vertices]."""
    h, w = shape
    interior = np.zeros((h, w), np.uint8)
    edge = np.zeros((h, w), np.uint8)
    vertex = np.zeros((h, w), np.uint8)
    for poly in polygons:
        pts = np.round(poly).astype(np.int32)
        cv2.fillPoly(interior, [pts], 255)
    for poly in polygons:
        pts = np.round(poly).astype(np.int32)
        cv2.polylines(edge, [pts], isClosed=True, color=255, thickness=line_width)
        for p in pts:
            cv2.circle(vertex, tuple(int(v) for v in p), max(line_width // 2, 1), 255, -1)
    # zero border edges (reference rasterize.py:99-104)
    lw = line_width
    edge[:lw] = 0
    edge[-lw:] = 0
    edge[:, :lw] = 0
    edge[:, -lw:] = 0
    return np.stack([interior, edge, vertex], axis=-1)


def compute_distances_sizes(
    polygons: list[np.ndarray], shape: tuple[int, int], line_width: int = RASTER_LINE_WIDTH
) -> tuple[np.ndarray, np.ndarray]:
    h, w = shape
    image_area = float(h * w)
    dist_maps = []
    sizes = np.ones((h, w), np.float32)
    for poly in polygons:
        if polygon_area(poly) <= 0:
            continue
        mask = np.zeros((h, w), np.uint8)
        pts = np.round(poly).astype(np.int32)
        cv2.fillPoly(mask, [pts], 1)
        cv2.polylines(mask, [pts], True, 1, line_width)
        d = cv2.distanceTransform(1 - mask, cv2.DIST_L2, 5).astype(np.float32)
        dist_maps.append(d / (h + w))
        dil = cv2.dilate(mask, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * line_width + 1,) * 2))
        sizes[dil > 0] = polygon_area(poly) / image_area
    if not dist_maps:
        return np.ones((h, w), np.float32), sizes
    stack = np.stack(dist_maps)  # (P, H, W)
    if stack.shape[0] == 1:
        dsum = stack[0] + 1.0  # 2nd-closest defaults to the max-norm value 1
    else:
        part = np.partition(stack, 1, axis=0)
        dsum = part[0] + part[1]
    return np.clip(dsum, 0.0, 1.0), sizes


def init_angle_field(
    polygons: list[np.ndarray], shape: tuple[int, int], line_width: int = ANGLE_LINE_WIDTH
) -> np.ndarray:
    """uint8 (H, W): tangent angle (ij coords, mod π) * 255/π along edges."""
    h, w = shape
    out = np.zeros((h, w), np.uint8)
    r = max(int(round(line_width / 2)), 1)
    for poly in polygons:
        ring = np.concatenate([poly, poly[:1]], axis=0)
        vect = np.diff(ring, axis=0)  # (E, 2) as (dx, dy)
        # reference angle_field_init.py:55: angle of (dy + i dx) — ij coords
        ang = np.angle(vect[:, 1] + 1j * vect[:, 0])
        ang[ang < 0] += np.pi
        first_u8 = None
        line = None
        for i in range(len(vect)):
            u8 = int(np.round(255 * ang[i] / np.pi))
            if first_u8 is None:
                first_u8 = u8
            a = tuple(np.round(ring[i]).astype(int))
            b = tuple(np.round(ring[i + 1]).astype(int))
            cv2.line(out, a, b, u8, line_width)
            cv2.circle(out, a, r, u8, -1)
            line = b
        if line is not None and first_u8 is not None:
            cv2.circle(out, line, r, first_u8, -1)
    return out


def compute_ffl_gt(polygons: list[np.ndarray], height: int, width: int) -> dict:
    """Full FFL GT dict for one tile (the offline .pt payload equivalent)."""
    shape = (height, width)
    distances, sizes = compute_distances_sizes(polygons, shape)
    return {
        "gt_polygons_image": draw_polygons(polygons, shape),
        "distances": distances,
        "sizes": sizes,
        "gt_crossfield_angle": init_angle_field(polygons, shape),
    }
