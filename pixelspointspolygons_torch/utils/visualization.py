"""Debug plots — port of pixelspointspolygons_tpu/utils/visualization.py
(reference misc/debug_visualisations.py:9-359): point clouds, polygons over
images, masks, crossfield arrows; and the figure of a val prediction that
the Pix2Poly trainer logs each val epoch (`prediction_figure`).

The JAX package draws with matplotlib, which the card's machine lacks; here
each plot is drawn with cv2 on a canvas of about the JAX figure's 780 px
(6 inches at 130 dpi), with y pointing down and matplotlib's colours, and
written to the same file. `denormalize_image` is JAX's arithmetic.
"""

from __future__ import annotations

import os
from typing import Optional

import cv2
import numpy as np

_PLOT_SIZE = 780  # px: the JAX figure's 6 inches at 130 dpi
# matplotlib's tab:orange, tab:green, tab:red, tab:blue, as BGR
_ORANGE, _GREEN, _RED, _BLUE = (14, 127, 255), (44, 160, 44), (40, 39, 214), (180, 119, 31)
# matplotlib's default colour cycle (tab10), as BGR
_TAB10 = [
    (180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214), (189, 103, 148),
    (75, 86, 140), (194, 119, 227), (127, 127, 127), (34, 189, 188), (207, 190, 23),
]
_SHIFT = 4  # fractional bits of the drawn coordinates: vertices keep their sub-pixel position


def denormalize_image(image: np.ndarray, mean, std, max_pixel_value: float = 255.0) -> np.ndarray:
    """Invert the Normalize transform for display (shared_utils.py:50)."""
    img = np.asarray(image, np.float32)
    img = (img * np.asarray(std) + np.asarray(mean)) * max_pixel_value
    if max_pixel_value > 1.5:
        img = img / 255.0
    return np.clip(img, 0, 1)


def _canvas(image: Optional[np.ndarray], extent: float) -> tuple[np.ndarray, float]:
    """A BGR canvas of about _PLOT_SIZE px: the image (RGB in [0, 1], or
    uint8) scaled up, or white over [0, extent]; and the scale from data to
    canvas pixels."""
    if image is not None:
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        scale = max(_PLOT_SIZE // max(img.shape[:2]), 1)
        base = np.ascontiguousarray(img[..., ::-1])
        return cv2.resize(base, None, fx=scale, fy=scale, interpolation=cv2.INTER_NEAREST), float(scale)
    scale = _PLOT_SIZE / max(float(extent), 1.0)
    return np.full((_PLOT_SIZE, _PLOT_SIZE, 3), 255, np.uint8), scale


def _fixed(points: np.ndarray, scale: float) -> np.ndarray:
    return np.round(np.asarray(points, np.float64) * scale * (1 << _SHIFT)).astype(np.int32)


def _extent(polygons: list) -> float:
    pts = [np.asarray(p, np.float64).reshape(-1, 2) for p in polygons if len(p)]
    return float(max((p.max() for p in pts), default=1.0)) + 1.0


def prediction_figure(image: Optional[np.ndarray], polygons: list, size: int = 400,
                      extent: Optional[float] = None) -> np.ndarray:
    """RGB uint8 figure of about `size` px (the JAX trainer's 4-inch figure
    at 100 dpi is 400, trainer_pix2poly.py:168-195; the predictors' 6-inch
    one at 150 dpi 900): the image min-max normalized, or white over
    [0, extent] (default: the polygons' extent), scaled up by a whole
    factor, and each ring (x, y) with its vertices in matplotlib's colour
    cycle."""
    if image is not None:
        img = np.asarray(image, np.float32)
        img = img - img.min()
        img = img / max(float(img.max()), 1e-6)
        base = np.ascontiguousarray((img * 255).round().astype(np.uint8)[..., ::-1])
    else:
        side = int(np.ceil(extent or _extent(polygons)))
        base = np.full((side, side, 3), 255, np.uint8)
    scale = max(size // max(base.shape[:2]), 1)
    canvas = cv2.resize(base, None, fx=scale, fy=scale, interpolation=cv2.INTER_NEAREST)
    width = max(size // 450, 1)
    for k, poly in enumerate(polygons):
        p = _fixed(poly, scale)
        if len(p) < 2:
            continue
        color = _TAB10[k % len(_TAB10)]
        cv2.polylines(canvas, [p], True, color, width, cv2.LINE_AA, shift=_SHIFT)
        for q in p:
            cv2.circle(canvas, (int(q[0]), int(q[1])), (2 * width) << _SHIFT, color, -1, cv2.LINE_AA, shift=_SHIFT)
    return np.ascontiguousarray(canvas[..., ::-1])


def plot_image(image: np.ndarray, out_file: str) -> None:
    canvas, _ = _canvas(image if image.dtype == np.uint8 else np.clip(image, 0, 1), 1.0)
    _save(canvas, out_file)


def plot_point_cloud(points: np.ndarray, out_file: str, size: float = 0.3) -> None:
    """Top-down scatter coloured by z with viridis (debug_visualisations
    plot_point_cloud), equal aspect, y pointing down."""
    pts = np.asarray(points, np.float64)
    lo = pts[:, :2].min(axis=0) if len(pts) else np.zeros(2)
    extent = float((pts[:, :2] - lo).max()) + 1e-9 if len(pts) else 1.0
    canvas, scale = _canvas(None, extent)
    if len(pts):
        z = pts[:, 2]
        level = np.round(255 * (z - z.min()) / max(float(np.ptp(z)), 1e-12)).astype(np.uint8)
        colors = cv2.applyColorMap(level[:, None], cv2.COLORMAP_VIRIDIS)[:, 0]
        xy = np.clip(np.round((pts[:, :2] - lo) * scale).astype(np.int64), 0, _PLOT_SIZE - 1)
        radius = max(int(round(size)), 0)
        if radius == 0:
            canvas[xy[:, 1], xy[:, 0]] = colors
        else:
            for (x, y), c in zip(xy, colors):
                cv2.circle(canvas, (int(x), int(y)), radius, tuple(int(v) for v in c), -1)
    _save(canvas, out_file)


def _dashed_ring(canvas: np.ndarray, ring: np.ndarray, color, dash: float = 10.0) -> None:
    """A closed ring (canvas pixels) drawn as dashes of `dash` px."""
    for a, b in zip(ring, np.roll(ring, -1, axis=0)):
        n = max(int(np.hypot(*(b - a)) // dash), 1)
        for t in range(0, n, 2):
            p = a + (b - a) * t / n
            q = a + (b - a) * min(t + 1, n) / n
            cv2.line(canvas, tuple(int(v) for v in np.round(p)), tuple(int(v) for v in np.round(q)), color, 1,
                     cv2.LINE_AA)


def plot_polygons(
    polygons: list, out_file: str, image: Optional[np.ndarray] = None, gt: Optional[list] = None
) -> None:
    """Predicted rings (x, y) in orange with their vertices, the ground
    truth's dashed in green, over the image or white."""
    canvas, scale = _canvas(None if image is None else np.clip(image, 0, 1),
                            _extent(list(polygons) + list(gt or [])))
    for poly in polygons:
        p = _fixed(poly, scale)
        if len(p) < 2:
            continue
        cv2.polylines(canvas, [p], True, _ORANGE, 2, cv2.LINE_AA, shift=_SHIFT)
        for q in p:
            cv2.circle(canvas, (int(q[0]), int(q[1])), 2 << _SHIFT, _ORANGE, -1, cv2.LINE_AA, shift=_SHIFT)
    for poly in gt or []:
        p = np.asarray(poly, np.float64) * scale
        if len(p) >= 2:
            _dashed_ring(canvas, p, _GREEN)
    _save(canvas, out_file)


def plot_mask(mask: np.ndarray, out_file: str) -> None:
    """The mask in grey, min-max scaled as matplotlib's imshow scales it."""
    m = np.asarray(mask, np.float64)
    m = (m - m.min()) / max(float(np.ptp(m)), 1e-12)
    canvas, _ = _canvas(m.astype(np.float32), 1.0)
    _save(canvas, out_file)


def plot_crossfield(
    crossfield: np.ndarray, out_file: str, stride: int = 8, image: Optional[np.ndarray] = None
) -> None:
    """Arrows of the u (red) and v (blue) directions of a (4, H, W)
    crossfield every `stride` pixels (debug_visualisations.py:206
    plot_crossfield)."""
    from ..predict.ffl_polygonize import c0c2_to_uv_numpy

    u, v = c0c2_to_uv_numpy(np.asarray(crossfield))
    H, W = u.shape
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    canvas, scale = _canvas(None if image is None else np.clip(image, 0, 1), float(max(H, W)))
    length = 0.8 * stride * scale  # an arrow spans most of its cell
    for field, color in ((u, _RED), (v, _BLUE)):
        d = field[ys, xs]
        # field components are (di, dj): the arrow is (dx, dy) = (dj, di)
        for x, y, dx, dy in zip(xs.ravel(), ys.ravel(), d.imag.ravel(), d.real.ravel()):
            start = np.array([x, y], np.float64) * scale
            end = start + length * np.array([dx, dy])
            cv2.arrowedLine(canvas, tuple(int(c) for c in np.round(start)), tuple(int(c) for c in np.round(end)),
                            color, 1, cv2.LINE_AA, tipLength=0.3)
    _save(canvas, out_file)


def _save(canvas: np.ndarray, out_file: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    if not cv2.imwrite(out_file, canvas):
        raise OSError(f"could not write {out_file}")
