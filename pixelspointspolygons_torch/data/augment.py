"""Replayable augmentations (the port's own copy of
pixelspointspolygons_tpu/data/augment.py): D4 dihedral group, ColorJitter,
GaussNoise, Normalize — numpy host-side, with ANALYTIC replay on every target type.

The reference composes albumentations' ReplayCompose and re-applies the D4
element analytically to point clouds (datasets/p3_coco.py:115-164) and to the
cross-field angle mask (:167-207). Here one sampled `params` dict drives all
targets, so replay consistency is structural instead of bolted on:

    params = sample_params(rng, aug_list)
    image  = apply_image(image, params, mean, std, max_pix)
    kps    = apply_d4_keypoints(kps, params["d4"], H, W)
    lidar  = apply_d4_lidar(lidar, params["d4"], H, W)
    angle  = apply_d4_crossfield_angle(angle, params["d4"])

D4 group elements use the albumentations naming: e, r90, r180, r270, v, hvt,
h, t (the lidar/angle transform tables mirror p3_coco.py:138-207 semantics).
Rotations are counter-clockwise in (x, y) image coords (np.rot90 on arrays).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

D4_ELEMENTS = ("e", "r90", "r180", "r270", "v", "hvt", "h", "t")


def sample_params(rng: np.random.RandomState, augmentations: list[str] | None) -> dict:
    augs = augmentations or []
    p: dict = {"d4": "e", "jitter": None, "noise_sigma": None}
    if "D4" in augs:
        p["d4"] = D4_ELEMENTS[rng.randint(len(D4_ELEMENTS))]
    if "ColorJitter" in augs:
        # albumentations A.ColorJitter() defaults (build_datasets.py:60):
        # brightness/contrast/saturation factors U[0.8, 1.2], hue U[-0.2, 0.2]
        # (fraction of the hue circle, torchvision semantics)
        p["jitter"] = {
            "brightness": rng.uniform(0.8, 1.2),
            "contrast": rng.uniform(0.8, 1.2),
            "saturation": rng.uniform(0.8, 1.2),
            "hue": rng.uniform(-0.2, 0.2),
        }
    if "GaussNoise" in augs:
        # A.GaussNoise() default var_limit=(10, 50) on 0-255 pixels
        # → sigma ∈ [sqrt(10), sqrt(50)]/255 on the unit scale
        p["noise_sigma"] = rng.uniform(np.sqrt(10.0), np.sqrt(50.0)) / 255.0
    return p


# --- D4 on dense arrays (H, W[, C]) ----------------------------------------


def apply_d4_image(img: np.ndarray, g: str) -> np.ndarray:
    if g == "e":
        return img
    if g == "r90":
        return np.rot90(img, 1)
    if g == "r180":
        return np.rot90(img, 2)
    if g == "r270":
        return np.rot90(img, 3)
    if g == "v":
        return img[::-1]  # flip rows (vertical flip)
    if g == "h":
        return img[:, ::-1]  # flip cols (horizontal flip)
    if g == "t":
        return np.swapaxes(img, 0, 1)  # main-diagonal transpose
    if g == "hvt":
        return np.swapaxes(img, 0, 1)[::-1, ::-1]  # anti-diagonal transpose
    raise ValueError(g)


# --- D4 on (x, y) keypoints -------------------------------------------------


def apply_d4_keypoints(pts: np.ndarray, g: str, height: int, width: int) -> np.ndarray:
    """pts: (N, 2) as (x, y) float pixel coords."""
    if len(pts) == 0:
        return pts
    x, y = pts[:, 0].copy(), pts[:, 1].copy()
    W1, H1 = width - 1, height - 1
    if g == "e":
        pass
    elif g == "r90":  # array rot90 CCW: (x,y) -> (y, W1-x)
        x, y = y, W1 - x
    elif g == "r180":
        x, y = W1 - x, H1 - y
    elif g == "r270":
        x, y = H1 - y, x
    elif g == "v":
        y = H1 - y
    elif g == "h":
        x = W1 - x
    elif g == "t":
        x, y = y, x
    elif g == "hvt":
        x, y = H1 - y, W1 - x
    else:
        raise ValueError(g)
    return np.stack([x, y], axis=1)


def apply_d4_lidar(points: np.ndarray, g: str, height: int, width: int) -> np.ndarray:
    """points: (N, 3) as (x, y, z); the planar mapping of the keypoints, z
    unchanged (JAX :104-113; the reference's centre-relative swap table,
    p3_coco.py:138-160, is the same dihedral action)."""
    out = points.copy()
    out[:, :2] = apply_d4_keypoints(points[:, :2], g, height, width)
    return out


def apply_d4_crossfield_angle(angle: np.ndarray, g: str) -> np.ndarray:
    """Tangent angles (radians mod π) under the D4 element, applied AFTER the
    dense map itself was moved with apply_d4_image (JAX :116-139; reference
    p3_coco.py:185-205 table)."""
    if g == "e":
        return angle
    if g == "r90":
        return (angle + np.pi / 2) % np.pi
    if g == "r180":
        return (angle + np.pi) % np.pi
    if g == "r270":
        return (angle + 3 * np.pi / 2) % np.pi
    if g == "v":
        return (np.pi - angle) % np.pi
    if g == "hvt":
        return (3 * np.pi / 2 - angle) % np.pi
    if g == "h":
        return (-angle) % np.pi
    if g == "t":
        return (np.pi / 2 - angle) % np.pi
    raise ValueError(g)


# --- photometric + normalize -----------------------------------------------


def apply_image(
    img: np.ndarray,
    params: dict,
    mean,
    std,
    max_pixel_value: float,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """uint8/float (H, W, C) → float32 normalized, D4 + photometric applied."""
    out = apply_d4_image(img, params["d4"]).astype(np.float32)
    scale_255 = out.max() > 1.5 or max_pixel_value > 1.5
    unit = out / 255.0 if scale_255 else out
    if params.get("jitter"):
        j = params["jitter"]
        unit = unit * j["brightness"]
        m = unit.mean()
        unit = (unit - m) * j["contrast"] + m
        if unit.ndim == 3 and unit.shape[-1] == 3:
            sat = j.get("saturation", 1.0)
            if sat != 1.0:
                gray = (
                    0.299 * unit[..., 0] + 0.587 * unit[..., 1] + 0.114 * unit[..., 2]
                )[..., None]
                unit = gray + sat * (unit - gray)
            hue = j.get("hue", 0.0)
            if hue:
                import cv2

                hsv = cv2.cvtColor(np.clip(unit, 0, 1), cv2.COLOR_RGB2HSV)
                hsv[..., 0] = (hsv[..., 0] + hue * 360.0) % 360.0
                unit = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    if params.get("noise_sigma") and rng is not None:
        unit = unit + rng.normal(0, params["noise_sigma"], unit.shape).astype(np.float32)
    unit = np.clip(unit, 0.0, 1.0)
    out = unit * 255.0 if scale_255 else unit
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (out / max_pixel_value - mean) / std
