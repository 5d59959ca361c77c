"""Procedural synthetic P3-style tile dataset — the port's own copy of
pixelspointspolygons_tpu/data/synthetic.py. The generator is unchanged, so it
writes the same tiles from the same seed and both packages share the cache
directory the config names.

Procedural synthetic P3-style tile dataset (self-contained substitute for
the downloadable P3 dataset: this environment has no network egress, so the
end-to-end train/predict/eval loop runs on generated tiles with the SAME
on-disk layout the real-dataset loader consumes: COCO json + image files +
per-tile point clouds).

Tiles contain a handful of axis-rotated rectangular / L-shaped "buildings"
rendered with per-building shading over a textured ground, plus a LiDAR
point cloud whose z values encode roof height inside building footprints —
enough signal for models to overfit quickly in debug runs and for metrics to
be meaningful.
"""

from __future__ import annotations

import json
import os

import cv2
import numpy as np

from ..utils.coco import CATEGORY_ID, poly_area


def _rot(pts: np.ndarray, angle: float, center: np.ndarray) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    return (pts - center) @ R.T + center


def clip_to_box(poly: np.ndarray, xmax: float, ymax: float) -> np.ndarray:
    """Sutherland-Hodgman clip of a polygon to [0, xmax] x [0, ymax] —
    exact geometric clipping so border-crossing buildings get valid GT rings
    (vertex np.clip would distort rotated shapes)."""
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
    # drop duplicate consecutive vertices introduced by clipping
    if len(poly) >= 2:
        keep = np.linalg.norm(poly - np.roll(poly, 1, axis=0), axis=1) > 1e-6
        poly = poly[keep]
    return poly


def random_building(
    rng: np.random.RandomState, size: int, at_border: bool = False
) -> np.ndarray:
    """One building polygon (V, 2) float (x, y), open ring, CCW-ish.
    `at_border`: center near a tile edge so the footprint crosses it (GT is
    the exact clip against the tile box — stresses the border-ring union in
    the FFL postprocess; VERDICT round-1 item 8).

    (Interior holes are deliberately NOT generated: the reference unions all
    segmentation rings into the mask — eval/utils.py:22-31 sums per-ring RLE
    masks — so multi-ring "hole" GT would rasterize filled anyway.)"""
    w = rng.uniform(0.08, 0.25) * size
    h = rng.uniform(0.08, 0.25) * size
    if at_border:
        side = rng.randint(4)
        t = rng.uniform(0.15, 0.85) * size
        m = rng.uniform(-0.3, 0.2)  # center offset beyond/near the edge
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
    base = np.array(
        [
            [cx - w / 2, cy - h / 2],
            [cx + w / 2, cy - h / 2],
            [cx + w / 2, cy + h / 2],
            [cx - w / 2, cy + h / 2],
        ]
    )
    if rng.rand() < 0.4:  # L-shape: cut a corner notch
        nx = rng.uniform(0.3, 0.6) * w
        ny = rng.uniform(0.3, 0.6) * h
        base = np.array(
            [
                [cx - w / 2, cy - h / 2],
                [cx + w / 2, cy - h / 2],
                [cx + w / 2, cy + h / 2 - ny],
                [cx + w / 2 - nx, cy + h / 2 - ny],
                [cx + w / 2 - nx, cy + h / 2],
                [cx - w / 2, cy + h / 2],
            ]
        )
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
    """Returns (image uint8 (S,S,3), points (N,3) float32, polygons list)."""
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
            # row-house pair: an axis-aligned neighbor sharing a wall
            # (touching buildings stress junction snapping / face splitting)
            if rng.rand() < 0.3:
                x1 = poly[:, 0].max()
                y0, y1 = poly[:, 1].min(), poly[:, 1].max()
                w2 = rng.uniform(0.06, 0.18) * size
                h2 = (y1 - y0) * rng.uniform(0.6, 1.0)
                yc = rng.uniform(y0, y1 - h2) if y1 - y0 > h2 else y0
                nb = np.array(
                    [[x1, yc], [x1 + w2, yc], [x1 + w2, yc + h2], [x1, yc + h2]]
                )
                nb = clip_to_box(nb, size - 1.0, size - 1.0)
                if (
                    len(nb) >= 3
                    and abs(poly_area(nb)) > 40
                    and not _poly_overlaps(nb, polygons[:-1], size)
                ):
                    polygons.append(nb)
                    heights.append(rng.uniform(4.0, 15.0))

    # ground texture
    img = rng.normal(110, 18, (size, size, 3)).astype(np.float32)
    img += rng.normal(0, 10, (size // 8, size // 8, 3)).repeat(8, 0).repeat(8, 1)
    # buildings: flat roofs with shading by height + edge highlight
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

    # lidar: uniform ground sampling, z = ground noise or roof height
    n_pts = int(rng.uniform(0.5, 1.0) * max_points)
    xy = rng.uniform(0, size - 1e-3, (n_pts, 2)).astype(np.float32)
    gi = np.clip(xy[:, 1].astype(int), 0, size - 1)
    gj = np.clip(xy[:, 0].astype(int), 0, size - 1)
    z = hmap[gi, gj] + rng.normal(0, 0.15, n_pts).astype(np.float32)
    z += rng.uniform(0.0, 1.5)  # ground offset
    points = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
    return image, points, polygons


def write_synthetic_dataset(cfg, splits=("train", "val", "test"), seed: int = 42) -> None:
    """Generate the dataset tree under cfg.experiment.dataset.in_path."""
    ds = cfg.experiment.dataset
    size = int(ds.size)
    root = ds.in_path
    counts = {
        "train": int(ds.get("num_train", 256)),
        "val": int(ds.get("num_val", 32)),
        "test": int(ds.get("num_test", 32)),
    }
    os.makedirs(root, exist_ok=True)
    next_img_id = 1
    next_ann_id = 1
    class_freq_acc = []
    for si, split in enumerate(splits):
        rng = np.random.RandomState(seed + 1000 * si)
        images, annotations = [], []
        img_dir = os.path.join(root, "images", split)
        lidar_dir = os.path.join(root, "lidar", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lidar_dir, exist_ok=True)
        for k in range(counts[split]):
            image, points, polygons = generate_tile(rng, size)
            img_name = f"images/{split}/tile_{next_img_id:05d}.png"
            lidar_name = f"lidar/{split}/tile_{next_img_id:05d}.npz"
            cv2.imwrite(os.path.join(root, img_name), image[..., ::-1])
            # generate_tile returns points in pixel coords (y = row, downward).
            # Store them as WORLD coords (y up, origin at the tile's bottom
            # edge) so the loader's reference-exact world->pixel conversion
            # (dataset.py _lidar, mirroring p3_coco.py:82-84:
            # col=(x-top_left_x)/res, row=height-(y-top_left_y)/res — note the
            # reference's "top_left[1]" is the tile's MINIMUM world y) maps
            # them back onto the image grid exactly.  Stamping pixel-coord
            # points with top_left=[0,size] used to collapse every point to
            # row 224 after the conversion — zero y-signal for lidar models.
            world = points.copy()
            world[:, 1] = size - world[:, 1]
            np.savez_compressed(os.path.join(root, lidar_name), points=world)
            images.append(
                {
                    "id": next_img_id,
                    "width": size,
                    "height": size,
                    "file_name": os.path.basename(img_name),
                    "image_path": img_name,
                    "lidar_path": lidar_name,
                    "top_left": [0.0, 0.0],
                    "res_x": 1.0,
                }
            )
            mask_area = 0.0
            for poly in polygons:
                ring = np.concatenate([poly, poly[:1]], axis=0)
                annotations.append(
                    {
                        "id": next_ann_id,
                        "image_id": next_img_id,
                        "category_id": CATEGORY_ID,
                        "segmentation": [ring.reshape(-1).tolist()],
                        "area": abs(poly_area(poly)),
                        "bbox": [
                            float(poly[:, 0].min()),
                            float(poly[:, 1].min()),
                            float(np.ptp(poly[:, 0])),
                            float(np.ptp(poly[:, 1])),
                        ],
                        "iscrowd": 0,
                    }
                )
                next_ann_id += 1
                mask_area += abs(poly_area(poly))
            class_freq_acc.append(mask_area / (size * size))
            next_img_id += 1
        coco = {
            "images": images,
            "annotations": annotations,
            "categories": [{"id": CATEGORY_ID, "name": "building"}],
        }
        ann_path = ds.annotations[split]
        os.makedirs(os.path.dirname(ann_path), exist_ok=True)
        with open(ann_path, "w") as f:
            json.dump(coco, f)
        # ffl stats (class frequency of [background, interior] pixels)
        stats_path = ds.ffl_stats[split]
        os.makedirs(os.path.dirname(stats_path), exist_ok=True)
        freq = float(np.mean(class_freq_acc)) if class_freq_acc else 0.1
        np.savez(stats_path, class_freq=np.array([1.0 - freq, freq], np.float32))


def ensure_synthetic_dataset(cfg) -> None:
    """Generate the synthetic dataset once if missing (idempotent).

    Multi-process safe: only process 0 generates; other ranks poll for the
    annotation files (the reference assumes pre-downloaded data, so this
    race only exists for the self-generating synthetic set)."""
    ds = cfg.experiment.dataset
    if ds.name != "Synthetic":
        return
    if all(os.path.isfile(ds.annotations[s]) for s in ("train", "val", "test")):
        return
    from ..parallel import process_count, process_index

    if process_count() > 1 and process_index() != 0:
        import time

        deadline = time.time() + 600
        while time.time() < deadline:
            if all(os.path.isfile(ds.annotations[s]) for s in ("train", "val", "test")):
                # generator writes annotations last, but give the final file
                # flush a beat before readers open it
                time.sleep(1.0)
                return
            time.sleep(1.0)
        raise TimeoutError("rank 0 did not generate the synthetic dataset in time")
    write_synthetic_dataset(cfg)
