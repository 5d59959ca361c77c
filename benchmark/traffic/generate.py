"""The one traffic generator: it reads a traffic file (`traffic/<name>.json`)
and writes the splits that file asks for, as the port's dataset loader reads
them (COCO json, one png a tile, one LiDAR file a tile), drawn from the run's
seed.

A traffic file holds the mode of the window (`predict` or `train`, the name
of a driver under `drivers/`), the tiles of each split, the port's config
overrides of the mix (batch, run type and with it the loader threads, the
device cache), and the points a LiDAR cloud has at most (each tile draws
0.5 to 1.0 of it).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os

import cv2
import numpy as np

from .synthetic import generate_tile, poly_area

SPLITS = ("train", "val", "test")
CATEGORY_ID = 100  # the P3 building category the port's loader and evaluator use


def split_seed(seed: int, split: str) -> int:
    """A split's `RandomState` seed: the run's seed folded into 31 bits, the
    splits 1000 apart, as the port's generator spaces them."""
    return seed % (2**31) + 1000 * SPLITS.index(split)


def _write_tile(root: str, split: str, tile_id: int, image: np.ndarray, points: np.ndarray | None) -> dict:
    size = image.shape[0]
    img_name = f"images/{split}/tile_{tile_id:05d}.png"
    if not cv2.imwrite(os.path.join(root, img_name), image[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, 1]):
        raise OSError(f"could not write {img_name}")
    info = {"id": tile_id, "width": size, "height": size, "file_name": os.path.basename(img_name),
            "image_path": img_name, "top_left": [0.0, 0.0], "res_x": 1.0}
    if points is not None:
        # world coordinates (y up from the tile's bottom edge), which the
        # loader maps back onto the image grid
        lidar_name = f"lidar/{split}/tile_{tile_id:05d}.npy"
        world = points.copy()
        world[:, 1] = size - world[:, 1]
        np.save(os.path.join(root, lidar_name), world)
        info["lidar_path"] = lidar_name
    return info


def write_splits(root: str, annotations: dict, counts: dict, seed: int, size: int = 224, lidar: bool = True,
                 max_points: int = 60000) -> dict:
    """Write `counts[split]` tiles of each split under `root`, the COCO file
    of each split to `annotations[split]` (an empty split gets an empty
    file). Returns {split: [LiDAR points of each tile]}."""
    next_img, next_ann = 1, 1
    points_of: dict = {}
    with cf.ThreadPoolExecutor(4) as pool:
        for split in SPLITS:
            n = int(counts.get(split, 0))
            os.makedirs(os.path.join(root, "images", split), exist_ok=True)
            if lidar:
                os.makedirs(os.path.join(root, "lidar", split), exist_ok=True)
            rng = np.random.RandomState(split_seed(seed, split))
            futures, anns, points_of[split] = [], [], []
            for _ in range(n):
                image, points, polygons = generate_tile(rng, size, max_points)
                points_of[split].append(len(points))
                futures.append(pool.submit(_write_tile, root, split, next_img, image, points if lidar else None))
                for poly in polygons:
                    ring = np.concatenate([poly, poly[:1]], axis=0)
                    anns.append({
                        "id": next_ann, "image_id": next_img, "category_id": CATEGORY_ID,
                        "segmentation": [ring.reshape(-1).tolist()], "area": abs(poly_area(poly)),
                        "bbox": [float(poly[:, 0].min()), float(poly[:, 1].min()), float(np.ptp(poly[:, 0])),
                                 float(np.ptp(poly[:, 1]))],
                        "iscrowd": 0,
                    })
                    next_ann += 1
                next_img += 1
            images = [f.result() for f in futures]
            os.makedirs(os.path.dirname(annotations[split]), exist_ok=True)
            with open(annotations[split], "w") as f:
                json.dump({"images": images, "annotations": anns,
                           "categories": [{"id": CATEGORY_ID, "name": "building"}]}, f)
    return points_of
