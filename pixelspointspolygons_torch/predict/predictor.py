"""Base predictor: checkpoint restore, single-file input loading, plotting —
port of pixelspointspolygons_tpu/predict/predictor.py (reference
predict/predictor.py:22-182).

Checkpoints are the port's own `torch.save` files (`utils/checkpoint.py`),
checked for the config's modality before their weights are used. The
prediction plot is drawn with cv2 (matplotlib is not needed): the
normalised image, each polygon as a closed ring with a dot per vertex, one
png.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Iterable, Iterator, Optional

import cv2
import numpy as np
import torch

from ..config.engine import Config
from ..data.dataset import load_image_file, load_lidar_file
from ..data.loader import device_prefetch
from ..device import resolve_device, set_tf32
from ..utils.checkpoint import CheckpointManager
from ..utils.coco import save_annotations
from ..utils.logger import make_logger

_PLOT_SIZE = 900  # px: the JAX package's 6-inch figure at 150 dpi
# matplotlib's default colour cycle (tab10), as BGR
_COLORS = [
    (180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214), (189, 103, 148),
    (75, 86, 140), (194, 119, 227), (127, 127, 127), (34, 189, 188), (207, 190, 23),
]


class Predictor:
    def __init__(self, cfg: Config, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        set_tf32(False)
        self.logger = make_logger(self.__class__.__name__)
        self.manager = CheckpointManager(cfg.output_dir)

    def load_checkpoint(self) -> dict:
        name = self.cfg.get("checkpoint") or "latest"
        payload = self.manager.restore(name, map_location="cpu")
        self.manager.check_modality_compat(payload.get("cfg"), self.cfg)
        self.logger.info(f"restored checkpoint {name!r} (epoch {payload.get('epoch')})")
        return payload

    # --- the loop over a split (predict_dataset) --------------------------

    def _in_flight(self, loader: Iterable[dict], keys: Iterable[str]) -> Iterator[tuple]:
        """Yield (handles, host batch) for each batch in loader order, each
        once the next batch's `_dispatch` has been queued: the host works on
        batch k while the card runs batch k+1. `device_prefetch` takes batch
        k+1 from the loader before it yields batch k, so the host batches
        are tapped in the order they are taken."""
        taken: collections.deque = collections.deque()

        def tap():
            for batch in loader:
                taken.append(batch)
                yield batch

        pending = None
        for inputs in device_prefetch(tap(), self.device, keys):
            handles = self._dispatch(inputs)
            if pending is not None:
                yield pending
            pending = (handles, taken.popleft())
        if pending is not None:
            yield pending

    def _write_predictions(self, predictions: list[dict], seconds: float, n_images: int) -> str:
        """The COCO json of a split and, beside it, its seconds per image as
        the reference stores them (predictor_pix2poly.py:52-58)."""
        dt = seconds / max(n_images, 1)
        self.logger.info(f"prediction: {dt:.4f} [s/image] over {n_images} images")
        pred_file = self.cfg.evaluation.pred_file
        save_annotations(predictions, pred_file)
        with open(pred_file.replace(".json", "_time.json"), "w") as f:
            json.dump({"prediction_time": dt, "num_images": n_images}, f)
        return pred_file

    # --- single-file inputs (predict_demo path) ---------------------------

    def load_image_from_file(self, path: str) -> np.ndarray:
        """(1, H, W, 3) float32, normalized with the encoder's stats."""
        enc = self.cfg.experiment.encoder
        img = load_image_file(path).astype(np.float32)
        mean = np.asarray(enc.get("image_mean", [0, 0, 0]), np.float32)
        std = np.asarray(enc.get("image_std", [1, 1, 1]), np.float32)
        maxv = float(enc.get("image_max_pixel_value", 255.0))
        return ((img / maxv - mean) / std)[None]

    def load_lidar_from_file(self, path: str) -> tuple[np.ndarray, np.ndarray]:
        """(1, N, 3) float32 points in pixel coordinates and their (1, N)
        mask, padded to `max_num_points` (JAX :44-60; reference
        predictor.py:116-137): x and y shifted to the cloud's minimum and
        scaled by the P3 tiles' 0.25 m resolution, y flipped, z to [0,
        in_voxel_size.z]."""
        enc = self.cfg.experiment.encoder
        img_dim, img_res = int(enc.in_size), 0.25
        pts = load_lidar_file(path).copy()
        pts[:, 0] = (pts[:, 0] - pts[:, 0].min()) / img_res
        pts[:, 1] = (pts[:, 1] - pts[:, 1].min()) / img_res
        pts[:, 1] = img_dim - np.clip(pts[:, 1], 0, img_dim)
        pts[:, 0] = np.clip(pts[:, 0], 0, img_dim)
        z = pts[:, 2]
        zr = float(enc.in_voxel_size.z) if "in_voxel_size" in enc else 100.0
        pts[:, 2] = (z - z.min()) / max(z.max() - z.min(), 1e-6) * zr
        max_points = int(enc.get("max_num_points", 200000))
        out = np.zeros((max_points, 3), np.float32)
        mask = np.zeros((max_points,), bool)
        n = min(len(pts), max_points)
        out[:n] = pts[:n]
        mask[:n] = True
        return out[None], mask[None]

    def file_inputs(self, image_file=None, lidar_file=None) -> tuple[dict, Optional[np.ndarray]]:
        """The host batch of one tile's files, as the config's modality reads
        them, and its normalised image (None without one); JAX's
        `predict_file` (e.g. predictor_hisup.py:137-148)."""
        enc = self.cfg.experiment.encoder
        batch, image = {}, None
        if image_file and enc.use_images:
            image = batch["images"] = self.load_image_from_file(image_file)
        if lidar_file and enc.use_lidar:
            batch["lidar"], batch["lidar_mask"] = self.load_lidar_from_file(lidar_file)
        if bool(enc.use_images) != ("images" in batch) or bool(enc.use_lidar) != ("lidar" in batch):
            need = [name for name, used in (("image_file", enc.use_images), ("lidar_file", enc.use_lidar)) if used]
            raise ValueError(f"experiment {self.cfg.experiment.name} predicts from {' and '.join(need)}")
        return batch, image

    def plot_prediction(self, image: Optional[np.ndarray], polygons: list, out_file: str) -> None:
        """Save an overlay png of predicted polygons (predictor.py:140-182):
        the image min-max normalised (white without one), y pointing down,
        scaled up to about the 900 px of the JAX package's figure."""
        if image is not None:
            img = image[0] if image.ndim == 4 else image
            img = img - img.min()
            img = img / max(img.max(), 1e-6)
            base = np.ascontiguousarray((img * 255).round().astype(np.uint8)[..., ::-1])
        else:
            side = int(self.cfg.experiment.encoder.in_size)
            base = np.full((side, side, 3), 255, np.uint8)
        scale = max(_PLOT_SIZE // max(base.shape[:2]), 1)
        canvas = cv2.resize(base, None, fx=scale, fy=scale, interpolation=cv2.INTER_NEAREST)
        for k, poly in enumerate(polygons):
            p = np.asarray(poly, np.float64)
            if len(p) < 2:
                continue
            color = _COLORS[k % len(_COLORS)]
            # 4 fractional bits: vertices keep their sub-pixel position
            pts = np.round(p * scale * 16).astype(np.int32)
            cv2.polylines(canvas, [pts], True, color, 2, cv2.LINE_AA, shift=4)
            for q in pts:
                cv2.circle(canvas, (int(q[0]), int(q[1])), 4 * 16, color, -1, cv2.LINE_AA, shift=4)
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        if not cv2.imwrite(out_file, canvas):
            raise OSError(f"could not write {out_file}")
        self.logger.info(f"wrote {out_file}")
