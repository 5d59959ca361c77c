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
from ..device import resolve_device, set_deterministic, set_tf32
from ..parallel import all_gather_objects, process_count, process_index, sync_processes
from ..utils.checkpoint import CheckpointManager
from ..utils.coco import save_annotations
from ..utils.logger import make_logger
from ..utils.visualization import prediction_figure

_PLOT_SIZE = 900  # px: the JAX package's 6-inch figure at 150 dpi


def valid_image_ids(batch: dict) -> list[int]:
    """The ids of a host batch's images, without the batch's padding."""
    return [int(i) for i, v in zip(batch["image_id"], batch["sample_valid"]) if v]


class Predictor:
    def __init__(self, cfg: Config, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        set_tf32(False)
        set_deterministic(self.device)
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

    @staticmethod
    def _gathered(predictions: list[dict], image_ids: list[int]) -> tuple[list[dict], int]:
        """Every process's annotations and the count of images predicted.
        Under a process group each process predicted its shard, the last
        shards wrap-padded with the first images (`data/loader.py`): each
        image's annotations are taken from the first process that predicted
        it, so the split is there once. (The JAX package's processes each
        write their own shard to the one file, ROADMAP 3.17.)"""
        if process_count() == 1:
            return predictions, len(image_ids)
        merged, seen = [], set()
        for ids, anns in all_gather_objects((image_ids, predictions)):
            new = set(ids) - seen
            merged.extend(a for a in anns if a["image_id"] in new)
            seen |= new
        return merged, len(seen)

    def _write_predictions(self, predictions: list[dict], seconds: float, image_ids: list[int]) -> str:
        """The COCO json of the split (every process's images, written once)
        and, beside it, its seconds per image as the reference stores them
        (predictor_pix2poly.py:52-58); `image_ids` are the images this
        process predicted."""
        return self._write_split(*self._gathered(predictions, image_ids), seconds)

    def _write_split(self, predictions: list[dict], n_images: int, seconds: float) -> str:
        """`_write_predictions` of annotations gathered already: rank 0
        writes, the others wait until the files are there."""
        dt = seconds / max(n_images, 1)
        self.logger.info(f"prediction: {dt:.4f} [s/image] over {n_images} images")
        pred_file = self.cfg.evaluation.pred_file
        if process_index() == 0:
            save_annotations(predictions, pred_file)
            with open(pred_file.replace(".json", "_time.json"), "w") as f:
                json.dump({"prediction_time": dt, "num_images": n_images}, f)
        sync_processes("p3_predictions_written")
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
        scaled up to about the 900 px of the JAX package's figure. Under a
        process group only rank 0 draws (every process predicted the same
        tile)."""
        if process_index() != 0:
            return
        img = None if image is None else (image[0] if image.ndim == 4 else image)
        figure = prediction_figure(img, polygons, _PLOT_SIZE, extent=int(self.cfg.experiment.encoder.in_size))
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        if not cv2.imwrite(out_file, figure[..., ::-1]):
            raise OSError(f"could not write {out_file}")
        self.logger.info(f"wrote {out_file}")
