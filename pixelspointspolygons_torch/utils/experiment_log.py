"""Experiment logging to a local JSONL file — port of
pixelspointspolygons_tpu/utils/experiment_log.py without the wandb backend.

`RunLogger` keeps the reference's call surface (`log`, `log_image`,
`finish`) and writes <output_dir>/runs/<experiment name>.jsonl: one config
record, then one metrics record per `log` call; `log_image` writes
<output_dir>/runs/images/<name>_<step>.png (JAX :64-78). Only process 0
writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from ..parallel import process_index


class RunLogger:
    def __init__(self, cfg, enabled: Optional[bool] = None):
        self.cfg = cfg
        self.enabled = process_index() == 0 if enabled is None else enabled
        self._file = None
        if not self.enabled:
            return
        run_dir = os.path.join(cfg.output_dir, "runs")
        os.makedirs(run_dir, exist_ok=True)
        self.image_dir = os.path.join(run_dir, "images")
        self.path = os.path.join(run_dir, f"{cfg.experiment.name}.jsonl")
        self._file = open(self.path, "a")
        self._file.write(json.dumps({"_type": "config", "config": cfg.to_dict(), "t": time.time()}) + "\n")

    def log(self, metrics: dict, step: int | None = None) -> None:
        if self._file is None:
            return
        rec = {"_type": "metrics", "step": step, "t": time.time()}
        rec.update({k: float(v) for k, v in metrics.items() if _is_num(v)})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def log_image(self, name: str, image, step: int | None = None) -> None:
        """An RGB (H, W, 3) or grey image, uint8 or floats in [0, 1], as a png."""
        if not self.enabled:
            return
        import cv2
        import numpy as np

        os.makedirs(self.image_dir, exist_ok=True)
        arr = np.asarray(image)
        if arr.dtype != "uint8":
            arr = (np.clip(arr, 0, 1) * 255).astype("uint8")
        path = os.path.join(self.image_dir, f"{name.replace('/', '_')}_{step or 0}.png")
        cv2.imwrite(path, arr[..., ::-1] if arr.ndim == 3 else arr)

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def _is_num(v: Any) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False
