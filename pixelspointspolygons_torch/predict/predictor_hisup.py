"""HiSup predictor: forward + junction extraction on the device, host
polygonization — port of pixelspointspolygons_tpu/predict/predictor_hisup.py
(reference predict/predictor_hisup.py:39-123: loop the loader, polygonize
from the eval-mode outputs, write COCO json).

`predict_dataset` keeps one batch in flight. A blocking `.cpu()` of batch k,
called once batch k+1's forward is queued on the same stream, would wait
for batch k+1 as well, so each batch's outputs are copied into pinned host
buffers right after its forward, with an event behind the copy; batch k+1's
forward is queued; then the host waits on batch k's event alone and
polygonizes batch k while the card runs batch k+1.
"""

from __future__ import annotations

import time

import cv2
import numpy as np
import torch

from ..data.loader import INPUT_KEYS, build_loader, to_device
from ..models.hisup.factory import build_hisup
from ..models.hisup.model import HiSup, extract_junctions
from ..train.state import compute_dtype
from ..utils.coco import generate_coco_ann
from .hisup_polygon import polygons_from_masks
from .predictor import Predictor

def batch_annotations(batch: dict, polys: list, scores: list) -> list[dict]:
    """COCO prediction dicts of one batch's polygons, padding samples left out."""
    anns: list[dict] = []
    for b in range(len(polys)):
        if batch["sample_valid"][b]:
            anns.extend(generate_coco_ann(polys[b], int(batch["image_id"][b]), scores[b]))
    return anns


class HiSupPredictor(Predictor):
    def __init__(self, cfg, device: str | torch.device | None = None, model: HiSup | None = None):
        """`model`: a HiSup already on `device` whose weights the caller
        owns (the trainer's val pass); else one is built and takes its
        weights from the checkpoint."""
        super().__init__(cfg, device)
        self.model = build_hisup(cfg, device=self.device, dtype=compute_dtype(cfg)) if model is None else model
        self.in_size = int(cfg.experiment.encoder.in_size)
        ev = cfg.experiment.model.get("eval") or {}
        self.junc_threshold = float(ev.get("junc_threshold", 0.008))
        self.junc_topk = int(ev.get("junc_topk", 300))
        self.dp_tolerance = float(ev.get("dp_tolerance", 1.0))
        # remask is a probability map (softmaxed at the compute dtype) and
        # travels to the host as float16 (JAX :40-48); it is thresholded at
        # 0.5 after that rounding
        self.remask_dtype = torch.float16
        # per batch of the last predict_dataset: device ms of forward +
        # junction extraction (CUDA events; None on the CPU), host stage ms,
        # wall ms since the previous batch was done
        self.batch_times: list[dict] = []

    def load_checkpoint(self) -> dict:
        payload = super().load_checkpoint()
        self.model.load_state_dict(payload["model"])
        return payload

    @torch.inference_mode()
    def forward(self, inputs: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The device part (JAX :39-48): eval-mode forward, the heads'
        activations, the junction candidates. Returns (remask (B,S,S),
        junctions (B,2k,2) xy, scores (B,2k))."""
        self.model.eval()
        out = self.model(inputs)
        jloc = torch.softmax(out["jloc"], dim=1)
        joff = torch.sigmoid(out["joff"]) - 0.5
        remask = torch.softmax(out["remask"], dim=1)[:, 1]
        juncs, scores = extract_junctions(jloc, joff, topk=self.junc_topk, th=self.junc_threshold)
        return remask.to(self.remask_dtype), juncs, scores

    @torch.inference_mode()
    def _dispatch(self, inputs: dict):
        """Queue the forward and the copy of its outputs to the host.
        Returns (outputs, events): on the card the outputs are pinned host
        tensors that are valid once events[2] has completed, and events[:2]
        bracket the forward."""
        if self.device.type != "cuda":
            return self.forward(inputs), None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = self.forward(inputs)
        end.record()
        host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True) for t in outs
        )
        ready = torch.cuda.Event()
        ready.record()
        return host, (start, end, ready)

    @staticmethod
    def _fetch(handles) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for one batch's copy alone; its outputs as float32 numpy
        (the scores are bfloat16 at bfloat16, which numpy lacks)."""
        outs, events = handles
        if events is not None:
            events[2].synchronize()
        return tuple(t.float().numpy() for t in outs)

    def predict_batch(self, batch: dict):
        """Polygons and scores of one host batch, synchronously."""
        inputs = to_device(batch, self.device, INPUT_KEYS)
        return self._host_stage(self._fetch(self._dispatch(inputs)))

    def _host_stage(self, arrays):
        """Host polygonization of one batch's outputs (JAX :68-95)."""
        remask, juncs, scores = arrays
        S = remask.shape[-1]
        scale = self.in_size / S
        all_polys, all_scores = [], []
        for b in range(remask.shape[0]):
            mask = cv2.resize(remask[b], (self.in_size, self.in_size))
            jb = juncs[b][scores[b] > 0] * scale
            polys, pscores = polygons_from_masks(mask, jb, dp_tol=self.dp_tolerance)
            all_polys.append(polys)
            all_scores.append(pscores)
        return all_polys, all_scores

    def predict_dataset(self, split: str | None = None) -> str:
        split = split or self.cfg.evaluation.split
        self.load_checkpoint()
        loader = build_loader(self.cfg, split, eval_mode=True)

        predictions: list[dict] = []
        self.batch_times = []
        n_images = 0
        t0 = time.time()
        t_done = time.perf_counter()

        def consume(handles, batch):
            nonlocal n_images, t_done
            arrays = self._fetch(handles)
            t = time.perf_counter()
            polys, scores = self._host_stage(arrays)
            now = time.perf_counter()
            events = handles[1]
            self.batch_times.append({
                "device_ms": None if events is None else events[0].elapsed_time(events[1]),
                "host_ms": (now - t) * 1e3,
                "wall_ms": (now - t_done) * 1e3,
            })
            t_done = now
            predictions.extend(batch_annotations(batch, polys, scores))
            n_images += int(np.sum(batch["sample_valid"]))

        for handles, batch in self._in_flight(loader, INPUT_KEYS):
            consume(handles, batch)
        return self._write_predictions(predictions, time.time() - t0, n_images)

    def predict_file(self, image_file=None, lidar_file=None, out_file="prediction.png"):
        """Polygons of one tile's image and/or LiDAR file, drawn over the
        image (a blank canvas without one) into `out_file`."""
        self.load_checkpoint()
        batch, image = self.file_inputs(image_file, lidar_file)
        polys, _ = self.predict_batch(batch)
        self.plot_prediction(image, polys[0], out_file)
        return polys[0]
