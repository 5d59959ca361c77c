"""FFL predictor: the forward on the device, contours and post-processing on
the host, the ACM optimization on the device — port of
pixelspointspolygons_tpu/predict/predictor_ffl.py (:25-171; reference
predict/predictor_ffl.py:42-177: one prediction file per method and
tolerance, and the canonical copy in `evaluation.pred_file`).

The seg and crossfield maps are rounded to float16 on the device (JAX
:38-43; from the model's bfloat16 outputs at `host.compute_dtype=bfloat16`),
or, in the trainer's val IoU, kept as the model gives them, widened to
float32 (`map_dtype`; JAX trainer_ffl.py:109-111). Their host copy gives
the contours and the post-processing; the ACM (or ASM) optimizes on the
device copy of the same maps, so it reads the values JAX's reads (JAX
uploads the host's maps as float32) and nothing is uploaded again.
`predict_dataset` keeps one batch in flight as the HiSup predictor does
(`Predictor._in_flight`): the host traces batch k's contours while the
card runs batch k+1's forward, and batch k's ACM queues behind that
forward.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.loader import INPUT_KEYS, build_loader, to_device
from ..models.ffl import FFL, build_ffl
from ..parallel import all_gather_objects, process_index
from ..train.state import compute_dtype
from ..utils.coco import generate_coco_ann, save_annotations
from .ffl_inference import inference_with_patching
from .ffl_polygonize import Polygonizer
from .predictor import Predictor, valid_image_ids

class FFLPredictor(Predictor):
    def __init__(self, cfg, device: str | torch.device | None = None, model: FFL | None = None):
        """`model`: an FFL already on `device` whose weights the caller
        owns; else one is built and takes its weights from the checkpoint."""
        super().__init__(cfg, device)
        self.model = build_ffl(cfg, device=self.device, dtype=compute_dtype(cfg)) if model is None else model
        self.polygonizer = Polygonizer(
            cfg.experiment.polygonization,
            seg_threshold=float(cfg.experiment.model.eval.seg_threshold),
            device=self.device,
        )
        # per batch of the last predict_dataset: the forward's device ms
        # (CUDA events; None on the CPU), the polygonizer's stages
        # (`Polygonizer.stats`), the host ms of the whole host stage, and
        # the wall ms since the previous batch was done
        self.batch_times: list[dict] = []
        # batches of the last predict_dataset whose polygonization raised
        # (logged and skipped, as in JAX :101-105)
        self.failed_batches = 0
        # the dtype the maps leave the forward in: float16 as JAX's predictor
        # ships them; the trainer's val IoU sets float32 (the model's values)
        self.map_dtype = torch.float16

    def load_checkpoint(self) -> dict:
        payload = super().load_checkpoint()
        self.model.load_state_dict(payload["model"])
        return payload

    @torch.inference_mode()
    def forward(self, inputs: dict) -> dict[str, torch.Tensor]:
        """Eval-mode forward; "seg" (B, Cs, S, S) and "crossfield"
        (B, 4, S, S) in `map_dtype` on the device."""
        self.model.eval()
        return {k: v.to(self.map_dtype) for k, v in self.model(inputs).items()}

    @torch.inference_mode()
    def _dispatch(self, inputs: dict):
        """Queue the forward and the copy of its maps to the host. Returns
        ((device maps, host maps), events): on the card the host maps are
        pinned tensors valid once events[2] has completed, and events[:2]
        bracket the forward."""
        if self.device.type != "cuda":
            outs = self.forward(inputs)
            return (outs, outs), None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = self.forward(inputs)
        end.record()
        host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for k, t in outs.items()}
        ready = torch.cuda.Event()
        ready.record()
        return (outs, host), (start, end, ready)

    @staticmethod
    def _fetch(handles) -> tuple[np.ndarray, np.ndarray, tuple]:
        """Wait for one batch's copy alone: (seg, crossfield) as float32
        numpy, and the device's (seg, crossfield) in `map_dtype`."""
        (dev, host), events = handles
        if events is not None:
            events[2].synchronize()
        return host["seg"].float().numpy(), host["crossfield"].float().numpy(), (dev["seg"], dev["crossfield"])

    def _host_stage(self, arrays, batch: dict | None = None) -> dict:
        """{method: {tol: per-sample polygon lists ((V, 2) xy)}} of one
        batch's maps (JAX :55-66)."""
        seg, crossfield, maps = arrays
        if batch is not None:
            self._maybe_save_raw(batch, seg, crossfield)
        return self.polygonizer(seg, crossfield, maps)

    def predict_batch(self, batch: dict) -> dict:
        """Polygons of one host batch, synchronously."""
        inputs = to_device(batch, self.device, INPUT_KEYS)
        return self._host_stage(self._fetch(self._dispatch(inputs)), batch)

    def _maybe_save_raw(self, batch: dict, seg: np.ndarray, crossfield: np.ndarray) -> None:
        """Optional per-tile raw dumps (reference save_utils.save_crossfield
        :238-244, save_raw_pred :257-260), gated by model.eval flags."""
        ev = self.cfg.experiment.model.eval
        save_cf = bool(ev.get("save_crossfield", False))
        save_raw = bool(ev.get("save_raw", False))
        if not (save_cf or save_raw) or "image_id" not in batch:
            return
        raw_dir = os.path.join(os.path.dirname(self.cfg.evaluation.pred_file), "raw")
        os.makedirs(raw_dir, exist_ok=True)
        valid = np.asarray(batch.get("sample_valid", np.ones(len(seg), bool)))
        for b in range(len(seg)):
            if not valid[b]:
                continue
            img_id = int(batch["image_id"][b])
            if save_cf:
                np.save(os.path.join(raw_dir, f"{img_id}.crossfield.npy"), crossfield[b])
            if save_raw:
                np.savez_compressed(
                    os.path.join(raw_dir, f"{img_id}.raw_pred.npz"),
                    seg=seg[b],
                    crossfield=crossfield[b],
                )

    def predict_dataset(self, split: str | None = None) -> str:
        split = split or self.cfg.evaluation.split
        self.load_checkpoint()
        loader = build_loader(self.cfg, split, eval_mode=True)

        # per method.tol prediction lists (reference predictor_ffl.py:65-79)
        predictions: dict[str, list] = {}
        self.batch_times = []
        self.failed_batches = 0
        image_ids: list[int] = []
        t0 = time.time()
        t_done = time.perf_counter()
        for handles, batch in self._in_flight(loader, INPUT_KEYS):
            t = time.perf_counter()
            try:
                results = self._host_stage(self._fetch(handles), batch)
            except Exception:  # soft-fail per batch, as the reference (:113-123); counted
                self.failed_batches += 1
                self.logger.warning("polygonization failed for a batch", exc_info=True)
                continue
            now = time.perf_counter()
            events = handles[1]
            self.batch_times.append({
                "device_ms": None if events is None else events[0].elapsed_time(events[1]),
                **self.polygonizer.stats,
                "host_ms": (now - t) * 1e3,
                "wall_ms": (now - t_done) * 1e3,
            })
            t_done = now
            for method, tols in results.items():
                for tol, per_sample in tols.items():
                    anns = predictions.setdefault(f"{method}.{tol}", [])
                    for b, polys in enumerate(per_sample):
                        if batch["sample_valid"][b]:
                            anns.extend(generate_coco_ann(polys, int(batch["image_id"][b])))
            image_ids.extend(valid_image_ids(batch))

        pred_file = self.cfg.evaluation.pred_file
        # every process's keys, in rank 0's order (a process whose batches
        # all failed has none)
        keys = list(dict.fromkeys(k for ks in all_gather_objects(list(predictions)) for k in ks))
        predictions = {k: self._gathered(predictions.get(k, []), image_ids)[0] for k in keys}
        n_images = self._gathered([], image_ids)[1]
        for key, anns in predictions.items():
            if process_index() == 0:
                save_annotations(anns, pred_file.replace(".json", f"_{key}.json"))
        # canonical copy: acm.tol_<eval_tolerance> (the reference hardcodes
        # acm.tol_1, predictor_ffl.py:74-79)
        ev_tol = self.cfg.experiment.polygonization.acm_method.get("eval_tolerance", 1)
        canonical = predictions.get(f"acm.tol_{ev_tol}")
        if canonical is None:
            acm_keys = [k for k in predictions if k.startswith("acm.")]
            canonical = predictions[acm_keys[0]] if acm_keys else next(iter(predictions.values()), [])
        self._write_split(canonical or [], n_images, time.time() - t0)
        self.logger.info(f"wrote predictions for {list(predictions)} to {os.path.dirname(pred_file)}")
        return pred_file

    def predict_file(self, image_file=None, lidar_file=None, out_file="prediction.png"):
        """Polygons of one tile's image and/or LiDAR file (the first method
        and tolerance), drawn over the image (a blank canvas without one)
        into `out_file`; sliding-window inference when
        `model.eval.patch_size` is set and the image, read alone, is larger."""
        self.load_checkpoint()
        batch, image = self.file_inputs(image_file, lidar_file)
        patch_size = self.cfg.experiment.model.eval.get("patch_size")
        if patch_size and set(batch) == {"images"} and image.shape[1] > int(patch_size):
            # sliding-window inference for large rasters (reference inference.py:57-118)
            def forward_fn(patch):
                outs = self.forward(to_device({"images": np.ascontiguousarray(patch)}, self.device, INPUT_KEYS))
                return {k: v.float().cpu().numpy() for k, v in outs.items()}

            out = inference_with_patching(
                forward_fn, image, int(patch_size), int(self.cfg.experiment.model.eval.patch_overlap)
            )
            results = self.polygonizer(out["seg"], out["crossfield"])
        else:
            results = self.predict_batch(batch)
        method = next(iter(results))
        tol = next(iter(results[method]))
        polys = results[method][tol][0]
        self.plot_prediction(image, polys, out_file)
        return polys
