"""Checkpoints with the reference's save/restore policy, on `torch.save` —
port of pixelspointspolygons_tpu/utils/checkpoint.py.

Names as in the JAX package (reference train/trainer.py:109-201):
best_val_loss / best_val_iou / latest / epoch_%d, each one file
`<output_dir>/checkpoints/<name>.pt` holding the model, optimizer and
schedule states, the update count, the epoch, the best metrics and the
resolved config (for the modality check on resume, trainer.py:176-188).
Only process 0 writes.

`smart_restore_params` grafts the tensors of another run's checkpoint into
a model by name and shape (the warm start, `init_weights_from`).
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..config.engine import Config
from ..parallel import process_count, process_index


class CheckpointManager:
    def __init__(self, output_dir: str):
        self.ckpt_dir = os.path.join(os.path.abspath(output_dir), "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, f"{name}.pt")

    def save(self, name: str, state, epoch: int, cfg=None, extra: Optional[dict] = None) -> None:
        if process_index() != 0:
            return
        payload = {**state.state_dict(), "epoch": int(epoch)}
        payload.update({k: float(v) for k, v in (extra or {}).items()})
        if cfg is not None:
            payload["cfg"] = cfg.to_dict()
        path = self.path(name)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def restore(self, name: str, map_location=None) -> dict:
        path = self.path(name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"checkpoint {name!r} not found under {self.ckpt_dir}")
        payload = torch.load(path, map_location=map_location, weights_only=True)
        if "cfg" in payload:
            payload["cfg"] = Config.from_dict(payload["cfg"])
        return payload

    def exists(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def check_modality_compat(self, ckpt_cfg, cfg) -> None:
        """Refuse to load weights across modality mismatches (trainer.py:176-188)."""
        if ckpt_cfg is None:
            return
        a = ckpt_cfg.get_path("experiment.encoder.use_images"), ckpt_cfg.get_path(
            "experiment.encoder.use_lidar"
        )
        b = cfg.get_path("experiment.encoder.use_images"), cfg.get_path(
            "experiment.encoder.use_lidar"
        )
        if a != b:
            raise ValueError(f"checkpoint modality {a} does not match config modality {b}")


def smart_restore_params(target: Mapping[str, Any], loaded: Mapping[str, Any], logger=None) -> dict:
    """Fuzzy restore of a flat `{dotted.name: tensor}` mapping (a
    `state_dict`: parameters and BatchNorm buffers) — port of JAX
    utils/checkpoint.py:100-150 (reference misc/shared_utils.py:67-118):
    for each target tensor, the loaded one of the same path and shape;
    else the loaded one, not taken yet, that alone shares the longest
    path suffix and the shape (a wrapper prefix renamed across versions);
    else the target keeps its init. Returns the new mapping."""
    tflat = {tuple(k.split(".")): v for k, v in target.items()}
    lflat = {tuple(k.split(".")): v for k, v in loaded.items()}
    out = dict(tflat)
    used = set()
    for path, leaf in tflat.items():
        if path in lflat and tuple(np.shape(lflat[path])) == tuple(np.shape(leaf)):
            out[path] = lflat[path]
            used.add(path)
            continue
        matched = False
        for k in range(len(path), 0, -1):
            suffix = path[-k:]
            cands = [lp for lp in lflat
                     if lp not in used and lp[-k:] == suffix and tuple(np.shape(lflat[lp])) == tuple(np.shape(leaf))]
            if len(cands) == 1:
                out[path] = lflat[cands[0]]
                used.add(cands[0])
                matched = True
                break
            if len(cands) > 1:
                break  # ambiguous at this depth; shorter suffixes only get worse
        if not matched and logger is not None:
            logger.warning(f"checkpoint: no match for {'.'.join(path)} — keeping init")
    return {".".join(path): v for path, v in out.items()}


def save_best_and_latest(
    manager: CheckpointManager,
    state,
    epoch: int,
    cfg,
    val_loss: float,
    val_iou: Optional[float],
    best: dict,
    save_every: int = 10,
) -> dict:
    """The reference's best/latest/epoch_N policy (trainer.py:126-148).
    `val_iou=None` (no IoU this epoch) never saves best_val_iou."""
    decision = {
        "save_loss": bool(cfg.training.save_best and val_loss < best.get("val_loss", np.inf)),
        "save_iou": bool(
            cfg.training.save_best and val_iou is not None and val_iou > best.get("val_iou", 0.0)
        ),
        "val_loss": float(val_loss),
        "val_iou": None if val_iou is None else float(val_iou),
    }
    if process_count() > 1:
        # every rank adopts rank 0's decision
        import torch.distributed as dist

        box = [decision]
        dist.broadcast_object_list(box, src=0)
        decision = box[0]
    if decision["save_loss"]:
        best["val_loss"] = decision["val_loss"]
    if decision["save_iou"]:
        best["val_iou"] = decision["val_iou"]
    # every checkpoint of this epoch, "latest" included, carries the best
    # metrics including this epoch's, so a resume from "latest" compares the
    # next epoch with them (the JAX package writes "latest" before updating)
    extra = {
        "best_val_loss": best.get("val_loss", np.inf),
        "best_val_iou": best.get("val_iou", 0.0),
    }
    if cfg.training.save_latest:
        manager.save("latest", state, epoch, cfg, extra)
    if decision["save_loss"]:
        manager.save("best_val_loss", state, epoch, cfg, extra)
    if decision["save_iou"]:
        manager.save("best_val_iou", state, epoch, cfg, extra)
    if save_every and epoch % save_every == 0:
        manager.save(f"epoch_{epoch}", state, epoch, cfg, extra)
    return best
