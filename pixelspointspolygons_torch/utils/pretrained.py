"""Pretrained encoder weights grafted in after the model is built — port of
pixelspointspolygons_tpu/utils/pretrained.py.

The reference loads encoder checkpoints while it builds the model: timm/DINO
ViT weights (models/vision_transformer/vit.py:33-41), DINOv2
(vit_dinov2.py:27-45), and the ImageNet HRNetV2-W48 state_dict with
intersect-and-update (hrnet/hrnet48v2.py:386-394,542-552). Here, as in the
JAX package, each trainer calls `apply_pretrained_encoder(cfg, model)` right
after it builds the model; a resume from a run's checkpoint then overrides
everything. Nothing is downloaded: the config names a file.

- `encoder.hrnet.pretrained` with `checkpoint_file`: the HRNet trunk of an
  `hrnet` encoder, or of a `fusion_hrnet` encoder at `encoder.hrnet` (JAX
  :111-130; `utils/torch_port.py::port_hrnet`).
- `encoder.vit.pretrained` with `checkpoint_file`: every ViT trunk
  (`models/vit.py::ViTBackbone`) the model holds, the LiDAR and fusion
  encoders' included, timm's layout or DINOv2's (recognised by
  `blocks.0.ls1.gamma`), `pos_embed` resampled when its token count
  differs; a trunk that takes its tokens from another patch embedding has
  no `patch_embed` and takes none; a tensor whose shape differs from the
  trunk's keeps its init and is counted.
- A named file that is absent raises `FileNotFoundError`; `pretrained` false
  or no file named leaves the model as it was built.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
from torch import nn

from ..models.vit import ViTBackbone
from .torch_port import (
    interpolate_pos_embed,
    normalize_state_dict,
    port_dinov2_vit,
    port_hrnet,
    port_timm_vit,
    vit_unconsumed_keys,
)


def _load_torch_sd(path: str) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(payload, dict) and key in payload and isinstance(payload[key], dict):
            payload = payload[key]
    return payload


def _cfg_get(node: Any, name: str, default=None):
    if node is None or not hasattr(node, "get"):
        return default
    v = node.get(name)
    return default if v is None else v


def _named_file(node: Any, what: str) -> str | None:
    """The checkpoint file of a `pretrained` block, or None when there is
    nothing to load."""
    path = _cfg_get(node, "checkpoint_file")
    if not (bool(_cfg_get(node, "pretrained", False)) and path):
        return None
    if not os.path.isfile(str(path)):
        raise FileNotFoundError(f"{what} checkpoint not found: {path}")
    return str(path)


@torch.no_grad()
def _copy_into(module: nn.Module, values: dict[str, np.ndarray]) -> tuple[int, int]:
    """Copy `values` into the module's tensors of those names; returns
    (tensors loaded, tensors of the module left at their init)."""
    tensors = module.state_dict(keep_vars=True)
    for name, value in values.items():
        tensors[name].copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return len(values), len(tensors) - len(values)


def apply_pretrained_encoder(cfg, model: nn.Module, logger=None) -> list[tuple[str, int, int]]:
    """Graft the configured pretrained encoder weights into `model` in
    place. Returns one (trunk, tensors loaded, tensors kept at init) per
    trunk grafted; an empty list when nothing is configured."""
    enc = cfg.experiment.encoder
    name = str(_cfg_get(enc, "name", ""))
    grafted = []

    hr_file = _named_file(_cfg_get(enc, "hrnet"), "HRNet") if name in ("hrnet", "fusion_hrnet") else None
    if hr_file:
        path = "encoder.hrnet" if name == "fusion_hrnet" else "encoder"
        trunk = model.get_submodule(path)
        values, loaded, skipped = port_hrnet(_load_torch_sd(hr_file), trunk.state_dict())
        n_loaded, n_kept = _copy_into(trunk, values)
        grafted.append((path, n_loaded, n_kept))
        if logger:
            logger.info(f"loaded HRNetV2 pretrained weights from {hr_file}: {len(loaded)} modules, "
                        f"{len(skipped)} kept init ({skipped[:4]}...)")

    vit_file = _named_file(_cfg_get(enc, "vit"), "ViT")
    if vit_file:
        sd = _load_torch_sd(vit_file)
        norm_sd, prefix = normalize_state_dict(sd)
        extras = vit_unconsumed_keys(norm_sd)
        if logger and (prefix or extras):
            logger.info(f"real-checkpoint normalization: stripped prefix {prefix!r}, "
                        f"skipping {len(extras)} extra keys (e.g. {extras[:4]})")
        is_dinov2 = name == "vit_dinov2" or "blocks.0.ls1.gamma" in norm_sd
        ported = (port_dinov2_vit if is_dinov2 else port_timm_vit)(norm_sd, depth=12)
        trunks = [(path, m) for path, m in model.named_modules() if isinstance(m, ViTBackbone)]
        if not trunks and logger:
            logger.warning("vit.pretrained set but no ViT trunk found in the model")
        for path, trunk in trunks:
            target = trunk.state_dict()
            # checkpoints are 224 px grids; resample pos_embed for other in_sizes
            if tuple(target["pos_embed"].shape) != ported["pos_embed"].shape:
                ported = dict(ported, pos_embed=interpolate_pos_embed(ported["pos_embed"],
                                                                     target["pos_embed"].shape[1]))
                if logger:
                    logger.info(f"interpolated pos_embed to {ported['pos_embed'].shape} for {path}")
            fits = {}
            for k, v in ported.items():
                if k not in target:
                    continue
                if tuple(target[k].shape) == v.shape:
                    fits[k] = v
                elif logger:
                    logger.warning(f"pretrained graft: shape mismatch at {path}.{k} "
                                   f"({v.shape} → {tuple(target[k].shape)}), keeping init")
            n_loaded, n_kept = _copy_into(trunk, fits)
            grafted.append((path, n_loaded, n_kept))
            if logger:
                logger.info(f"loaded ViT pretrained weights into {path}: {n_loaded} tensors ({n_kept} kept init)")
    return grafted
