"""Flax variables → the port's `state_dict`.

Takes the JAX package's `params` and `batch_stats` as nested dicts of numpy
arrays (`jax.device_get` of a TrainState, or an orbax payload already read
by the JAX package) and returns the tensors the port's modules hold:

- conv kernels HWIO → OIHW; ECA's 1-D conv (k, 1, 1) → (1, 1, k);
- BatchNorm `scale`/`bias`/`mean`/`var` → `weight`/`bias`/`running_mean`/
  `running_var`;
- flax auto-names map to the port's module names: in `ConvStack3` and
  `Predictor2` `Conv_i` → `conv{i}` and `BatchNorm_i` → `bn{i}`; in ECA
  (`a2m_att`, `a2j_att`) `Conv_0` → `conv1d`, `Conv_1` → `proj`,
  `BatchNorm_0` → `bn`. Explicit flax names (HRNet's) are kept as they are.

(`pixelspointspolygons_tpu/utils/torch_port.py` maps the other way, from
the reference's torch HRNet into flax.)
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

_ECA_NAMES = {"Conv_0": "conv1d", "Conv_1": "proj", "BatchNorm_0": "bn"}


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _module_name(path: tuple) -> str:
    out = []
    for i, comp in enumerate(path):
        parent = path[i - 1] if i else ""
        if parent.endswith("_att") and comp in _ECA_NAMES:
            comp = _ECA_NAMES[comp]
        elif comp.startswith("Conv_"):
            comp = "conv" + comp[len("Conv_"):]
        elif comp.startswith("BatchNorm_"):
            comp = "bn" + comp[len("BatchNorm_"):]
        out.append(comp)
    return ".".join(out)


def _param(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        if value.ndim == 4:  # HWIO → OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 3:  # (k, in, out) → (out, in, k)
            return "weight", value.transpose(2, 1, 0)
        raise ValueError(f"kernel of rank {value.ndim}")
    if leaf == "scale":
        return "weight", value
    if leaf == "bias":
        return "bias", value
    raise KeyError(f"flax param leaf {leaf!r}")


_STATS = {"mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(params: dict, batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """The port's state_dict for flax `params` (and `batch_stats`)."""
    sd: dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        name, arr = _param(path[-1], np.asarray(value))
        sd[f"{_module_name(path[:-1])}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    for path, value in _leaves(batch_stats or {}):
        sd[f"{_module_name(path[:-1])}.{_STATS[path[-1]]}"] = torch.from_numpy(np.array(value, np.float32))
    return sd
