"""Flax variables → the port's `state_dict`.

Takes the JAX package's `params` and `batch_stats` as nested dicts of numpy
arrays (`jax.device_get` of a TrainState, or an orbax payload already read
by the JAX package) and returns the tensors the port's modules hold:

- conv kernels HWIO → OIHW; ECA's 1-D conv (k, 1, 1) → (1, 1, k); dense
  kernels (in, out) → `Linear` weights (out, in);
- BatchNorm `scale`/`bias`/`mean`/`var` → `weight`/`bias`/`running_mean`/
  `running_var`; LayerNorm `scale`/`bias` → `weight`/`bias`; `Embed`'s
  `embedding` → `weight`;
- raw parameters (ViT `cls_token`/`pos_embed`/`ls1`/`ls2`, the decoder's
  `decoder_pos_embed`/`encoder_pos_embed`, Pix2Poly's scalar `bin_score`)
  keep their names;
- flax auto-names map to the port's module names: `Conv_i` → `conv{i}`,
  `BatchNorm_i` → `bn{i}`, `Dense_i` → `dense{i}`, `LayerNorm_i` → `ln{i}`,
  `MultiHeadAttention_0` → `attn`, `MlpBlock_0` → `mlp`; in ECA
  (`a2m_att`, `a2j_att`) `Conv_0` → `conv1d`, `Conv_1` → `proj`,
  `BatchNorm_0` → `bn`. Explicit flax names (HRNet's, the decoder's) are
  kept as they are.

(`pixelspointspolygons_tpu/utils/torch_port.py` maps the other way, from
the reference's torch HRNet into flax.)
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

_ECA_NAMES = {"Conv_0": "conv1d", "Conv_1": "proj", "BatchNorm_0": "bn"}
_AUTO_PREFIXES = {"Conv_": "conv", "BatchNorm_": "bn", "Dense_": "dense", "LayerNorm_": "ln"}
_AUTO_NAMES = {"MultiHeadAttention_0": "attn", "MlpBlock_0": "mlp"}
_RAW_PARAMS = frozenset({"cls_token", "pos_embed", "ls1", "ls2", "decoder_pos_embed", "encoder_pos_embed", "bin_score"})


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
        elif comp in _AUTO_NAMES:
            comp = _AUTO_NAMES[comp]
        else:
            for prefix, name in _AUTO_PREFIXES.items():
                if comp.startswith(prefix):
                    comp = name + comp[len(prefix):]
                    break
        out.append(comp)
    return ".".join(out)


def _param(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        if value.ndim == 4:  # HWIO → OIHW
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 3:  # (k, in, out) → (out, in, k)
            return "weight", value.transpose(2, 1, 0)
        if value.ndim == 2:  # (in, out) → (out, in)
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim}")
    if leaf in ("scale", "embedding"):
        return "weight", value
    if leaf == "bias" or leaf in _RAW_PARAMS:
        return leaf, value
    raise KeyError(f"flax param leaf {leaf!r}")


_STATS = {"mean": "running_mean", "var": "running_var"}


def flax_to_state_dict(params: dict, batch_stats: dict | None = None) -> dict[str, torch.Tensor]:
    """The port's state_dict for flax `params` (and `batch_stats`)."""
    sd: dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        name, arr = _param(path[-1], np.asarray(value))
        sd[".".join(filter(None, (_module_name(path[:-1]), name)))] = torch.from_numpy(np.array(arr, np.float32))
    for path, value in _leaves(batch_stats or {}):
        sd[f"{_module_name(path[:-1])}.{_STATS[path[-1]]}"] = torch.from_numpy(np.array(value, np.float32))
    return sd
