"""Pretrained torch checkpoints → the port's parameter names — the port's own
copy of pixelspointspolygons_tpu/utils/torch_port.py (numpy only).

The JAX package maps a timm, DINOv2 or HRNetV2 state_dict onto its flax
trees; here the same files map onto the port's modules, whose layouts are
torch's own: `Linear` weights stay (out, in) and convolution kernels OIHW,
so nothing is transposed. Each map returns `{name: numpy array}` keyed by
the port's `state_dict` names relative to the trunk it fills.

Key map (timm → `models/vit.py::ViTBackbone`):
  cls_token, pos_embed            → cls_token (1, 1, D), pos_embed
  patch_embed.proj.{weight,bias}  → patch_embed.{weight,bias}
  blocks.i.norm1 / norm2          → block{i}.ln0 / ln1
  blocks.i.attn.qkv (fused)       → block{i}.attn.{q,k,v} (split in three)
  blocks.i.attn.proj              → block{i}.attn.o
  blocks.i.mlp.fc{1,2}            → block{i}.mlp.dense{0,1}
  blocks.i.ls{1,2}.gamma (DINOv2) → block{i}.ls{1,2}
  norm                            → norm
HRNetV2 (`models/hrnet.py::HRNetEncoder`): the reference's module names
(`layer1.0.conv1`, `stage3.1.branches.2.0.bn1`, `transition2.2.0.0`,
`last_layer.3`, ...) → the port's (`layer1_b0.conv1`,
`stage3_m1.branch2_b0.bn1`, `transition2_2_0_conv`, `last_conv2`, ...).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _np(t: Any) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


# keys that identify where the trunk lives inside a real checkpoint (real
# files wrap it in `module.` (DDP), `backbone.`, `encoder.`, ...)
_VIT_ANCHOR = "cls_token"
_HRNET_ANCHOR = "conv1.weight"


def normalize_state_dict(sd: Mapping[str, Any], anchor: str = _VIT_ANCHOR) -> tuple[dict, str]:
    """Strip the wrapper prefix of a real checkpoint's state_dict.

    Finds the shortest prefix P such that `P + anchor` is a key, and returns
    ({k-without-P: v for keys under P}, P). Keys outside P are dropped. A
    no-op when the anchor is already a bare key. Only a prefix that ends at
    a '.' counts, so that 'my_cls_token' or 'layer1.0.conv1.weight' donate
    no prefix."""
    keys = list(sd.keys())
    if anchor in keys:
        return dict(sd), ""
    candidates = sorted(
        (k[: -len(anchor)] for k in keys if k.endswith("." + anchor) and k[: -len(anchor)].endswith(".")),
        key=len,
    )
    for prefix in candidates:
        sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if anchor in sub:
            return sub, prefix
    return dict(sd), ""


def _fuse_qkv(sd: dict, p: str) -> tuple[np.ndarray, np.ndarray]:
    """The (3D, D) qkv weight and (3D,) bias of block prefix `p`
    ('blocks.i.'), from timm's fused `attn.qkv.*` or from separate
    `attn.{q,k,v}.*` or `attn.{q,k,v}_proj.*` projections."""
    if p + "attn.qkv.weight" in sd:
        return sd[p + "attn.qkv.weight"], sd[p + "attn.qkv.bias"]
    for stem in ("attn.{}.{}", "attn.{}_proj.{}"):
        if p + stem.format("q", "weight") in sd:
            w = np.concatenate([sd[p + stem.format(x, "weight")] for x in "qkv"], axis=0)
            b = np.concatenate([sd[p + stem.format(x, "bias")] for x in "qkv"], axis=0)
            return w, b
    raise KeyError(p + "attn.qkv.weight")


# key stems a ViT map consumes; anything else in the (normalized)
# state_dict is an extra to skip and log (heads, mask_token, dist_token, ...)
_VIT_CONSUMED_STEMS = ("cls_token", "pos_embed", "patch_embed.", "blocks.", "norm.")


def vit_unconsumed_keys(sd: Mapping[str, Any]) -> list[str]:
    return [k for k in sd if not k.startswith(_VIT_CONSUMED_STEMS)]


def port_timm_vit(state_dict: Mapping[str, Any], depth: int = 12) -> dict[str, np.ndarray]:
    """A timm VisionTransformer state_dict → `ViTBackbone` names."""
    sd, _prefix = normalize_state_dict({k: _np(v) for k, v in state_dict.items()})
    out = {
        "cls_token": sd["cls_token"].reshape(1, 1, -1),
        "pos_embed": sd["pos_embed"],
        "patch_embed.weight": sd["patch_embed.proj.weight"],
        "patch_embed.bias": sd["patch_embed.proj.bias"],
    }
    for i in range(depth):
        p, q = f"blocks.{i}.", f"block{i}."
        qkv_w, qkv_b = _fuse_qkv(sd, p)
        for name, w, b in zip("qkv", np.split(qkv_w, 3, axis=0), np.split(qkv_b, 3, axis=0)):
            out[f"{q}attn.{name}.weight"], out[f"{q}attn.{name}.bias"] = w, b
        pairs = {"ln0": "norm1", "ln1": "norm2", "attn.o": "attn.proj", "mlp.dense0": "mlp.fc1", "mlp.dense1": "mlp.fc2"}
        for ours, theirs in pairs.items():
            out[f"{q}{ours}.weight"] = sd[f"{p}{theirs}.weight"]
            out[f"{q}{ours}.bias"] = sd[f"{p}{theirs}.bias"]
    out["norm.weight"], out["norm.bias"] = sd["norm.weight"], sd["norm.bias"]
    return out


def load_pretrained_vit(checkpoint_file: str, depth: int = 12) -> dict[str, np.ndarray]:
    """A torch `.pth` of a timm ViT (its state_dict, or one nested under
    `state_dict`, then under `model`) ported by `port_timm_vit` (JAX
    :133-142). The file is read with `weights_only=True`, and only a
    payload that this refuses is unpickled in full, as JAX reads every
    file."""
    import pickle

    import torch

    try:
        payload = torch.load(checkpoint_file, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        payload = torch.load(checkpoint_file, map_location="cpu", weights_only=False)
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    if isinstance(payload, dict) and "model" in payload and isinstance(payload["model"], dict):
        payload = payload["model"]
    return port_timm_vit(payload, depth=depth)


def port_dinov2_vit(state_dict: Mapping[str, Any], depth: int = 12) -> dict[str, np.ndarray]:
    """A DINOv2 ViT state_dict: timm's layout plus the per-block LayerScale
    gammas (`blocks.i.ls1.gamma`, `ls2.gamma`)."""
    out = port_timm_vit(state_dict, depth=depth)
    sd, _prefix = normalize_state_dict({k: _np(v) for k, v in state_dict.items()})
    for i in range(depth):
        out[f"block{i}.ls1"] = sd[f"blocks.{i}.ls1.gamma"]
        out[f"block{i}.ls2"] = sd[f"blocks.{i}.ls2.gamma"]
    return out


def _hrnet_entries(
    *,
    width: int = 48,
    stage1_planes: int = 64,
    stage1_blocks: int = 4,
    num_blocks: int = 4,
    num_modules=(1, 4, 3),
    stem_ch: int = 64,
):
    """(reference prefix, port module name, kind) for every conv and BN of
    HRNetV2, in `HRNetEncoder`'s construction order (reference
    models/hrnet/hrnet48v2.py:263-480)."""
    out = [("conv1", "conv1", "conv"), ("bn1", "bn1", "bn"), ("conv2", "conv2", "conv"), ("bn2", "bn2", "bn")]
    for k in range(stage1_blocks):
        t, f = f"layer1.{k}", f"layer1_b{k}"
        for c in ("1", "2", "3"):
            out += [(f"{t}.conv{c}", f"{f}.conv{c}", "conv"), (f"{t}.bn{c}", f"{f}.bn{c}", "bn")]
        if k == 0 and stem_ch != stage1_planes * 4:
            out += [(f"{t}.downsample.0", f"{f}.down_conv", "conv"), (f"{t}.downsample.1", f"{f}.down_bn", "bn")]
    widths = [width * (2**i) for i in range(1 + len(num_modules))]
    pre = [stage1_planes * 4]
    for stage, nmod in zip(range(2, 2 + len(num_modules)), num_modules):
        cur = widths[:stage]
        t_idx = stage - 1
        for i in range(len(cur)):
            if i < len(pre):
                if pre[i] != cur[i]:
                    out += [(f"transition{t_idx}.{i}.0", f"transition{t_idx}_{i}_conv", "conv"),
                            (f"transition{t_idx}.{i}.1", f"transition{t_idx}_{i}_bn", "bn")]
            else:
                for j in range(i + 1 - len(pre)):
                    out += [(f"transition{t_idx}.{i}.{j}.0", f"transition{t_idx}_{i}_{j}_conv", "conv"),
                            (f"transition{t_idx}.{i}.{j}.1", f"transition{t_idx}_{i}_{j}_bn", "bn")]
        n = len(cur)
        for m in range(nmod):
            t, f = f"stage{stage}.{m}", f"stage{stage}_m{m}"
            for i in range(n):
                for k in range(num_blocks):
                    tb, fb = f"{t}.branches.{i}.{k}", f"{f}.branch{i}_b{k}"
                    out += [(f"{tb}.conv1", f"{fb}.conv1", "conv"), (f"{tb}.bn1", f"{fb}.bn1", "bn"),
                            (f"{tb}.conv2", f"{fb}.conv2", "conv"), (f"{tb}.bn2", f"{fb}.bn2", "bn")]
            for i in range(n):
                for j in range(n):
                    if j > i:
                        out += [(f"{t}.fuse_layers.{i}.{j}.0", f"{f}.fuse{i}_{j}_conv", "conv"),
                                (f"{t}.fuse_layers.{i}.{j}.1", f"{f}.fuse{i}_{j}_bn", "bn")]
                    elif j < i:
                        for k in range(i - j):
                            out += [(f"{t}.fuse_layers.{i}.{j}.{k}.0", f"{f}.fuse{i}_{j}_{k}_conv", "conv"),
                                    (f"{t}.fuse_layers.{i}.{j}.{k}.1", f"{f}.fuse{i}_{j}_{k}_bn", "bn")]
        pre = cur
    out += [("last_layer.0", "last_conv1", "conv"), ("last_layer.1", "last_bn", "bn"),
            ("last_layer.3", "last_conv2", "conv")]
    return out


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def port_hrnet(state_dict: Mapping[str, Any], target: Mapping[str, Any], **topo
               ) -> tuple[dict[str, np.ndarray], list[str], list[str]]:
    """An HRNetV2 state_dict onto an `HRNetEncoder` whose tensors are
    `target` (its `state_dict()`, for the names and shapes).

    Modules the file lacks (the ImageNet checkpoint has no `last_layer.*`)
    keep their init: intersect-and-update, as the reference does
    (hrnet48v2.py:542-552). A module the file has but the target lacks, or
    a tensor of another shape, raises (a topology mismatch). Returns
    ({port name: array}, loaded reference prefixes, skipped ones); `topo`
    takes `HRNetEncoder`'s size arguments (width, num_modules, ...)."""
    sd, _prefix = normalize_state_dict({k: _np(v) for k, v in state_dict.items()}, anchor=_HRNET_ANCHOR)
    out: dict[str, np.ndarray] = {}

    def put(name: str, value: np.ndarray) -> None:
        if name not in target:
            raise KeyError(f"{name} not in the model (topology mismatch?)")
        if tuple(np.shape(target[name])) != tuple(np.shape(value)):
            raise ValueError(f"{name} shape {tuple(np.shape(target[name]))} != checkpoint {np.shape(value)}")
        out[name] = value

    loaded, skipped = [], []
    for ref, ours, kind in _hrnet_entries(**topo):
        if f"{ref}.weight" not in sd:
            skipped.append(ref)
            continue
        leaves = ("weight", "bias") if kind == "conv" else _BN_LEAVES
        for leaf in leaves:
            if kind == "bn" or f"{ref}.{leaf}" in sd:
                put(f"{ours}.{leaf}", sd[f"{ref}.{leaf}"])
        loaded.append(ref)
    return out, loaded, skipped


def interpolate_pos_embed(pos: np.ndarray, n_tokens: int) -> np.ndarray:
    """A (1, 1+G², D) ViT position embedding resized to `n_tokens` = 1+G'²
    tokens: the grid part bilinearly (align_corners=False, in float64), the
    CLS row kept. Real checkpoints are 224 px grids (G=28 for patch 8, 16
    for patch 14); this makes them usable at other input sizes."""
    n_src = pos.shape[1] - 1
    if n_src + 1 == n_tokens:
        return pos
    g_src = int(round(np.sqrt(n_src)))
    g_dst = int(round(np.sqrt(n_tokens - 1)))
    if g_src * g_src != n_src or g_dst * g_dst != n_tokens - 1:
        raise ValueError(f"non-square pos_embed grids: {n_src} → {n_tokens - 1}")
    grid = pos[0, 1:].reshape(g_src, g_src, -1).astype(np.float64)
    coords = (np.arange(g_dst) + 0.5) * (g_src / g_dst) - 0.5
    lo = np.clip(np.floor(coords).astype(int), 0, g_src - 1)
    hi = np.clip(lo + 1, 0, g_src - 1)
    frac = np.clip(coords - lo, 0.0, 1.0)
    rows = grid[lo] * (1 - frac)[:, None, None] + grid[hi] * frac[:, None, None]
    resized = rows[:, lo] * (1 - frac)[None, :, None] + rows[:, hi] * frac[None, :, None]
    out = np.concatenate([pos[0, :1], resized.reshape(g_dst * g_dst, -1)], axis=0)
    return out[None].astype(pos.dtype)
