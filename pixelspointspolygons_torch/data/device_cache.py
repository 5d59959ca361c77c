"""Device-resident dataset cache — port of
pixelspointspolygons_tpu/data/device_cache.py (`training.device_cache`).

The whole split is packed once on the host (raw uint8 images and ground-truth
rasters, float32 LiDAR points, the small discrete ground truth: Pix2Poly's
token sequences for all 8 D4 elements and permutation factors, HiSup's
junctions, tags and edge indices), uploaded to the device with one pinned
copy per array, and each batch is gathered, D4-moved, jittered and
normalized there: per step the host sends a few hundred bytes of indices and
augmentation parameters. JAX's `_chunked_device_put` worked around a TPU
host link that stalled on large transfers; it changes no number and is not
carried over.

The batcher is plain PyTorch vectorized over the batch (JAX's is one jitted
function, no Pallas kernel): the images, masks and rasters move by one
gather with the D4 element's precomputed index map, the points, keypoints
and angle values by per-element selections, with JAX's arithmetic, so the
uint8-derived leaves, the junctions, edges, tokens and permutations equal
JAX's cache's. The rasters convert as XLA compiles JAX's arithmetic: a
division by a constant as a product with its reciprocal, `u8 · π / 255 +
π / 2` as one fused multiply-add with the constant π/255 (computed exactly
in float64 here), so that the card and the CPU give JAX's bits.

Augmentation parity: the epoch order (`RandomState(seed + epoch)`) and each
item's parameters (`RandomState((seed·1_000_003 + epoch·10_007 + i) %
2^31)`, `augment.sample_params`) replay the host loader's, so the D4
elements and photometric factors are the host loader's. The Gaussian-noise
field and the LiDAR point shuffle come from a `torch.Generator` on the
cache's device, seeded per batch; JAX draws them from `jax.random`, and
neither matches the host loader bit for bit. The colour jitter takes each
image's own mean, summed in another order than XLA's, and converts HSV with
its own arithmetic, not cv2's; the images are not rounded to float16 as the
host path rounds them.

LiDAR: each cloud is trimmed to the split's largest point count rounded up
to 1024, not padded to `max_num_points` as the host loader pads it; a tile
with more points than the cap keeps a fixed first-cap subset. The
PillarFeatureNet's train-mode BatchNorm counts padding rows, so the trim
changes its statistics: a fault on the JAX side that the port keeps
(ROADMAP 3.13).

One process only, as JAX's cache refuses a mesh of more than one device.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import process_count
from ..utils.logger import make_logger
from . import augment
from .dataset import MAX_EDGES, MAX_JUNCTIONS, P3Dataset, build_perm_targets

logger = make_logger("DeviceCache")

# D4_ELEMENTS (e, r90, r180, r270, v, hvt, h, t) as selections of JAX's
# `_d4_xy` cases: x' = [C -] (y if swap else x), y' = [C -] (x if swap else y)
_SWAP = (False, True, False, True, False, True, False, True)
_FLIP_X = (False, False, True, True, False, True, True, False)
_FLIP_Y = (False, True, True, False, True, True, False, False)
# `_d4_angle_value`'s cases as (o ± a) % π, float32 as JAX computes them
_PI = np.float32(np.pi)
_HALF_PI = _PI / np.float32(2)
_THREE_HALF_PI = np.float32(3) * _PI / np.float32(2)
_ANGLE_OFFSET = (0.0, _HALF_PI, _PI, _THREE_HALF_PI, _PI, _THREE_HALF_PI, 0.0, _HALF_PI)
_ANGLE_NEG = (False, False, False, False, True, True, True, True)
# XLA folds a division by a constant into a product with its reciprocal,
# and the constants of `u8 * π / 255` into one (float32 values)
_INV_255 = float(np.float32(1) / np.float32(255))
_PI_OVER_255 = float(_PI / np.float32(255))


class CacheFitError(ValueError):
    """The packed split would not fit safely in device memory. The trainers
    take the host loader instead, even with training.device_cache=true."""


def _device_memory_budget(device: torch.device) -> int | None:
    """Bytes of the card's memory; None on the CPU (no bound)."""
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return None


# --- permutation factors -----------------------------------------------------
# A Pix2Poly permutation row has an off-diagonal successor, a diagonal padding
# 1, or (the open-contour fix) both: stored as (successor, extra-diagonal flag)
# and rebuilt on the device as one_hot(succ) + extra·I.


def perm_factorize(perm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    nmax = perm.shape[0]
    off = perm * (1.0 - np.eye(nmax, dtype=perm.dtype))
    has_off = off.sum(1) > 0
    succ = np.where(has_off, off.argmax(1), np.arange(nmax)).astype(np.int32)
    extra = (np.diagonal(perm) > 0) & has_off
    recon = np.eye(nmax, dtype=np.float32)[succ]
    recon[extra, np.arange(nmax)[extra]] += 1.0
    if not np.array_equal(recon, perm):
        raise ValueError("perm matrix not representable as one_hot(succ)+extra·I")
    return succ.astype(np.int16), extra


def perm_rebuild(succ: torch.Tensor, extra: torch.Tensor, nmax: int) -> torch.Tensor:
    """(B, nmax) int, (B, nmax) bool → (B, nmax, nmax) float32."""
    one = F.one_hot(succ.long(), nmax).float()
    return one + extra.float()[..., None] * torch.eye(nmax, device=succ.device)


# --- photometric ops (JAX :108-151) ------------------------------------------


def _rgb_to_hsv(rgb: torch.Tensor):
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    rng_ = maxc - minc
    s = torch.where(maxc > 0, rng_ / maxc.clamp(min=1e-12), 0.0)
    safe = rng_.clamp(min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng_ > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, maxc


def _hsv_to_rgb(h, s, v) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = (i.long() % 6)[..., None]
    r = torch.stack([v, q, p, p, t, v], -1).gather(-1, sector)
    g = torch.stack([t, v, v, q, p, p], -1).gather(-1, sector)
    b = torch.stack([p, p, t, v, v, q], -1).gather(-1, sector)
    return torch.cat([r, g, b], -1)


def _apply_jitter(unit: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) unit-scale pixels under (B, 4) [brightness, contrast,
    saturation, hue]: augment.apply_image's jitter, each image about its own
    mean."""
    j = jitter[:, None, None, :]
    unit = unit * j[..., 0:1]
    m = unit.mean(dim=(1, 2, 3), keepdim=True)
    unit = (unit - m) * j[..., 1:2] + m
    gray = (0.299 * unit[..., 0] + 0.587 * unit[..., 1] + 0.114 * unit[..., 2])[..., None]
    unit = gray + j[..., 2:3] * (unit - gray)
    h, s, v = _rgb_to_hsv(unit.clamp(0.0, 1.0))
    h = (h + j[..., 3]) % 1.0
    return _hsv_to_rgb(h, s, v)


# --- D4 on the device ----------------------------------------------------------


def _d4_index_maps(size: int, device: torch.device) -> torch.Tensor:
    """(8, size²) int64: row g holds, for each pixel of a square map under
    D4 element g, the flat index of its source pixel (augment.apply_d4_image
    applied to the index grid)."""
    grid = np.arange(size * size).reshape(size, size)
    maps = np.stack([augment.apply_d4_image(grid, g).reshape(-1) for g in augment.D4_ELEMENTS])
    return torch.from_numpy(maps).to(device)


def _d4_image(x: torch.Tensor, d4: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """(B, S, S, ...) maps, each under its own D4 element: one gather."""
    B, hw = x.shape[0], maps.shape[1]
    src = maps[d4] + torch.arange(B, device=x.device)[:, None] * hw
    return x.reshape(B * hw, -1).index_select(0, src.reshape(-1)).reshape(x.shape)


def _d4_tables(device: torch.device) -> dict:
    """Each D4 element's selections, indexed by its position in
    augment.D4_ELEMENTS, on `device` (made once per cache: a table built
    from host values per batch would be a blocking copy)."""
    return {
        "swap": torch.tensor(_SWAP, device=device),
        "flip_x": torch.tensor(_FLIP_X, device=device),
        "flip_y": torch.tensor(_FLIP_Y, device=device),
        "angle_offset": torch.tensor(_ANGLE_OFFSET, dtype=torch.float32, device=device),
        "angle_neg": torch.tensor(_ANGLE_NEG, device=device),
    }


def _d4_xy(pts: torch.Tensor, d4: torch.Tensor, height: int, width: int, tables: dict) -> torch.Tensor:
    """(B, N, 2+) points whose first two columns are (x, y), each sample
    under its own D4 element, with JAX's `_d4_xy` and `_d4_points`
    arithmetic (W1 - x, H1 - y in float32); further columns (a LiDAR
    point's z) unchanged."""
    swap = tables["swap"][d4][:, None]
    w1 = pts.new_full((), float(width - 1))
    h1 = pts.new_full((), float(height - 1))
    x, y = pts[..., 0], pts[..., 1]
    bx, by = torch.where(swap, y, x), torch.where(swap, x, y)
    nx = torch.where(tables["flip_x"][d4][:, None], torch.where(swap, h1, w1) - bx, bx)
    ny = torch.where(tables["flip_y"][d4][:, None], torch.where(swap, w1, h1) - by, by)
    return torch.cat([nx[..., None], ny[..., None], pts[..., 2:]], -1)


def _d4_angle_value(angle: torch.Tensor, d4: torch.Tensor, tables: dict) -> torch.Tensor:
    """Tangent-angle values (radians mod π) of (B, ...) fields under each
    sample's D4 element (augment.apply_d4_crossfield_angle), as JAX computes
    them: the identity unchanged, h as (-a) % π, the rest (o ± a) % π."""
    shape = (-1,) + (1,) * (angle.ndim - 1)
    o = tables["angle_offset"][d4].reshape(shape)
    neg = tables["angle_neg"][d4].reshape(shape)
    moved = torch.where(neg, torch.where(o == 0, -angle, o - angle), angle + o) % angle.new_full((), float(_PI))
    return torch.where((d4 == 0).reshape(shape), angle, moved)


# --- packs (host, one-time, persisted) -----------------------------------------


def _load_pack_if_current(path: str, n_expected: int):
    """A persisted pack, if its row count is the split's; else None (the
    pack's name carries no tile count, so a pack of another `num_train`
    is rebuilt, not reused)."""
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        rows = int(z["image_id"].shape[0])
        if rows == n_expected:
            return {k: z[k] for k in z.files}
    logger.warning(f"stale device-cache pack {path}: {rows} rows != split length {n_expected} — rebuilding")
    return None


def _atomic_savez(path: str, arrays: dict) -> None:
    """Write a pack to a temporary name, then rename it: a reader never loads
    a half-written file."""
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _modality_tag(cfg) -> str:
    enc = cfg.experiment.encoder
    return ("i" if bool(enc.use_images) else "") + ("l" if bool(enc.use_lidar) else "")


def _pack_each(n: int, pack_one) -> None:
    with cf.ThreadPoolExecutor(16) as ex:
        list(ex.map(pack_one, range(n)))


def _pack_lidar(raw_pts: list, max_points: int) -> dict:
    """The clouds trimmed to the split's largest point count rounded up to
    1024 (at most `max_points`), zero-padded, with their point counts."""
    counts = np.asarray([len(p) for p in raw_pts], np.int32)
    cap = int(min(max_points, ((int(counts.max()) + 1023) // 1024) * 1024))
    lidar = np.zeros((len(raw_pts), cap, 3), np.float32)
    for i, p in enumerate(raw_pts):
        k = min(len(p), cap)
        lidar[i, :k] = p[:k]
    return {"lidar": lidar, "lidar_n": np.minimum(counts, cap)}


def _cache_path(cfg, split: str) -> str:
    nmax = int(cfg.experiment.model.tokenizer.max_num_vertices)
    bins = int(cfg.experiment.model.tokenizer.num_bins)
    mod = _modality_tag(cfg)
    tag = "" if mod == "i" else f"_{mod}"
    return os.path.join(cfg.experiment.dataset.in_path, f"p2p_cache_torch_{split}_n{nmax}_b{bins}{tag}.npz")


def build_p2p_cache_arrays(cfg, split: str, tokenizer) -> dict:
    """The Pix2Poly pack: uint8 images, the token sequence of every D4
    element (the tokenizer unshuffled), the permutation factors, the ids."""
    if bool(cfg.experiment.model.tokenizer.shuffle_tokens) or bool(cfg.experiment.model.shuffle_polygons):
        raise NotImplementedError(
            "the device cache precomputes token sequences, so it cannot shuffle tokens or polygons "
            "(as in JAX; training.device_cache=auto takes the host loader): "
            "ROADMAP 'Port queue' item 'Device cache'")
    from .synthetic import ensure_synthetic_dataset

    ensure_synthetic_dataset(cfg)
    path = _cache_path(cfg, split)
    ds = P3Dataset(cfg, split, tokenizer=tokenizer)
    n = len(ds)
    cached = _load_pack_if_current(path, n)
    if cached is not None:
        return cached
    nmax, L = tokenizer.max_num_vertices, tokenizer.max_len
    H, W = int(cfg.experiment.encoder.in_height), int(cfg.experiment.encoder.in_width)
    images = np.zeros((n, H, W, 3), np.uint8) if ds.use_images else None
    ys = np.zeros((len(augment.D4_ELEMENTS), n, L), np.int16)
    succ = np.zeros((n, nmax), np.int16)
    extra = np.zeros((n, nmax), bool)
    image_id = np.zeros((n,), np.int32)
    raw_pts: list = [None] * n

    def pack_one(idx: int) -> None:
        info = ds.coco.imgs[ds.tile_ids[idx]]
        if ds.use_images:
            images[idx] = ds._image(info)
        if ds.use_lidar:
            raw_pts[idx] = ds._lidar(info)[: ds.max_points]
        image_id[idx] = info["id"]
        corners, perm = build_perm_targets(ds._polygons(info), nmax)
        succ[idx], extra[idx] = perm_factorize(perm)
        for gi, g in enumerate(augment.D4_ELEMENTS):
            c = (augment.apply_d4_keypoints(corners, g, info["height"], info["width"])
                 if len(corners) and g != "e" else corners)
            yx = c[:, ::-1].copy() if len(c) else c
            tokens, _ = tokenizer(yx, shuffle=False)
            ys[gi, idx] = tokenizer.pad(tokens).astype(np.int16)

    _pack_each(n, pack_one)
    arrays = {"ys": ys, "succ": succ, "extra": extra, "image_id": image_id}
    if ds.use_images:
        arrays["images"] = images
    if ds.use_lidar:
        arrays.update(_pack_lidar(raw_pts, ds.max_points))
    _atomic_savez(path, arrays)
    logger.info(f"packed {split} device cache ({n} tiles) → {path}")
    return arrays


def _hisup_cache_path(cfg, split: str) -> str:
    m = cfg.experiment.model
    S = int(m.decoder.in_feature_size)
    max_j = int(m.get("max_junctions") or MAX_JUNCTIONS)
    max_e = int(m.get("max_edges") or MAX_EDGES)
    name = f"hisup_cache_torch_{split}_s{S}_j{max_j}_e{max_e}_{_modality_tag(cfg)}.npz"
    return os.path.join(cfg.experiment.dataset.in_path, name)


def build_hisup_cache_arrays(cfg, split: str) -> dict:
    """The HiSup pack: uint8 images, float32 LiDAR, the junctions as the
    tile gives them with their convex/concave tags (D4 keeps hull
    membership), the polygon edges as junction indices (their coordinates
    are rebuilt on the device from the moved junctions), and the masks at
    the image's and the decoder's resolution (D4 commutes with a square
    nearest-neighbour resize). Polygons are cut where the host loader cuts
    them (`model.max_junctions`, `model.max_edges`)."""
    import cv2

    from ..utils.coco import seg_to_mask
    from .synthetic import ensure_synthetic_dataset

    ensure_synthetic_dataset(cfg)
    path = _hisup_cache_path(cfg, split)
    ds = P3Dataset(cfg, split)
    n = len(ds)
    cached = _load_pack_if_current(path, n)
    if cached is not None:
        return cached
    m = cfg.experiment.model
    max_j = int(m.get("max_junctions") or MAX_JUNCTIONS)
    max_e = int(m.get("max_edges") or MAX_EDGES)
    S = int(m.decoder.in_feature_size)
    H, W = int(cfg.experiment.encoder.in_height), int(cfg.experiment.encoder.in_width)

    images = np.zeros((n, H, W, 3), np.uint8) if ds.use_images else None
    juncs = np.zeros((n, max_j, 2), np.float32)
    tags = np.zeros((n, max_j), np.int32)
    jvalid = np.zeros((n, max_j), bool)
    eidx = np.zeros((n, max_e, 2), np.int32)
    evalid = np.zeros((n, max_e), bool)
    mask_h = np.zeros((n, H, W), np.uint8)
    mask_s = mask_h if S == W else np.zeros((n, S, S), np.uint8)
    image_id = np.zeros((n,), np.int32)
    raw_pts: list = [None] * n

    def pack_one(idx: int) -> None:
        info = ds.coco.imgs[ds.tile_ids[idx]]
        if ds.use_images:
            images[idx] = ds._image(info)
        if ds.use_lidar:
            raw_pts[idx] = ds._lidar(info)[: ds.max_points]
        image_id[idx] = info["id"]
        mask = np.zeros((info["height"], info["width"]), np.float32)
        for ann in ds.coco.imgToAnns.get(info["id"], []):
            mask += seg_to_mask(ann["segmentation"], info["height"], info["width"])
        mask_h[idx] = np.clip(mask, 0, 1).astype(np.uint8)
        if S != W:
            mask_s[idx] = cv2.resize(mask_h[idx], (S, S), interpolation=cv2.INTER_NEAREST)
        jp = ep = 0
        for p in ds._polygons(info):
            pts = np.asarray(p, np.float32)
            nn = len(pts)
            if jp + nn > max_j or ep + nn > max_e:
                break
            hull = cv2.convexHull(pts).reshape(-1, 2)
            is_convex = np.array([np.any(np.all(np.isclose(hull, q, atol=1e-3), axis=1)) for q in pts])
            juncs[idx, jp : jp + nn] = pts
            tags[idx, jp : jp + nn] = np.where(is_convex, 2, 1)
            jvalid[idx, jp : jp + nn] = True
            eidx[idx, ep : ep + nn, 0] = jp + np.arange(nn)
            eidx[idx, ep : ep + nn, 1] = jp + (np.arange(nn) + 1) % nn
            evalid[idx, ep : ep + nn] = True
            jp += nn
            ep += nn

    _pack_each(n, pack_one)
    arrays = {"junctions": juncs, "junc_tags": tags, "junc_valid": jvalid, "eidx": eidx,
              "edges_valid": evalid, "mask_h": mask_h, "image_id": image_id}
    if S != W:
        arrays["mask_s"] = mask_s
    if ds.use_images:
        arrays["images"] = images
    if ds.use_lidar:
        arrays.update(_pack_lidar(raw_pts, ds.max_points))
    _atomic_savez(path, arrays)
    logger.info(f"packed {split} hisup device cache ({n} tiles) → {path}")
    return arrays


def _ffl_cache_path(cfg, split: str) -> str:
    seg = cfg.experiment.model.loss.seg
    wtag = "w" if (bool(seg.get("use_dist")) or bool(seg.get("use_size"))) else ""
    return os.path.join(cfg.experiment.dataset.in_path, f"ffl_devcache_torch_{split}_{_modality_tag(cfg)}{wtag}.npz")


def build_ffl_cache_arrays(cfg, split: str) -> tuple[dict, np.ndarray]:
    """The FFL pack: uint8 images, the raw uint8 ground-truth rasters as the
    per-tile cache (`ffl_cache_torch`) holds them (polygons as interior,
    edge, vertex; the normal-angle field), the distance and size maps as
    float16 only when the seg loss weighs by them, float32 LiDAR. Returns
    (arrays, class_freq)."""
    from .synthetic import ensure_synthetic_dataset

    ensure_synthetic_dataset(cfg)
    path = _ffl_cache_path(cfg, split)
    ds = P3Dataset(cfg, split)
    class_freq = ds.class_freq if ds.class_freq is not None else np.array([0.9, 0.1], np.float32)
    n = len(ds)
    cached = _load_pack_if_current(path, n)
    if cached is not None:
        return cached, class_freq
    seg = cfg.experiment.model.loss.seg
    need_w = bool(seg.get("use_dist")) or bool(seg.get("use_size"))
    H, W = int(cfg.experiment.encoder.in_height), int(cfg.experiment.encoder.in_width)

    images = np.zeros((n, H, W, 3), np.uint8) if ds.use_images else None
    poly = np.zeros((n, H, W, 3), np.uint8)
    angle = np.zeros((n, H, W), np.uint8)
    dist = np.zeros((n, H, W), np.float16) if need_w else None
    sizes = np.zeros((n, H, W), np.float16) if need_w else None
    image_id = np.zeros((n,), np.int32)
    raw_pts: list = [None] * n

    def pack_one(idx: int) -> None:
        info = ds.coco.imgs[ds.tile_ids[idx]]
        if ds.use_images:
            images[idx] = ds._image(info)
        if ds.use_lidar:
            raw_pts[idx] = ds._lidar(info)[: ds.max_points]
        image_id[idx] = info["id"]
        gt = ds._ffl_gt(info)
        poly[idx] = gt["gt_polygons_image"]
        angle[idx] = gt["gt_crossfield_angle"]
        if need_w:
            dist[idx] = gt["distances"].astype(np.float16)
            sizes[idx] = gt["sizes"].astype(np.float16)

    _pack_each(n, pack_one)
    arrays = {"poly": poly, "angle": angle, "image_id": image_id}
    if need_w:
        arrays["dist"] = dist
        arrays["sizes"] = sizes
    if ds.use_images:
        arrays["images"] = images
    if ds.use_lidar:
        arrays.update(_pack_lidar(raw_pts, ds.max_points))
    _atomic_savez(path, arrays)
    logger.info(f"packed {split} ffl device cache ({n} tiles) → {path}")
    return arrays, class_freq


# --- the cache -------------------------------------------------------------------


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _DeviceCacheBase:
    """A split on the device with its batcher. Subclasses give the packed
    arrays (`_build_arrays`) and a batch's leaves (`_batch`); the epoch order
    and the augmentation parameters are the host loader's.

    `pack_s`, `upload_s` and `nbytes` record the one-time set-up."""

    def __init__(self, cfg, split: str, device: torch.device | str, batch_size: int | None = None):
        if process_count() != 1:
            raise ValueError(f"{type(self).__name__} runs in one process; {process_count()} were started")
        self.cfg = cfg
        self.split = split
        self.device = torch.device(device)
        self.is_train = split == "train"
        self.batch_size = int(batch_size or cfg.experiment.model.batch_size)
        self.seed = int(cfg.get("seed", 42))
        enc = cfg.experiment.encoder
        self.augmentations = list(enc.augmentations or []) if self.is_train else []
        self.max_pix = float(enc.get("image_max_pixel_value", 255.0))
        self.use_images = bool(enc.use_images)
        self.use_lidar = bool(enc.use_lidar)
        self.in_h, self.in_w = int(enc.in_height), int(enc.in_width)

        t = time.perf_counter()
        arrays = self._build_arrays()
        self.pack_s = time.perf_counter() - t
        self.n = len(arrays["image_id"])
        self.nbytes = sum(a.nbytes for a in arrays.values())
        budget = _device_memory_budget(self.device)
        # at least half the card stays for the model, the optimizer and the
        # activations: a cache that crowds them out fails at the first step
        if budget is not None and self.nbytes > 0.5 * budget:
            raise CacheFitError(
                f"{split} cache is {self.nbytes / 1e9:.1f} GB — more than half the device's {budget / 1e9:.1f} GB; "
                "falling back to the host loader (use a smaller split)")
        logger.info(f"uploading {split} cache to {self.device}: {self.n} tiles, {self.nbytes / 1e6:.0f} MB")
        t = time.perf_counter()
        self.dev = {k: _upload(v, self.device) for k, v in arrays.items() if k != "image_id"}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_s = time.perf_counter() - t
        self.image_id = arrays["image_id"]
        self.mean = torch.tensor(list(enc.get("image_mean", [0, 0, 0])), dtype=torch.float32, device=self.device)
        self.std = torch.tensor(list(enc.get("image_std", [1, 1, 1])), dtype=torch.float32, device=self.device)
        self.maps = {self.in_w: _d4_index_maps(self.in_w, self.device)}
        self.tables = _d4_tables(self.device)
        self.generator = torch.Generator(device=self.device)

    def __len__(self) -> int:
        if self.is_train:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch_batches(self, epoch: int):
        """Yield one epoch's batches: the leaves on the device, `sample_valid`
        and `image_id` as host numpy. The eval split's last batch is
        repeat-padded as the host loader pads it."""
        B = self.batch_size
        order = np.arange(self.n)
        if self.is_train:
            np.random.RandomState(self.seed + epoch).shuffle(order)
            order = order[: (self.n // B) * B]
        for b in range((len(order) + B - 1) // B):
            sel = order[b * B : (b + 1) * B]
            valid = np.ones((B,), bool)
            if len(sel) < B:
                valid[len(sel):] = False
                sel = np.concatenate([sel, np.full(B - len(sel), sel[0] if len(sel) else 0)])
            d4 = np.zeros((B,), np.int64)
            params = np.tile(np.array([1, 1, 1, 0, 0], np.float32), (B, 1))  # jitter (4), sigma
            if self.is_train:
                for k, i in enumerate(sel):
                    rng = np.random.RandomState((self.seed * 1_000_003 + epoch * 10_007 + int(i)) % (2**31))
                    p = augment.sample_params(rng, self.augmentations)
                    d4[k] = augment.D4_ELEMENTS.index(p["d4"])
                    if p.get("jitter"):
                        j = p["jitter"]
                        params[k, :4] = [j["brightness"], j["contrast"], j["saturation"], j["hue"]]
                    if p.get("noise_sigma"):
                        params[k, 4] = p["noise_sigma"]
            self.generator.manual_seed((self.seed * 7_919 + epoch * 104_729 + b) % (2**31))
            idx = _upload(np.stack([sel.astype(np.int64), d4]), self.device)
            params_dev = _upload(params, self.device)
            batch = self._batch(idx[0], idx[1], params_dev[:, :4], params_dev[:, 4])
            batch["sample_valid"] = valid
            batch["image_id"] = self.image_id[sel]
            yield batch

    # shared building blocks
    def _augment_images(self, idxs, d4, jitter, sigma) -> torch.Tensor:
        """The uint8 images of `idxs`, D4-moved, jittered, noised, normalized
        (augment.apply_image's arithmetic): (B, H, W, 3) float32."""
        imgs = _d4_image(self.dev["images"][idxs], d4, self.maps[self.in_w])
        unit = imgs.float() * _INV_255
        if "ColorJitter" in self.augmentations:
            unit = _apply_jitter(unit, jitter)
        if "GaussNoise" in self.augmentations:
            noise = torch.randn(unit.shape, generator=self.generator, device=self.device)
            unit = unit + noise * sigma[:, None, None, None]
        unit = unit.clamp(0.0, 1.0)
        return (unit * 255.0 / self.max_pix - self.mean) / self.std

    def _lidar_batch(self, idxs, d4) -> tuple[torch.Tensor, torch.Tensor]:
        """The clouds of `idxs`, D4-moved and (train) shuffled, padding zeroed."""
        pts = _d4_xy(self.dev["lidar"][idxs], d4, self.in_h, self.in_w, self.tables)
        cap = pts.shape[1]
        mask = torch.arange(cap, device=self.device)[None, :] < self.dev["lidar_n"][idxs][:, None]
        if self.is_train:
            perm = torch.rand((pts.shape[0], cap), generator=self.generator, device=self.device).argsort(dim=1)
            pts = pts.gather(1, perm[..., None].expand(-1, -1, pts.shape[2]))
            mask = mask.gather(1, perm)
        return pts * mask[..., None], mask

    def _inputs(self, idxs, d4, jitter, sigma) -> dict:
        batch = {}
        if self.use_images:
            batch["images"] = self._augment_images(idxs, d4, jitter, sigma)
        if self.use_lidar:
            batch["lidar"], batch["lidar_mask"] = self._lidar_batch(idxs, d4)
        return batch


class P2PDeviceCache(_DeviceCacheBase):
    """A Pix2Poly split on the device (any modality): `y` (int64 tokens of
    the sample's D4 element) and `y_perm` beside the model inputs."""

    def __init__(self, cfg, split: str, tokenizer, device, batch_size: int | None = None):
        self.tokenizer = tokenizer
        self.nmax = tokenizer.max_num_vertices
        super().__init__(cfg, split, device, batch_size)

    def _build_arrays(self) -> dict:
        return build_p2p_cache_arrays(self.cfg, self.split, self.tokenizer)

    def _batch(self, idxs, d4, jitter, sigma) -> dict:
        batch = self._inputs(idxs, d4, jitter, sigma)
        batch["y"] = self.dev["ys"][d4, idxs].long()
        batch["y_perm"] = perm_rebuild(self.dev["succ"][idxs], self.dev["extra"][idxs], self.nmax)
        return batch


class HiSupDeviceCache(_DeviceCacheBase):
    """A HiSup split on the device: the junctions D4-moved, the edges rebuilt
    from them, the masks moved; `encode_targets` then builds the targets on
    the device in the train step."""

    def __init__(self, cfg, split: str, device, batch_size: int | None = None):
        self.S = int(cfg.experiment.model.decoder.in_feature_size)
        super().__init__(cfg, split, device, batch_size)
        self.maps.setdefault(self.S, _d4_index_maps(self.S, self.device))

    def _build_arrays(self) -> dict:
        return build_hisup_cache_arrays(self.cfg, self.split)

    def _batch(self, idxs, d4, jitter, sigma) -> dict:
        batch = self._inputs(idxs, d4, jitter, sigma)
        S, dev = self.S, self.dev
        jv = dev["junc_valid"][idxs]
        ev = dev["edges_valid"][idxs]
        t = _d4_xy(dev["junctions"][idxs], d4, self.in_h, self.in_w, self.tables)
        t = torch.where(jv[..., None], t, 0.0)
        if S != self.in_w:
            # the host loader clips the junctions and scales the edges unclipped
            t = t * (S / self.in_w)
            j_out = t.clamp(0.0, S - 1e-4)
        else:
            j_out = t
        ei = dev["eidx"][idxs].long()
        ea = t.gather(1, ei[..., 0:1].expand(-1, -1, 2))
        eb = t.gather(1, ei[..., 1:2].expand(-1, -1, 2))
        mask_s = dev["mask_s"] if "mask_s" in dev else dev["mask_h"]
        batch.update(
            junctions=j_out,
            junc_tags=dev["junc_tags"][idxs] * jv,
            junc_valid=jv,
            edges=torch.where(ev[..., None], torch.cat([ea, eb], -1), 0.0),
            edges_valid=ev,
            mask=_d4_image(mask_s[idxs], d4, self.maps[S]).float(),
            mask_ori=_d4_image(dev["mask_h"][idxs], d4, self.maps[self.in_w]).float(),
        )
        return batch


class FFLDeviceCache(_DeviceCacheBase):
    """An FFL split on the device: the raw uint8 rasters D4-moved, converted
    and the angle values rotated with `P3Dataset._item_ffl`'s arithmetic."""

    def __init__(self, cfg, split: str, device, batch_size: int | None = None):
        super().__init__(cfg, split, device, batch_size)
        self.class_freq_dev = torch.as_tensor(self.class_freq, dtype=torch.float32, device=self.device)

    def _build_arrays(self) -> dict:
        arrays, self.class_freq = build_ffl_cache_arrays(self.cfg, self.split)
        return arrays

    def _batch(self, idxs, d4, jitter, sigma) -> dict:
        batch = self._inputs(idxs, d4, jitter, sigma)
        dev, maps = self.dev, self.maps[self.in_w]
        poly = _d4_image(dev["poly"][idxs], d4, maps).float() * _INV_255
        batch["gt_polygons_image"] = poly.permute(0, 3, 1, 2)
        # the stored field is normals; rotate to tangents (dataset.py::_item_ffl):
        # fma(u8, π/255, π/2), exact in float64 (at most 33 significant bits)
        ang = _d4_image(dev["angle"][idxs], d4, maps).double() * _PI_OVER_255 + float(_HALF_PI)
        ang = ang.float() % ang.new_full((), float(_PI), dtype=torch.float32)
        if self.is_train:
            ang = _d4_angle_value(ang, d4, self.tables)
        batch["gt_crossfield_angle"] = ang[:, None]
        for key, name in (("dist", "distances"), ("sizes", "sizes")):
            if key in dev:
                batch[name] = _d4_image(dev[key][idxs], d4, maps).float()[:, None]
        batch["class_freq"] = self.class_freq_dev.expand(len(idxs), -1)
        return batch
