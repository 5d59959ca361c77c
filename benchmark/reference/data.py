"""The reference's inputs, worked out again from the files the benchmark
wrote: the tiles' images, LiDAR points and polygons, Pix2Poly's token
sequences and permutation targets, and the batches that the program's
device cache (`training.device_cache=true`) and its eval loader make of
them, with the same augmentation parameters (D4, colour jitter, Gaussian
noise, LiDAR shuffle) drawn from the same seeds in the same order.

Plain numpy and PyTorch; nothing of the program is imported.
"""

from __future__ import annotations

import json
import os

import cv2
import numpy as np
import torch

D4 = ("e", "r90", "r180", "r270", "v", "hvt", "h", "t")
_SWAP = (False, True, False, True, False, True, False, True)
_FLIP_X = (False, False, True, True, False, True, True, False)
_FLIP_Y = (False, True, True, False, True, True, False, False)
_INV_255 = float(np.float32(1) / np.float32(255))


# --- tiles ---------------------------------------------------------------------


def read_split(ann_path: str) -> tuple[list[dict], dict]:
    """The split's image records in file order and {image id: [annotations]}."""
    with open(ann_path) as f:
        coco = json.load(f)
    anns: dict = {img["id"]: [] for img in coco["images"]}
    for a in coco["annotations"]:
        anns.setdefault(a["image_id"], []).append(a)
    return coco["images"], anns


def load_image(root: str, info: dict) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    img = cv2.imread(os.path.join(root, info["image_path"]), cv2.IMREAD_UNCHANGED)
    return img[..., :3][..., ::-1].copy()


def load_points(root: str, info: dict, z_range: float) -> np.ndarray:
    """(N, 3) float32 points in pixel coordinates: world -> pixel (y down),
    z scaled to [0, z_range] per tile, x and y clipped to the tile."""
    pts = np.load(os.path.join(root, info["lidar_path"])).astype(np.float64)
    tl, res = info["top_left"], info["res_x"]
    pts[:, 0] = (pts[:, 0] - tl[0]) / res
    pts[:, 1] = info["height"] - (pts[:, 1] - tl[1]) / res
    zmin, zmax = pts[:, 2].min(), pts[:, 2].max()
    pts[:, 2] = (pts[:, 2] - zmin) / max(zmax - zmin, 1e-6) * z_range
    pts[:, 0] = np.clip(pts[:, 0], 0, info["width"])
    pts[:, 1] = np.clip(pts[:, 1], 0, info["height"])
    return pts.astype(np.float32)


def polygons(info: dict, anns: list) -> list[np.ndarray]:
    """Open (V, 2) (x, y) rings clipped to the tile, closing vertex dropped."""
    out = []
    for a in anns:
        for seg in a["segmentation"]:
            p = np.asarray(seg, np.float64).reshape(-1, 2)
            p[:, 0] = np.clip(p[:, 0], 0, info["width"] - 1)
            p[:, 1] = np.clip(p[:, 1], 0, info["height"] - 1)
            if np.allclose(p[0], p[-1]):
                p = p[:-1]
            if len(p) >= 3:
                out.append(p)
    return out


# --- Pix2Poly targets ------------------------------------------------------------


def perm_targets(polys: list[np.ndarray], nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """The corners (at most nmax) and the (nmax, nmax) successor permutation:
    each ring's vertex i -> i + 1 (cyclic) while both fit, the identity on
    the rows past the corners and on any row or column left empty."""
    corners: list = []
    perm = np.zeros((nmax, nmax), np.float32)
    v = 0
    for p in polys:
        corners.extend(p.tolist())
        n = len(p)
        for i in range(n):
            j = (i + 1) % n
            if v + i > nmax - 1 or v + j > nmax - 1:
                break
            perm[v + i, v + j] = 1.0
        v += n
    for i in range(min(v, nmax), nmax):
        perm[i, i] = 1.0
    for i in range(nmax):
        if perm[i].sum() == 0 or perm[:, i].sum() == 0:
            perm[i, i] = 1.0
    return np.asarray(corners, np.float64).reshape(-1, 2)[:nmax], perm


def d4_keypoints(pts: np.ndarray, g: str, height: int, width: int) -> np.ndarray:
    """(N, 2) (x, y) under the D4 element g (rotations counter-clockwise)."""
    x, y = pts[:, 0].copy(), pts[:, 1].copy()
    W1, H1 = width - 1, height - 1
    x, y = {
        "e": (x, y), "r90": (y, W1 - x), "r180": (W1 - x, H1 - y), "r270": (H1 - y, x),
        "v": (x, H1 - y), "h": (W1 - x, y), "t": (y, x), "hvt": (H1 - y, W1 - x),
    }[g]
    return np.stack([x, y], axis=1)


def d4_image(img: np.ndarray, g: str) -> np.ndarray:
    return {
        "e": lambda a: a, "r90": lambda a: np.rot90(a, 1), "r180": lambda a: np.rot90(a, 2),
        "r270": lambda a: np.rot90(a, 3), "v": lambda a: a[::-1], "h": lambda a: a[:, ::-1],
        "t": lambda a: np.swapaxes(a, 0, 1), "hvt": lambda a: np.swapaxes(a, 0, 1)[::-1, ::-1],
    }[g](img)


def tokens(corners_xy: np.ndarray, s: dict) -> np.ndarray:
    """BOS, (y, x) bin pairs, EOS, PAD to max_len: coordinates over the
    tile's height and width, rounded to num_bins levels."""
    bins, H, W = s["num_bins"], s["height"], s["width"]
    bos, eos, pad = bins, bins + 1, bins + 2
    out = np.full((s["max_len"],), pad, np.int64)
    seq = [bos]
    if len(corners_xy):
        yx = corners_xy[:, ::-1].astype(np.float64).copy()
        yx[:, 0] /= H
        yx[:, 1] /= W
        q = np.rint(yx * (bins - 1)).astype(np.int64)[: s["max_vertices"]]
        seq += q.reshape(-1).tolist()
    seq.append(eos)
    out[: min(len(seq), len(out))] = seq[: len(out)]
    return out


def sample_params(rng: np.random.RandomState, augs: list) -> dict:
    """One item's augmentation draws, in the loader's order: D4 element,
    jitter factors (brightness, contrast, saturation U[0.8, 1.2], hue
    U[-0.2, 0.2]), noise sigma U[sqrt(10), sqrt(50)] / 255."""
    p = {"d4": "e", "jitter": None, "noise_sigma": None}
    if "D4" in augs:
        p["d4"] = D4[rng.randint(len(D4))]
    if "ColorJitter" in augs:
        p["jitter"] = [rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2), rng.uniform(-0.2, 0.2)]
    if "GaussNoise" in augs:
        p["noise_sigma"] = rng.uniform(np.sqrt(10.0), np.sqrt(50.0)) / 255.0
    return p


# --- prediction inputs -------------------------------------------------------------


def eval_images(images_u8: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 -> the eval loader's float32 images: /255, x255,
    /255 in float32 (mean 0, std 1), carried to the card as float16."""
    unit = np.clip(images_u8.astype(np.float32) / 255.0, 0.0, 1.0)
    return ((unit * 255.0) / 255.0).astype(np.float16).astype(np.float32)


# --- the device cache's training batches ----------------------------------------------


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc, minc = rgb.amax(-1), rgb.amin(-1)
    rng_ = maxc - minc
    s = torch.where(maxc > 0, rng_ / maxc.clamp(min=1e-12), 0.0)
    safe = rng_.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng_ > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    sector = (i.long() % 6)[..., None]
    r = torch.stack([v, q, p, p, t, v], -1).gather(-1, sector)
    g = torch.stack([t, v, v, q, p, p], -1).gather(-1, sector)
    b = torch.stack([p, p, t, v, v, q], -1).gather(-1, sector)
    return torch.cat([r, g, b], -1)


def jitter(unit: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast about each image's mean, saturation about its
    luma, hue rotation in HSV: (B, H, W, 3) under (B, 4) factors."""
    j = j[:, None, None, :]
    unit = unit * j[..., 0:1]
    m = unit.mean(dim=(1, 2, 3), keepdim=True)
    unit = (unit - m) * j[..., 1:2] + m
    gray = (0.299 * unit[..., 0] + 0.587 * unit[..., 1] + 0.114 * unit[..., 2])[..., None]
    unit = gray + j[..., 2:3] * (unit - gray)
    h, s, v = _rgb_to_hsv(unit.clamp(0.0, 1.0))
    return _hsv_to_rgb((h + j[..., 3]) % 1.0, s, v)


def d4_points(pts: torch.Tensor, d4: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, N, 3) points, each sample under its own D4 element, z unchanged."""
    dev = pts.device
    swap = torch.tensor(_SWAP, device=dev)[d4][:, None]
    fx = torch.tensor(_FLIP_X, device=dev)[d4][:, None]
    fy = torch.tensor(_FLIP_Y, device=dev)[d4][:, None]
    w1, h1 = pts.new_full((), float(width - 1)), pts.new_full((), float(height - 1))
    x, y = pts[..., 0], pts[..., 1]
    bx, by = torch.where(swap, y, x), torch.where(swap, x, y)
    nx = torch.where(fx, torch.where(swap, h1, w1) - bx, bx)
    ny = torch.where(fy, torch.where(swap, w1, h1) - by, by)
    return torch.cat([nx[..., None], ny[..., None], pts[..., 2:]], -1)


class TrainSplit:
    """A training split as the device cache packs it: uint8 images, the
    clouds cut to the split's largest point count rounded up to 1024 (at
    most `max_points`), the token sequence of every D4 element, the
    permutation targets."""

    def __init__(self, root: str, ann_path: str, s: dict, augs: list, max_points: int, z_range: float):
        infos, anns = read_split(ann_path)
        self.s, self.augs, self.n = s, list(augs), len(infos)
        self.images = np.stack([load_image(root, i) for i in infos]) if s["use_images"] else None
        self.ys = np.zeros((len(D4), self.n, s["max_len"]), np.int64)
        self.perm = np.zeros((self.n, s["max_vertices"], s["max_vertices"]), np.float32)
        for k, info in enumerate(infos):
            corners, self.perm[k] = perm_targets(polygons(info, anns[info["id"]]), s["max_vertices"])
            for gi, g in enumerate(D4):
                c = d4_keypoints(corners, g, info["height"], info["width"]) if len(corners) and g != "e" else corners
                self.ys[gi, k] = tokens(c, s)
        self.lidar = self.lidar_n = None
        if s["use_lidar"]:
            raw = [load_points(root, i, z_range)[:max_points] for i in infos]
            counts = np.asarray([len(p) for p in raw])
            cap = int(min(max_points, ((int(counts.max()) + 1023) // 1024) * 1024))
            self.lidar = np.zeros((self.n, cap, 3), np.float32)
            for k, p in enumerate(raw):
                self.lidar[k, : min(len(p), cap)] = p[:cap]
            self.lidar_n = np.minimum(counts, cap)

    def batch_plan(self, seed: int, epoch: int, b: int, batch_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tile indices, D4 element indices, (B, 5) jitter and sigma) of
        training batch b of `epoch`."""
        order = np.arange(self.n)
        np.random.RandomState(seed + epoch).shuffle(order)
        sel = order[: (self.n // batch_size) * batch_size][b * batch_size:(b + 1) * batch_size]
        d4 = np.zeros((batch_size,), np.int64)
        params = np.tile(np.array([1, 1, 1, 0, 0], np.float32), (batch_size, 1))
        for k, i in enumerate(sel):
            p = sample_params(np.random.RandomState((seed * 1_000_003 + epoch * 10_007 + int(i)) % (2**31)),
                              self.augs)
            d4[k] = D4.index(p["d4"])
            if p["jitter"]:
                params[k, :4] = p["jitter"]
            if p["noise_sigma"]:
                params[k, 4] = p["noise_sigma"]
        return sel, d4, params

    def batch(self, seed: int, epoch: int, b: int, batch_size: int, device) -> dict:
        """Training batch b of `epoch` on `device`, the noise field and the
        point shuffle drawn from a generator on `device` seeded per batch."""
        sel, d4, params = self.batch_plan(seed, epoch, b, batch_size)
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * 7_919 + epoch * 104_729 + b) % (2**31))
        out: dict = {}
        p = torch.from_numpy(params).to(device)
        if self.images is not None:
            imgs = np.stack([d4_image(self.images[i], D4[g]) for i, g in zip(sel, d4)])
            unit = torch.from_numpy(imgs).to(device).float() * _INV_255
            if "ColorJitter" in self.augs:
                unit = jitter(unit, p[:, :4])
            if "GaussNoise" in self.augs:
                noise = torch.randn(unit.shape, generator=gen, device=device)
                unit = unit + noise * p[:, 4][:, None, None, None]
            out["images"] = unit.clamp(0.0, 1.0) * 255.0 / 255.0
        if self.lidar is not None:
            d4_t = torch.from_numpy(d4).to(device)
            pts = d4_points(torch.from_numpy(self.lidar[sel]).to(device), d4_t, self.s["height"], self.s["width"])
            cap = pts.shape[1]
            mask = torch.arange(cap, device=device)[None] < torch.from_numpy(self.lidar_n[sel]).to(device)[:, None]
            order = torch.rand((len(sel), cap), generator=gen, device=device).argsort(dim=1)
            pts = pts.gather(1, order[..., None].expand(-1, -1, 3))
            mask = mask.gather(1, order)
            out["lidar"], out["lidar_mask"] = pts * mask[..., None], mask
        out["y"] = torch.from_numpy(self.ys[d4, sel]).to(device)
        out["y_perm"] = torch.from_numpy(self.perm[sel]).to(device)
        return out
