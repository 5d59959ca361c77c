"""P3 dataset, the Pix2Poly, HiSup and FFL items — the port's copy of
pixelspointspolygons_tpu/data/dataset.py (:40-374).

Every item has static shapes (padded LiDAR with its mask, padded token,
permutation, junction and edge arrays) so a batch is a dict of fixed-shape
numpy arrays.
- LiDAR (JAX :78-117, :175-202, :239-245): `.npz` (as `data/synthetic.py`
  writes it), `.npy`, uncompressed `.las` and LASzip `.laz` (the port's
  `laz.py`); world → pixel coordinates, z normalised per tile to
  `in_voxel_size.z`, x and y clipped to the tile; the tile's D4 element;
  shuffled on the train split (the reference's PointShuffle) with the
  item's rng after the image's draws, as JAX draws; padded with zeros to
  `max_num_points` (`lidar_mask` False there). The padding is kept whole:
  the PillarFeatureNet's train-mode BatchNorm counts its rows.
- Pix2Poly: the corners as a padded token sequence and the ground-truth
  permutation (cyclic successor per polygon, identity padding, the
  open-contour fix), `build_perm_targets`.
- HiSup: junctions with concave/convex tags (convex-hull test), the polygon
  edges and the instance mask; the jloc/joff/afm targets are built on the
  device in the train step (models/hisup/model.py::encode_targets).
- FFL: the rasterized polygons [interior, edge, vertex], the distance and
  size maps and the tangent-angle field (`ffl_gt.py`, computed once per
  tile and cached under `<dataset_dir>/ffl_cache_torch/<split>`), moved by
  the sampled D4 element, and the split's class frequencies; in eval mode
  only the image and its id, which is what prediction reads.
"""

from __future__ import annotations

import os
import threading

import cv2
import numpy as np

from ..utils.coco import CocoIndex, seg_to_mask
from ..utils.logger import make_logger
from . import augment
from .ffl_gt import compute_ffl_gt

MAX_JUNCTIONS = 256
MAX_EDGES = 256


def build_perm_targets(polys: list[np.ndarray], nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Pix2Poly GT: concatenated corners (≤ nmax, 2) + (nmax, nmax) cyclic
    successor permutation with identity-diag padding and the open-contour fix
    (reference datasets/p3_coco.py:340-436, 409-414)."""
    corners: list = []
    perm = np.zeros((nmax, nmax), np.float32)
    v_count = 0
    for p in polys:
        corners.extend(p.tolist())
        n = len(p)
        for i in range(n):
            j = (i + 1) % n
            if v_count + i > nmax - 1 or v_count + j > nmax - 1:
                break
            perm[v_count + i, v_count + j] = 1.0
        v_count += n
    for i in range(min(v_count, nmax), nmax):
        perm[i, i] = 1.0
    # open-contour fix (p3_coco.py:409-414)
    for i in range(nmax):
        if perm[i].sum() == 0 or perm[:, i].sum() == 0:
            perm[i, i] = 1.0
    return np.asarray(corners, np.float64).reshape(-1, 2)[:nmax], perm


def load_image_file(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3][..., ::-1].copy()  # BGR → RGB


def load_las_points(path: str) -> np.ndarray:
    """(N, 3) float64 x, y, z of an uncompressed .las file (a LASzip payload
    under a .las name goes to `read_laz`)."""
    with open(path, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise ValueError(f"not a LAS file: {path}")
        point_offset = int.from_bytes(header[96:100], "little")
        fmt = header[104]
        if fmt > 10:  # a LAZ-compressed payload
            from ..laz import read_laz

            return read_laz(path)
        rec_len = int.from_bytes(header[105:107], "little")
        n = int.from_bytes(header[107:111], "little")
        sx, sy, sz = np.frombuffer(header[131:155], "<f8")
        ox, oy, oz = np.frombuffer(header[155:179], "<f8")
        if n == 0 and len(header) >= 255:
            n = int.from_bytes(header[247:255], "little")
        f.seek(point_offset)
        raw = np.frombuffer(f.read(n * rec_len), np.uint8).reshape(n, rec_len)
        xyz_i = raw[:, :12].copy().view("<i4").reshape(n, 3).astype(np.float64)
        return xyz_i * [sx, sy, sz] + [ox, oy, oz]


def load_lidar_file(path: str) -> np.ndarray:
    """(N, 3) float64 points of a .npz, .npy, .las or .laz file."""
    if path.endswith(".npz"):
        return np.load(path)["points"].astype(np.float64)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float64)
    if path.endswith(".las"):
        return load_las_points(path)
    if path.endswith(".laz"):
        from ..laz import read_laz

        return read_laz(path)
    raise ValueError(f"unsupported lidar format: {path}")


class P3Dataset:
    def __init__(self, cfg, split: str, tokenizer=None, eval_mode: bool = False):
        """eval_mode forces inference transforms (Normalize only) whatever
        the split; Pix2Poly items need the `tokenizer`."""
        self.cfg = cfg
        self.split = split
        self.eval_mode = eval_mode
        self.logger = make_logger(f"{split}Dataset")
        self.tokenizer = tokenizer

        ds = cfg.experiment.dataset
        self.dataset_dir = ds.in_path
        ann_file = ds.annotations[split]
        if not os.path.isfile(ann_file):
            raise FileNotFoundError(ann_file)
        self.coco = CocoIndex(ann_file)
        self.tile_ids = self.coco.get_img_ids()
        subset = ds.get(f"{split}_subset")
        if subset:
            self.tile_ids = self.tile_ids[: int(subset)]

        enc = cfg.experiment.encoder
        self.use_images = bool(enc.use_images)
        self.use_lidar = bool(enc.use_lidar)
        self.model_type = cfg.experiment.model.name
        self.max_points = int(enc.get("max_num_points", 200000)) if self.use_lidar else 0
        self.z_range = float(enc.in_voxel_size.z) if self.use_lidar else 100.0
        is_train = split == "train" and not eval_mode
        self.augmentations = list(enc.augmentations or []) if is_train else (
            ["Normalize"] if "Normalize" in (enc.augmentations or []) else []
        )
        self.image_mean = list(enc.get("image_mean", [0.0, 0.0, 0.0]))
        self.image_std = list(enc.get("image_std", [1.0, 1.0, 1.0]))
        self.max_pixel_value = float(enc.get("image_max_pixel_value", 255.0))

        stats_file = ds.ffl_stats[split] if self.model_type == "ffl" else None
        self.class_freq = None
        if stats_file and os.path.isfile(stats_file):
            self.class_freq = np.load(stats_file)["class_freq"].astype(np.float32)
        # the port's own cache (the JAX package's is ffl_cache/<split>)
        self._ffl_cache_dir = os.path.join(self.dataset_dir, "ffl_cache_torch", split)

    def __len__(self) -> int:
        return len(self.tile_ids)

    def _image(self, info) -> np.ndarray:
        rel = info.get("image_path") or os.path.join("images", self.split, info["file_name"])
        return load_image_file(os.path.join(self.dataset_dir, rel))

    def _lidar(self, info) -> np.ndarray:
        """The tile's points in pixel coordinates, float32 (JAX :175-191;
        reference p3_coco.py:84-99)."""
        pts = load_lidar_file(os.path.join(self.dataset_dir, info["lidar_path"]))
        top_left = info.get("top_left")
        res = info.get("res_x", 0.25)
        if top_left is not None:
            pts = pts.copy()
            pts[:, 0] = (pts[:, 0] - top_left[0]) / res
            pts[:, 1] = (pts[:, 1] - top_left[1]) / res
            pts[:, 1] = info["height"] - pts[:, 1]
        zmin, zmax = pts[:, 2].min(), pts[:, 2].max()
        pts[:, 2] = (pts[:, 2] - zmin) / max(zmax - zmin, 1e-6) * self.z_range
        pts[:, 0] = np.clip(pts[:, 0], 0, info["width"])
        pts[:, 1] = np.clip(pts[:, 1], 0, info["height"])
        return pts.astype(np.float32)

    def _pad_lidar(self, pts: np.ndarray, rng) -> tuple[np.ndarray, np.ndarray]:
        """(max_points, 3) points and their (max_points,) mask; shuffled
        first on the train split (JAX :193-202)."""
        out = np.zeros((self.max_points, 3), np.float32)
        mask = np.zeros((self.max_points,), bool)
        if self.split == "train" and not self.eval_mode:  # PointShuffle (o3d parity)
            # the rows in the order JAX's `rng.shuffle(pts)` leaves them, from
            # the same draws: numpy moves a 2-D array's rows one at a time
            # under the GIL (most of a LiDAR batch's time, and no loader
            # thread runs beside it), a 1-D index in one pass
            order = np.arange(len(pts))
            rng.shuffle(order)
            pts = pts[order]
        n = min(len(pts), self.max_points)
        out[:n] = pts[:n]
        mask[:n] = True
        return out, mask

    def _polygons(self, info) -> list[np.ndarray]:
        """Open-ring (V, 2) (x, y) polygons, clipped to the tile."""
        polys = []
        for ann in self.coco.imgToAnns.get(info["id"], []):
            for seg in ann["segmentation"]:
                p = np.asarray(seg, np.float64).reshape(-1, 2)
                p[:, 0] = np.clip(p[:, 0], 0, info["width"] - 1)
                p[:, 1] = np.clip(p[:, 1], 0, info["height"] - 1)
                if np.allclose(p[0], p[-1]):
                    p = p[:-1]
                if len(p) >= 3:
                    polys.append(p)
        return polys

    def get_item(self, idx: int, rng: np.random.RandomState) -> dict:
        if self.model_type == "pix2poly":
            return self._item_pix2poly(idx, rng)
        if self.model_type == "hisup":
            return self._item_hisup(idx, rng)
        if self.model_type == "ffl":
            return self._item_ffl_eval(idx, rng) if self.eval_mode else self._item_ffl(idx, rng)
        raise ValueError(f"unknown model {self.model_type!r}")

    def _common(self, info, rng, params) -> dict:
        item: dict = {"image_id": np.int32(info["id"])}
        if self.use_images:
            img = self._image(info)
            item["images"] = augment.apply_image(
                img, params, self.image_mean, self.image_std, self.max_pixel_value, rng
            ).astype(np.float32)
        if self.use_lidar:
            pts = self._lidar(info)
            if params["d4"] != "e":
                pts = augment.apply_d4_lidar(pts, params["d4"], info["height"], info["width"])
            item["lidar"], item["lidar_mask"] = self._pad_lidar(pts, rng)
        return item

    def _item_pix2poly(self, idx: int, rng) -> dict:
        if self.tokenizer is None:
            raise ValueError("Pix2Poly items need a tokenizer")
        info = self.coco.imgs[self.tile_ids[idx]]
        params = augment.sample_params(rng, self.augmentations)
        item = self._common(info, rng, params)

        polys = self._polygons(info)
        nmax = self.tokenizer.max_num_vertices
        corners, perm = build_perm_targets(polys, nmax)
        if len(corners) and params["d4"] != "e":
            corners = augment.apply_d4_keypoints(corners, params["d4"], info["height"], info["width"])
        # the tokenizer takes (y, x)
        yx = corners[:, ::-1].copy() if len(corners) else corners
        tokens, _ = self.tokenizer(yx, shuffle=self.cfg.experiment.model.tokenizer.shuffle_tokens, rng=rng)
        item["y"] = self.tokenizer.pad(tokens)
        item["y_perm"] = perm
        return item

    def _item_ffl_eval(self, idx: int, rng) -> dict:
        """What FFL prediction reads of an item: the image, the LiDAR and its
        mask, and the id. The training item (`_item_ffl`) also carries the
        FFL ground truth."""
        info = self.coco.imgs[self.tile_ids[idx]]
        return self._common(info, rng, augment.sample_params(rng, self.augmentations))

    def _item_ffl(self, idx: int, rng) -> dict:
        """The FFL training and val item (JAX :336-359)."""
        info = self.coco.imgs[self.tile_ids[idx]]
        params = augment.sample_params(rng, self.augmentations)
        item = self._common(info, rng, params)

        gt = self._ffl_gt(info)
        g = params["d4"]
        poly_img = augment.apply_d4_image(gt["gt_polygons_image"], g).astype(np.float32) / 255.0
        angle = augment.apply_d4_image(gt["gt_crossfield_angle"], g).astype(np.float32) * np.pi / 255.0
        # the stored field is normals; rotate to tangents (p3_coco.py:289-290)
        angle = (angle + np.pi / 2) % np.pi
        if self.split == "train" and not self.eval_mode:
            angle = augment.apply_d4_crossfield_angle(angle, g)
        item.update(
            gt_polygons_image=np.ascontiguousarray(np.transpose(poly_img, (2, 0, 1))),
            distances=np.ascontiguousarray(augment.apply_d4_image(gt["distances"], g))[None],
            sizes=np.ascontiguousarray(augment.apply_d4_image(gt["sizes"], g))[None],
            gt_crossfield_angle=np.ascontiguousarray(angle)[None],
            class_freq=self.class_freq if self.class_freq is not None else np.array([0.9, 0.1], np.float32),
        )
        return item

    def _ffl_gt(self, info) -> dict:
        """The tile's FFL ground truth, from the cache or computed and cached
        (JAX :361-374). The write goes to a temporary file named after the
        process and thread, then `os.replace`, so loader threads and
        processes never read a half-written file."""
        cache = os.path.join(self._ffl_cache_dir, f"{info['id']}.npz")
        if os.path.isfile(cache):
            with np.load(cache) as z:
                return {k: z[k] for k in z.files}
        gt = compute_ffl_gt(self._polygons(info), info["height"], info["width"])
        os.makedirs(self._ffl_cache_dir, exist_ok=True)
        # np.savez appends .npz to a name without it
        tmp = cache + f".tmp{os.getpid()}_{threading.get_ident()}.npz"
        np.savez_compressed(tmp, **gt)
        os.replace(tmp, cache)
        return gt

    def _item_hisup(self, idx: int, rng) -> dict:
        info = self.coco.imgs[self.tile_ids[idx]]
        params = augment.sample_params(rng, self.augmentations)
        item = self._common(info, rng, params)
        H, W = info["height"], info["width"]

        mask = np.zeros((H, W), np.float32)
        for ann in self.coco.imgToAnns.get(info["id"], []):
            mask += seg_to_mask(ann["segmentation"], H, W)
        mask = np.clip(mask, 0, 1)
        if params["d4"] != "e":
            mask = np.ascontiguousarray(augment.apply_d4_image(mask, params["d4"]))

        model_cfg = self.cfg.experiment.model
        max_j = int(model_cfg.get("max_junctions") or MAX_JUNCTIONS)
        max_e = int(model_cfg.get("max_edges") or MAX_EDGES)
        juncs = np.zeros((max_j, 2), np.float32)
        tags = np.zeros((max_j,), np.int32)
        jvalid = np.zeros((max_j,), bool)
        edges = np.zeros((max_e, 4), np.float32)
        evalid = np.zeros((max_e,), bool)
        jp = ep = 0
        for p in self._polygons(info):
            pts = p.copy()
            if params["d4"] != "e":
                pts = augment.apply_d4_keypoints(pts, params["d4"], H, W)
            n = len(pts)
            if jp + n > max_j or ep + n > max_e:
                self.logger.warning(
                    f"tile {info['id']}: HiSup GT truncated at "
                    f"{jp} junctions / {ep} edges (caps "
                    f"model.max_junctions={max_j}, model.max_edges={max_e}) — "
                    "remaining polygons dropped from training targets"
                )
                break
            # convex-hull membership → tag 2 (convex), else 1 (p3_coco.py:648-657)
            hull = cv2.convexHull(pts.astype(np.float32)).reshape(-1, 2)
            is_convex = np.array(
                [np.any(np.all(np.isclose(hull, q, atol=1e-3), axis=1)) for q in pts]
            )
            juncs[jp : jp + n] = pts
            tags[jp : jp + n] = np.where(is_convex, 2, 1)
            jvalid[jp : jp + n] = True
            for i in range(n):
                a, b = pts[i], pts[(i + 1) % n]
                edges[ep + i] = [a[0], a[1], b[0], b[1]]
            evalid[ep : ep + n] = True
            jp += n
            ep += n

        # decoder-resolution rescale (reference resize_hisup_annotations)
        S = int(self.cfg.experiment.model.decoder.in_feature_size)
        if S != W:
            s = S / W
            juncs = np.clip(juncs * s, 0, S - 1e-4)
            edges = edges * s
            mask_r = cv2.resize(mask.astype(np.uint8), (S, S), interpolation=cv2.INTER_NEAREST)
        else:
            mask_r = mask
        item.update(
            junctions=juncs,
            junc_tags=tags,
            junc_valid=jvalid,
            edges=edges,
            edges_valid=evalid,
            mask=mask_r.astype(np.float32),
            mask_ori=mask.astype(np.float32),
        )
        return item
