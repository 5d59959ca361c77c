"""FFL polygonization: marching-squares contours on the host → the ACM
optimization on the device → corner-aware simplification on the host — port
of pixelspointspolygons_tpu/predict/ffl_polygonize.py.

- Contours are traced on the host by the native marching squares
  (`native.py`) and packed into one flat concat for the whole batch, padded
  to a bucket of the total vertex count ({4096, 16384, 65536}); rings past
  MAX_TOTAL_VERTS are dropped, as in JAX, so both drop the same rings.
- ACM: `steps` SGD updates with the reference's linear warmup, each the
  gradient of `_acm_loss` (alignment of each edge with the crossfield at its
  rounded midpoint, the level-set data term, the squared edge lengths) by
  torch autograd, on the device the maps are on. JAX runs the same updates
  as `jax.grad` under `lax.scan`; the bucketing that bounds its jit shapes
  is kept so that the work and the dropped rings are the same.
- Post-processing (corner detection from the u/v alignment XOR, splitting
  at corners, Douglas-Peucker per polyline, the image-border face union,
  the area and probability filters) is JAX's host code, copied.

The `asm` method (`ffl_asm.py`) skeletonizes instead of tracing contours
and optimizes a skeleton graph; it shares the post-processing.
"""

from __future__ import annotations

import logging
import time

import cv2
import numpy as np
import torch

from ..native import ContourOverflow, find_contours
from ..ops.bilinear import bilinear_interpolate
from ..ops.crossfield import framefield_align_error

MAX_TOTAL_VERTS = 65536  # cap across a batch (logged when hit)
# the smallest padded flat size and its growth: {4096, 16384, 65536}
MIN_BUCKET = 4096
BUCKET_GROWTH = 4
V_MAX = 4096  # per-ring decimation cap (a 224 px tile's perimeter is ~900)


# --------------------------------------------------------------------------
# host: contour init + packing
# --------------------------------------------------------------------------


def extract_contours_flagged(mask: np.ndarray, level: float = 0.5) -> list[tuple[np.ndarray, bool]]:
    """Boundary contours [(ring (V, 2) float (y, x), closed)] of one (H, W)
    probability map. Open contours (closed=False) start and end on the image
    border: the ones the image-border union closes.

    The native marching squares traces them; only when its buffers
    overflow does cv2's integer boundary tracing stand in, as in JAX
    (:48-79). A native library that does not build raises."""
    try:
        out = []
        for ring, closed in find_contours(mask, level):
            if closed and len(ring) >= 4:
                out.append((ring[:-1].copy(), True))  # drop repeated last vertex
            elif not closed and len(ring) >= 2:
                out.append((ring.copy(), False))
        return out
    except ContourOverflow:
        pass
    binary = (mask > level).astype(np.uint8)
    contours, _ = cv2.findContours(binary, cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
    out = []
    for c in contours:
        c = c.reshape(-1, 2).astype(np.float64)  # (x, y)
        if len(c) < 3:
            continue
        out.append((c[:, ::-1].copy(), True))  # → (y, x); cv2 traces closed
    return out


def _decimate(ring: np.ndarray, max_len: int) -> np.ndarray:
    if len(ring) <= max_len:
        return ring
    idx = np.linspace(0, len(ring) - 1, max_len).astype(int)
    return ring[np.unique(idx)]


def _bucket(n: int) -> int:
    """Next padded size ≥ n in the {4096, 16384, 65536} ladder (JAX's, so
    that both optimize the same padded arrays)."""
    b = MIN_BUCKET
    while b < n:
        b *= BUCKET_GROWTH
    return b


def pack_contours(contours_per_sample: list[list[tuple[np.ndarray, bool]]]):
    """Flat-concat packing of all rings of the whole mini-batch (the same
    layout as the reference's TensorPoly flat concat, tensorpoly.py:6-139,
    but with absolute `next` indices instead of slices so every array op is a
    gather):

    → (pos (N, 2) f32, vmask (N,) bool, next_idx (N,) i32 absolute,
       point_batch (N,) i32, pinned (N,) bool,
       rings [(start, n, batch, closed)], total_kept)

    N is the power-of-two bucket of the total vertex count. Open polylines
    get no wrap-around edge and their endpoints are pinned (the reference
    pins TensorPoly endpoints every optimizer step, polygonize_acm.py:203-204).
    Rings past MAX_TOTAL_VERTS are dropped (caller logs)."""
    rings_meta: list[tuple[int, int, int, bool]] = []
    chunks: list[np.ndarray] = []
    total = 0
    dropped = 0
    for b, rings in enumerate(contours_per_sample):
        for ring, closed in rings:
            ring = _decimate(ring, V_MAX)
            n = len(ring)
            if n < (3 if closed else 2):
                continue
            if total + n > MAX_TOTAL_VERTS:
                dropped += 1
                continue
            rings_meta.append((total, n, b, closed))
            chunks.append(np.asarray(ring, np.float32))
            total += n

    N = _bucket(total)
    pos = np.zeros((N, 2), np.float32)
    vmask = np.zeros((N,), bool)
    next_idx = np.arange(N, dtype=np.int32)  # padding points to self
    point_batch = np.zeros((N,), np.int32)
    pinned = np.zeros((N,), bool)
    for (start, n, b, closed), ring in zip(rings_meta, chunks):
        pos[start : start + n] = ring
        vmask[start : start + n] = True
        point_batch[start : start + n] = b
        if closed:
            next_idx[start : start + n] = start + (np.arange(n) + 1) % n
        else:
            next_idx[start : start + n - 1] = start + np.arange(1, n)
            pinned[start] = pinned[start + n - 1] = True
    return pos, vmask, next_idx, point_batch, pinned, rings_meta, dropped


# --------------------------------------------------------------------------
# device: ACM optimization
# --------------------------------------------------------------------------


def _acm_loss(pos, vmask, next_idx, point_batch, indicator, c0c2, params):
    """PolygonAlignLoss on the flat representation (JAX :160-195).

    pos: (N, 2) (y, x); indicator: (B, H, W); c0c2: (B, 4, H, W)."""
    H, W = indicator.shape[1], indicator.shape[2]
    nxt = pos[next_idx]  # (N, 2)
    edges = nxt - pos
    norms = torch.sqrt(torch.sum(edges * edges, dim=-1) + 1e-12)  # safe at 0 (padded edges)
    fmask = (vmask & (norms > 0.1)).to(pos.dtype)

    mid = (pos + nxt) / 2.0
    mi = torch.round(mid[..., 0]).long().clamp(0, H - 1)
    mj = torch.round(mid[..., 1]).long().clamp(0, W - 1)
    cf = c0c2[point_batch, :, mi, mj]  # (N, 4)
    c0 = torch.complex(cf[..., 0], cf[..., 1])
    c2 = torch.complex(cf[..., 2], cf[..., 3])
    zn = edges / (norms[..., None] + 1e-3)
    z = torch.complex(zn[..., 0], zn[..., 1])
    align_loss = (framefield_align_error(c0, c2, z) * fmask).sum()

    vals = bilinear_interpolate(indicator[:, None], pos, point_batch)[:, 0]
    level_loss = (((vals - params["data_level"]) ** 2) * vmask).sum()

    length_loss = ((norms * fmask) ** 2).sum()

    coef_sum = float(np.float32(params["data_coef"]) + np.float32(params["length_coef"])
                     + np.float32(params["crossfield_coef"]))
    return (
        params["data_coef"] * level_loss
        + params["length_coef"] * length_loss
        + params["crossfield_coef"] * align_loss
    ) / coef_sum


def warmup_rates(steps: int, poly_lr: float, warmup_iters: int, warmup_factor: float) -> np.ndarray:
    """poly_lr times the reference's LambdaLR warmup coefficient at each
    step, in float32 in JAX's order of operations (:222-229)."""
    f32 = np.float32
    it = np.arange(steps, dtype=np.int32)
    ramp = (f32(f32(warmup_factor) - f32(1.0)) * (warmup_iters - it).astype(f32)) / f32(warmup_iters)
    coef = np.where(it < warmup_iters, f32(1.0) + ramp, f32(1.0)).astype(f32)
    return f32(poly_lr) * coef


def acm_optimize(
    pos,
    vmask,
    next_idx,
    point_batch,
    indicator,
    c0c2,
    pinned=None,
    *,
    steps: int = 500,
    poly_lr: float = 0.01,
    warmup_iters: int = 100,
    warmup_factor: float = 0.1,
    data_level: float = 0.5,
    data_coef: float = 0.1,
    length_coef: float = 0.4,
    crossfield_coef: float = 0.5,
) -> torch.Tensor:
    """`steps` SGD updates of the packed positions with the reference's
    warmup (polygonize_acm.py:186-199; JAX :198-241): padding and pinned
    endpoints do not move. All tensors on one device (the maps' float32
    values); returns the optimized (N, 2) positions there."""
    # float32 values, as JAX traces them
    params = {
        "data_level": float(np.float32(data_level)),
        "data_coef": float(np.float32(data_coef)),
        "length_coef": float(np.float32(length_coef)),
        "crossfield_coef": float(np.float32(crossfield_coef)),
    }
    dev = indicator.device
    fm = vmask.to(torch.float32)[..., None]
    if pinned is not None:
        fm = fm * (1.0 - pinned.to(torch.float32))[..., None]
    rates = torch.from_numpy(warmup_rates(steps, poly_lr, warmup_iters, warmup_factor)).to(dev)
    p = pos.detach().clone().requires_grad_(True)
    for it in range(steps):
        acm_step(p, rates[it], fm, vmask, next_idx, point_batch, indicator, c0c2, params)
    return p.detach()


def acm_kwargs(acm_cfg) -> dict:
    """acm_optimize's keyword arguments from the `acm_method` config."""
    return dict(
        steps=int(acm_cfg.steps),
        poly_lr=float(acm_cfg.poly_lr),
        warmup_iters=int(acm_cfg.warmup_iters),
        warmup_factor=float(acm_cfg.warmup_factor),
        data_level=float(acm_cfg.data_level),
        data_coef=float(acm_cfg.data_coef),
        length_coef=float(acm_cfg.length_coef),
        crossfield_coef=float(acm_cfg.crossfield_coef),
    )


def acm_step(p, rate, fm, vmask, next_idx, point_batch, indicator, c0c2, params) -> None:
    """One SGD update of the leaf tensor `p` in place: p -= rate·∇loss·fm
    (`fm` zero at padding and pinned endpoints), with no read back to the
    host, so the card runs the steps as fast as the host queues them."""
    loss = _acm_loss(p, vmask, next_idx, point_batch, indicator, c0c2, params)
    (g,) = torch.autograd.grad(loss, p)
    with torch.no_grad():
        p.sub_(rate * g * fm)


# --------------------------------------------------------------------------
# host: post-processing
# --------------------------------------------------------------------------


def detect_corners(
    ring: np.ndarray, u: np.ndarray, v: np.ndarray, closed: bool = True
) -> np.ndarray:
    """Corner mask for a polyline (V, 2) (y, x): XOR of u/v alignment of
    the left and right edges (reference frame_field_utils.detect_corners).
    Endpoints of open polylines are never corners."""
    n = len(ring)
    if closed:
        left = ring[np.arange(n) - 1] - ring  # edge to previous vertex
        right = np.roll(ring, -1, axis=0) - ring
    else:
        left = np.zeros_like(ring)
        left[1:] = ring[:-1] - ring[1:]
        right = np.zeros_like(ring)
        right[:-1] = ring[1:] - ring[:-1]
    ij = np.clip(np.round(ring).astype(int), [0, 0], [u.shape[0] - 1, u.shape[1] - 1])
    uu = u[ij[:, 0], ij[:, 1]]
    vv = v[ij[:, 0], ij[:, 1]]

    def u_aligned(edges):
        su = np.abs(uu.real * edges[:, 0] + uu.imag * edges[:, 1])
        sv = np.abs(vv.real * edges[:, 0] + vv.imag * edges[:, 1])
        return sv < su

    out = np.logical_xor(u_aligned(left), u_aligned(right))
    if not closed:
        out[0] = out[-1] = False
    return out


def douglas_peucker(points: np.ndarray, tol: float) -> np.ndarray:
    """Iterative DP simplification of an open polyline (keeps endpoints)."""
    if len(points) < 3:
        return points
    keep = np.zeros(len(points), bool)
    keep[0] = keep[-1] = True
    stack = [(0, len(points) - 1)]
    while stack:
        a, b = stack.pop()
        if b <= a + 1:
            continue
        seg = points[b] - points[a]
        seg_len = np.linalg.norm(seg)
        pts = points[a + 1 : b]
        if seg_len < 1e-12:
            d = np.linalg.norm(pts - points[a], axis=1)
        else:
            u = seg / seg_len
            rel = pts - points[a]
            d = np.abs(u[0] * rel[:, 1] - u[1] * rel[:, 0])
        i = int(np.argmax(d))
        if d[i] > tol:
            keep[a + 1 + i] = True
            stack.append((a, a + 1 + i))
            stack.append((a + 1 + i, b))
    return points[keep]


def presimplify_ring(ring: np.ndarray, tol: float) -> np.ndarray:
    """Light DP pass on the closed ring BEFORE corner detection: on dense
    (≈1 px spacing) optimized contours the per-edge directions staircase,
    which makes the u/v-alignment corner test flag spurious corners that then
    block simplification (observed ~30 vertices/building vs ~5 GT). Longer
    pre-simplified edges give stable directions for the corner test."""
    if len(ring) < 5:
        return ring
    closed = np.concatenate([ring, ring[:1]])
    out = douglas_peucker(closed, tol)[:-1]
    return out if len(out) >= 3 else ring


def simplify_ring_with_corners(ring: np.ndarray, corners: np.ndarray, tol: float) -> np.ndarray:
    """Split a closed ring at corner vertices, DP-simplify each polyline,
    reassemble (reference split_polylines_corner + simplify)."""
    n = len(ring)
    idx = np.nonzero(corners)[0]
    if len(idx) == 0:
        closed = np.concatenate([ring, ring[:1]])
        out = douglas_peucker(closed, tol)
        return out[:-1]
    rolled = np.roll(ring, -idx[0], axis=0)
    corners_r = np.roll(corners, -idx[0])
    cuts = np.nonzero(corners_r)[0].tolist() + [n]
    pieces = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        seg = rolled[a : b + 1] if b < n else np.concatenate([rolled[a:], rolled[:1]])
        simp = douglas_peucker(seg, tol)
        pieces.append(simp[:-1])
    out = np.concatenate(pieces, axis=0)
    return out


def simplify_polyline_with_corners(pl: np.ndarray, corners: np.ndarray, tol: float) -> np.ndarray:
    """Open-polyline variant of simplify_ring_with_corners: split at corner
    vertices, DP-simplify each piece, keep both endpoints."""
    idx = sorted(set([0, len(pl) - 1] + np.nonzero(corners)[0].tolist()))
    pieces = []
    for a, b in zip(idx[:-1], idx[1:]):
        pieces.append(douglas_peucker(pl[a : b + 1], tol)[:-1])
    pieces.append(pl[-1:])
    return np.concatenate(pieces, axis=0)


def border_ring_with_nodes(H: int, W: int, endpoints: np.ndarray) -> np.ndarray:
    """The image-border ring (0,0)→(0,W-1)→(H-1,W-1)→(H-1,0) in (y, x),
    with `endpoints` (already lying on the border) inserted as vertices so
    the planar arrangement has nodes where open contours meet the border
    (the reference gets this for free from shapely unary_union node-splitting,
    polygonize_acm.py:288-299)."""
    corners = np.array([[0, 0], [0, W - 1], [H - 1, W - 1], [H - 1, 0]], np.float64)
    pts = [corners]
    if len(endpoints):
        pts.append(np.asarray(endpoints, np.float64))
    allpts = np.concatenate(pts, axis=0)

    def perimeter_t(p):
        y, x = p
        # clamp onto the border and parameterize clockwise from (0,0)
        if y <= x and y <= (W - 1) - x:  # top edge
            return np.clip(x, 0, W - 1)
        if (W - 1) - x <= y and (W - 1) - x <= (H - 1) - y:  # right edge
            return (W - 1) + np.clip(y, 0, H - 1)
        if (H - 1) - y <= x and (H - 1) - y <= (W - 1) - x:  # bottom edge
            return (W - 1) + (H - 1) + (W - 1) - np.clip(x, 0, W - 1)
        return 2 * (W - 1) + (H - 1) + (H - 1) - np.clip(y, 0, H - 1)  # left

    ts = np.array([perimeter_t(p) for p in allpts])
    order = np.argsort(ts)
    ring = allpts[order]
    # dedup (quantized like faces_from_polylines' node key)
    keep = [0]
    for i in range(1, len(ring)):
        if np.abs(ring[i] - ring[keep[-1]]).max() > 0.2:
            keep.append(i)
    ring = ring[keep]
    return np.concatenate([ring, ring[:1]], axis=0)  # closed polyline


def _on_border(p: np.ndarray, H: int, W: int, eps: float = 0.75) -> bool:
    y, x = p
    return y < eps or x < eps or y > H - 1 - eps or x > W - 1 - eps


def polygonize_with_border(polylines: list[np.ndarray], H: int, W: int) -> list[np.ndarray]:
    """Planar-arrangement faces of {simplified polylines + image-border ring}
    — the reference's unary_union + polygonize_full stage
    (polygonize_acm.py:288-306). Closed polylines repeat their first vertex.
    Open polylines whose endpoints don't reach the border are dangles: they
    cannot bound a face (shapely reports them separately) and are dropped."""
    from .ffl_asm import faces_from_polylines

    kept = []
    border_nodes = []
    for pl in polylines:
        if len(pl) < 2:
            continue
        is_closed = bool(np.abs(pl[0] - pl[-1]).max() < 1e-9)
        if is_closed:
            kept.append(pl)
            continue
        if _on_border(pl[0], H, W) and _on_border(pl[-1], H, W):
            pl = pl.copy()
            pl[0] = np.clip(pl[0], 0, [H - 1, W - 1])
            pl[-1] = np.clip(pl[-1], 0, [H - 1, W - 1])
            # snap exactly onto the nearest border line
            for idx in (0, -1):
                y, x = pl[idx]
                d = np.array([y, x, H - 1 - y, W - 1 - x])
                side = int(np.argmin(d))
                if side == 0:
                    pl[idx][0] = 0
                elif side == 1:
                    pl[idx][1] = 0
                elif side == 2:
                    pl[idx][0] = H - 1
                else:
                    pl[idx][1] = W - 1
            kept.append(pl)
            border_nodes += [pl[0], pl[-1]]
    kept.append(border_ring_with_nodes(H, W, np.asarray(border_nodes).reshape(-1, 2)))
    return faces_from_polylines(kept)


def ring_area(ring: np.ndarray) -> float:
    y, x = ring[:, 0], ring[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def mean_prob_in_ring(ring: np.ndarray, prob: np.ndarray) -> float:
    mask = np.zeros(prob.shape, np.uint8)
    xy = np.round(ring[:, ::-1]).astype(np.int32)
    cv2.fillPoly(mask, [xy], 1)
    if mask.sum() == 0:
        return 0.0
    return float(prob[mask > 0].mean())


class _LazyUVMap:
    """Behaves like one of the (H, W) complex u/v maps for the fancy-indexed
    reads corner detection performs (`u[ij[:,0], ij[:,1]]`, `.shape`), but
    extracts crossfield roots only at the requested pixels: only ring
    vertices are ever sampled."""

    __slots__ = ("c0c2", "which")

    def __init__(self, c0c2: np.ndarray, which: int):
        self.c0c2 = c0c2
        self.which = which

    @property
    def shape(self):
        return self.c0c2.shape[1:]

    def __getitem__(self, idx):
        i, j = idx
        s = self.c0c2[:, i, j]
        c0 = s[0] + 1j * s[1]
        c2 = s[2] + 1j * s[3]
        disc = np.sqrt(c2**2 - 4 * c0 + 0j)
        root2 = -(c2 + disc) / 2 if self.which == 0 else -(c2 - disc) / 2
        return np.sqrt(root2)


def c0c2_to_uv_lazy(c0c2: np.ndarray):
    """Point-wise-evaluated (u, v) pair, drop-in for detect_corners."""
    return _LazyUVMap(c0c2, 0), _LazyUVMap(c0c2, 1)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


class Polygonizer:
    """Method dispatcher (reference predict/ffl/polygonize.py:10-88). ACM
    and ASM run on the device of the maps handed to `__call__`, else on
    `device`."""

    def __init__(self, poly_cfg, seg_threshold: float = 0.5, device: str | torch.device = "cpu"):
        self.cfg = poly_cfg
        self.methods = list(poly_cfg.method) if not isinstance(poly_cfg.method, str) else [poly_cfg.method]
        unknown = set(self.methods) - {"simple", "acm", "asm"}
        if unknown:
            raise ValueError(f"polygonization methods {sorted(unknown)}")
        self.seg_threshold = seg_threshold
        self.device = torch.device(device)
        # the last call's stages: host ms of the contours and of the
        # post-processing, the ACM's ms (CUDA events on the card, the host
        # clock on the CPU) and steps, its rings, vertices, bucket and the
        # rings dropped past MAX_TOTAL_VERTS; under "asm" the ASM's
        # (`ffl_asm.asm_polygonize`)
        self.stats: dict = {}

    def __call__(self, seg: np.ndarray, crossfield: np.ndarray, maps: tuple | None = None) -> dict:
        """seg: (B, Cs, H, W); crossfield: (B, 4, H, W) numpy. `maps`: the
        same (seg, crossfield) as tensors already on the device ACM should
        run on (any float dtype that holds the values exactly).

        Returns {method: {tolerance: [per-sample list of (V, 2) (x, y)
        open rings]}}."""
        indicator = seg[:, 0]
        B = indicator.shape[0]
        init_level = float(self.cfg.common_params.init_data_level)
        t = time.perf_counter()
        contours = [extract_contours_flagged(indicator[b], init_level) for b in range(B)]
        self.stats = {"contours_ms": (time.perf_counter() - t) * 1e3, "post_ms": 0.0}

        out: dict = {}
        for method in self.methods:
            if method == "simple":
                t = time.perf_counter()
                out["simple"] = self._simple(contours, indicator)
                self.stats["post_ms"] += (time.perf_counter() - t) * 1e3
            elif method == "acm":
                out["acm"] = self._acm(contours, indicator, crossfield, maps)
            else:
                from .ffl_asm import asm_polygonize

                self.stats["asm"] = {}
                out["asm"] = asm_polygonize(self.cfg, seg, crossfield, self._device_maps(seg, crossfield, maps),
                                            self.stats["asm"])
        return out

    def _filter_and_convert(self, rings_b, indicator_b, min_area, seg_threshold):
        polys = []
        for ring in rings_b:
            if len(ring) < 3 or ring_area(ring) < min_area:
                continue
            if mean_prob_in_ring(ring, indicator_b) < seg_threshold:
                continue
            polys.append(ring[:, ::-1].copy())  # → (x, y)
        return polys

    def _simple(self, contours, indicator) -> dict:
        mc = self.cfg.simple_method
        out = {}
        for tol in list(mc.tolerance):
            per_sample = []
            for b, rings in enumerate(contours):
                simplified = []
                for ring, _closed in rings:
                    closed = np.concatenate([ring, ring[:1]])
                    s = douglas_peucker(closed, float(tol))[:-1]
                    simplified.append(s)
                per_sample.append(
                    self._filter_and_convert(
                        simplified, indicator[b], float(mc.min_area), float(mc.seg_threshold)
                    )
                )
            out[f"tol_{tol}"] = per_sample
        return out

    def _device_maps(self, seg: np.ndarray, crossfield: np.ndarray, maps) -> tuple:
        """(seg, crossfield) as float32 tensors on the device of `maps`, or
        uploaded from the host arrays to `device`."""
        if maps is None:
            maps = (torch.from_numpy(seg), torch.from_numpy(crossfield))
            maps = tuple(m.to(self.device) for m in maps)
        dev = maps[0].device
        return tuple(m.to(dev, torch.float32) for m in maps)

    def _optimize(self, packed, indicator, crossfield, maps) -> np.ndarray:
        """acm_optimize of the packed contours on the maps' device; the
        optimized positions as float32 numpy."""
        mc = self.cfg.acm_method
        pos, vmask, next_idx, point_batch, pinned = packed
        seg_d, cf_d = self._device_maps(indicator[:, None].copy(), crossfield, maps)
        dev = seg_d.device
        args = [torch.from_numpy(a).to(dev) for a in (pos, vmask, next_idx.astype(np.int64),
                                                       point_batch.astype(np.int64), pinned)]
        cuda = dev.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        out = acm_optimize(*args[:4], seg_d[:, 0], cf_d, args[4], **acm_kwargs(mc))
        if cuda:
            end.record()
        pos = out.cpu().numpy()
        self.stats["acm_ms"] = start.elapsed_time(end) if cuda else (time.perf_counter() - t) * 1e3
        self.stats["acm_steps"] = int(mc.steps)
        return pos

    def _acm(self, contours, indicator, crossfield, maps) -> dict:
        mc = self.cfg.acm_method
        B = indicator.shape[0]
        H, W = indicator.shape[1], indicator.shape[2]
        pos, vmask, next_idx, point_batch, pinned, rings_meta, dropped = pack_contours(contours)
        self.stats.update(rings=len(rings_meta), vertices=int(vmask.sum()), bucket=len(pos), dropped=dropped,
                          acm_ms=0.0, acm_steps=0)
        if dropped:
            logging.getLogger("Polygonizer").warning(
                f"ACM vertex capacity exceeded: dropped {dropped} rings "
                f"(cap {MAX_TOTAL_VERTS} total vertices)"
            )
        if rings_meta:
            pos = self._optimize((pos, vmask, next_idx, point_batch, pinned), indicator, crossfield, maps)

        t = time.perf_counter()
        out = {}
        uv_cache = {}
        for tol in list(mc.tolerance):
            per_sample: list[list[np.ndarray]] = [[] for _ in range(B)]
            for start, n, b, closed in rings_meta:
                ring = pos[start : start + n]
                if b not in uv_cache:
                    uv_cache[b] = c0c2_to_uv_lazy(crossfield[b])
                u, v = uv_cache[b]
                if closed:
                    if len(ring) < 3:
                        continue
                    ring = presimplify_ring(ring, float(tol) * 0.5)
                    corners = detect_corners(ring, u, v)
                    simp = simplify_ring_with_corners(ring, corners, float(tol))
                    per_sample[b].append(np.concatenate([simp, simp[:1]], axis=0))
                else:
                    if len(ring) < 2:
                        continue
                    pl = douglas_peucker(ring, float(tol) * 0.5)
                    corners = detect_corners(pl, u, v, closed=False)
                    per_sample[b].append(simplify_polyline_with_corners(pl, corners, float(tol)))
            # image-border union + planar-arrangement faces
            # (reference polygonize_acm.py:288-306)
            faced = []
            for b in range(B):
                faces = polygonize_with_border(per_sample[b], H, W)
                faced.append(
                    self._filter_and_convert(
                        faces, indicator[b], float(mc.min_area), float(mc.seg_threshold)
                    )
                )
            out[f"tol_{tol}"] = faced
        self.stats["post_ms"] += (time.perf_counter() - t) * 1e3
        return out
