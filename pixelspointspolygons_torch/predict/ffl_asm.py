"""FFL Active Skeleton Model (ASM) polygonization, and the planar faces of
polylines — port of pixelspointspolygons_tpu/predict/ffl_asm.py (:42-552;
reference predict/ffl/polygonize_asm.py):

- on the host: the edge-probability map of the binarized seg (its Scharr
  gradient norm, plus the edge channel when there is one), a Zhang-Suen
  skeleton (skimage.skeletonize's stand-in), traced into a graph of paths
  between junction and tip nodes (skan's stand-in), packed into one flat
  node array for the batch with the path edges as index pairs, padded to
  the {4096, 16384, 65536} buckets of the ACM (`ffl_polygonize._bucket`);
- on the device of the maps: `asm_optimize`, `steps` RMSprop updates of
  the shared node positions by torch autograd of `_asm_loss` (the level
  term, the squared edge lengths, the alignment of each edge with the
  crossfield at its rounded midpoint), each term weighted by a coefficient
  interpolated over the step thresholds, the rate decaying by gamma per
  step; tips (degree-1 nodes) and padding stay pinned. JAX runs the same
  updates as `jax.grad` under `lax.scan`; the explicit RMSprop update of
  JAX :366-368 is kept (not `torch.optim.RMSprop`), with the coefficients
  and gamma^it computed in float32 as JAX traces them;
- on the host: corner-aware simplification of each path, the image-border
  face union (`faces_from_polylines`, a shapely polygonize_full stand-in),
  the area and probability filters (the ACM's post-processing).
"""

from __future__ import annotations

import logging
import math
import time

import cv2
import numpy as np
import torch

from ..ops.bilinear import bilinear_interpolate
from ..ops.crossfield import framefield_align_error
from .ffl_polygonize import (
    _bucket,
    c0c2_to_uv_lazy,
    detect_corners,
    douglas_peucker,
    extract_contours_flagged,
    mean_prob_in_ring,
    polygonize_with_border,
    ring_area,
    simplify_ring_with_corners,
)

MAX_NODES = 65536  # cap on skeleton nodes per batch (paths past it are dropped and logged)


# --------------------------------------------------------------------------
# host: skeletonization + graph extraction
# --------------------------------------------------------------------------


def zhang_suen_skeletonize(mask: np.ndarray) -> np.ndarray:
    """Binary thinning to a 1-px skeleton (skimage.morphology.skeletonize
    equivalent)."""
    img = (mask > 0).astype(np.uint8)
    changed = True
    while changed:
        changed = False
        for step in (0, 1):
            p = np.pad(img, 1)
            P2 = p[:-2, 1:-1]
            P3 = p[:-2, 2:]
            P4 = p[1:-1, 2:]
            P5 = p[2:, 2:]
            P6 = p[2:, 1:-1]
            P7 = p[2:, :-2]
            P8 = p[1:-1, :-2]
            P9 = p[:-2, :-2]
            ring = [P2, P3, P4, P5, P6, P7, P8, P9]
            B = sum(ring)
            A = sum(
                ((ring[i] == 0) & (ring[(i + 1) % 8] == 1)).astype(np.uint8)
                for i in range(8)
            )
            if step == 0:
                c1 = (P2 * P4 * P6) == 0
                c2 = (P4 * P6 * P8) == 0
            else:
                c1 = (P2 * P4 * P8) == 0
                c2 = (P2 * P6 * P8) == 0
            cond = (img == 1) & (2 <= B) & (B <= 6) & (A == 1) & c1 & c2
            if cond.any():
                img[cond] = 0
                changed = True
    return img


_NB8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def skeleton_to_paths(skel: np.ndarray):
    """Trace the skeleton into (nodes (N,2) float (y,x), paths: list of node-
    index lists). Like skan's Skeleton graph: adjacent junction pixels
    (degree ≥ 3) are CLUSTERED into a single junction node (centroid), paths
    run junction/tip → junction/tip through degree-2 chains, and pure cycles
    come back closed (first == last index)."""
    ys, xs = np.nonzero(skel)
    coords = list(zip(ys.tolist(), xs.tolist()))
    index = {c: i for i, c in enumerate(coords)}
    nbrs: list[list[int]] = [[] for _ in coords]
    for i, (y, x) in enumerate(coords):
        for dy, dx in _NB8:
            j = index.get((y + dy, x + dx))
            if j is None:
                continue
            # triangle reduction: drop a diagonal adjacency when a shared
            # 4-neighbor bridges the two pixels — thinning leaves thick
            # corners whose spurious diagonals otherwise read as junctions
            if dy and dx and ((y, x + dx) in index or (y + dy, x) in index):
                continue
            nbrs[i].append(j)
    deg = np.array([len(n) for n in nbrs]) if coords else np.zeros((0,), int)

    is_junc = deg >= 3
    # cluster adjacent junction pixels
    cluster_of = {}
    clusters: list[list[int]] = []
    for i in np.nonzero(is_junc)[0]:
        if i in cluster_of:
            continue
        stack = [int(i)]
        cid = len(clusters)
        members = []
        while stack:
            p = stack.pop()
            if p in cluster_of:
                continue
            cluster_of[p] = cid
            members.append(p)
            for n in nbrs[p]:
                if is_junc[n] and n not in cluster_of:
                    stack.append(n)
        clusters.append(members)

    nodes: list = []  # (y, x) positions
    node_of_pixel: dict[int, int] = {}
    for members in clusters:
        pts = np.array([coords[m] for m in members], np.float64)
        nid = len(nodes)
        nodes.append(pts.mean(axis=0))
        for m in members:
            node_of_pixel[m] = nid
    for i, c in enumerate(coords):
        if i not in node_of_pixel:
            node_of_pixel[i] = len(nodes)
            nodes.append(np.asarray(c, np.float64))

    terminal = set(np.nonzero(is_junc | (deg == 1))[0].tolist())
    visited: set[tuple[int, int]] = set()
    paths: list[list[int]] = []

    def walk(start_px: int, nxt_px: int) -> list[int] | None:
        path_px = [start_px, nxt_px]
        prev, cur = start_px, nxt_px
        while cur not in terminal:
            options = [n for n in nbrs[cur] if n != prev and (cur, n) not in visited]
            if not options:
                break
            nxt2 = options[0]
            visited.add((cur, nxt2))
            visited.add((nxt2, cur))
            path_px.append(nxt2)
            prev, cur = cur, nxt2
            if cur == start_px:
                break
        # map pixels to nodes, collapsing consecutive same-cluster nodes
        path = []
        for p in path_px:
            nid = node_of_pixel[p]
            if not path or path[-1] != nid:
                path.append(nid)
        return path if len(path) >= 2 else None

    for e in sorted(terminal):
        for n in nbrs[e]:
            if (e, n) in visited:
                continue
            # skip intra-cluster hops
            if is_junc[e] and is_junc[n] and cluster_of.get(e) == cluster_of.get(n):
                visited.add((e, n))
                visited.add((n, e))
                continue
            visited.add((e, n))
            visited.add((n, e))
            p = walk(e, n)
            if p:
                paths.append(p)
    # remaining pure cycles
    for i in range(len(coords)):
        if deg[i] != 2:
            continue
        for n in nbrs[i]:
            if (i, n) not in visited:
                visited.add((i, n))
                visited.add((n, i))
                p = walk(i, n)
                if p:
                    paths.append(p)
    nodes_arr = np.stack(nodes) if nodes else np.zeros((0, 2))
    return nodes_arr, paths


def edge_probability_map(
    seg: np.ndarray, has_edge_channel: bool, data_level: float = 0.5
) -> np.ndarray:
    """(Cs, H, W) seg → edge prob map.

    Reference semantics (compute_skeletons, polygonize_asm.py:659-667):
    BINARIZE the interior channel at data_level FIRST, then take the Scharr
    gradient norm of the binary mask (scaled so a clean step edge reaches 1)
    — taking gradients of the soft prob map instead gives a weak (~0.6 max),
    fragmented edge band whose skeleton breaks into tiny paths."""
    interior = (seg[0] > data_level).astype(np.float32)
    gx = cv2.Scharr(interior, cv2.CV_32F, 1, 0) / 16.0
    gy = cv2.Scharr(interior, cv2.CV_32F, 0, 1) / 16.0
    em = 2.0 * np.sqrt(gx**2 + gy**2)  # kornia-normalized-grad x2 (:662)
    if has_edge_channel and seg.shape[0] > 1:
        em = em + seg[1]
    return np.clip(em, 0.0, 1.0)


# --------------------------------------------------------------------------
# packing (flat shared nodes + padded path indices)
# --------------------------------------------------------------------------


def pack_skeletons(per_sample: list[tuple[np.ndarray, list[list[int]]]]):
    """Flat bucketized packing, as the ACM's: shared nodes in one (N, 2)
    array, path edges as explicit flat (edge_a, edge_b) index pairs
    (TensorSkeleton's CSR paths, tensorskeleton.py:44-192, re-expressed as
    gathers). Returns (pos, node_batch, node_valid, pinned, edge_a, edge_b,
    edge_valid, paths_meta [(global node-idx list, batch)], dropped). N and
    E are padded to the ACM's buckets (`_bucket`); a sample whose nodes
    would pass MAX_NODES is dropped with its paths."""
    chunks, metas, dropped = [], [], 0
    n_nodes = 0
    pinned_chunks = []
    for b, (nodes, paths) in enumerate(per_sample):
        if n_nodes + len(nodes) > MAX_NODES:
            dropped += len(paths)
            continue
        base = n_nodes
        counts = np.zeros(len(nodes), int)
        for p in paths:
            counts[p[0]] += 1
            counts[p[-1]] += 1
            for q in p[1:-1]:
                counts[q] += 2
            metas.append(([i + base for i in p], b))
        chunks.append((np.asarray(nodes, np.float32), b))
        pinned_chunks.append(counts == 1)  # degree-1 tips pinned
        n_nodes += len(nodes)

    N = _bucket(max(n_nodes, 1))
    pos = np.zeros((N, 2), np.float32)
    node_batch = np.zeros((N,), np.int32)
    node_valid = np.zeros((N,), bool)
    pinned = np.zeros((N,), bool)
    off = 0
    for (nodes, b), tips in zip(chunks, pinned_chunks):
        pos[off : off + len(nodes)] = nodes
        node_batch[off : off + len(nodes)] = b
        node_valid[off : off + len(nodes)] = True
        pinned[off : off + len(nodes)] = tips
        off += len(nodes)

    ea, eb = [], []
    for idx, _b in metas:
        ea.extend(idx[:-1])
        eb.extend(idx[1:])
    E = _bucket(max(len(ea), 1))
    edge_a = np.zeros((E,), np.int32)
    edge_b = np.zeros((E,), np.int32)
    edge_valid = np.zeros((E,), bool)
    edge_a[: len(ea)] = ea
    edge_b[: len(eb)] = eb
    edge_valid[: len(ea)] = True
    return pos, node_batch, node_valid, pinned, edge_a, edge_b, edge_valid, metas, dropped


# --------------------------------------------------------------------------
# device: optimization
# --------------------------------------------------------------------------


def _asm_loss(pos, edge_a, edge_b, edge_valid, node_batch, node_valid, indicator, c0c2, coefs):
    """The ASM's loss (JAX :286-323): pos (N, 2) (y, x); indicator (B, H, W);
    c0c2 (B, 4, H, W); `coefs` the step's data, length and crossfield
    coefficients (0-d tensors) and data_level (a float)."""
    H, W = indicator.shape[1], indicator.shape[2]
    pa = pos[edge_a]  # (E, 2)
    pb = pos[edge_b]
    tangents = pb - pa
    norms = torch.sqrt(torch.sum(tangents * tangents, dim=-1) + 1e-12)  # safe at 0 (padded edges)
    emask = (edge_valid & (norms > 0.1)).to(pos.dtype)

    mid = (pa + pb) / 2
    mi = torch.round(mid[..., 0]).long().clamp(0, H - 1)
    mj = torch.round(mid[..., 1]).long().clamp(0, W - 1)
    bidx = node_batch[edge_a]
    cf = c0c2[bidx, :, mi, mj]
    c0 = torch.complex(cf[..., 0], cf[..., 1])
    c2 = torch.complex(cf[..., 2], cf[..., 3])
    zn = tangents / (norms[..., None] + 1e-6)
    z = torch.complex(zn[..., 0], zn[..., 1])
    align_loss = (framefield_align_error(c0, c2, z) * emask).sum()

    vals = bilinear_interpolate(indicator[:, None], pos, node_batch)[:, 0]
    level_loss = (((vals - coefs["data_level"]) ** 2) * node_valid).sum()

    length_loss = ((norms * emask) ** 2).sum()

    return coefs["data"] * level_loss + coefs["length"] * length_loss + coefs["crossfield"] * align_loss


def step_schedule(steps: int, step_thresholds, data, length, crossfield, lr: float, gamma: float) -> np.ndarray:
    """(steps, 4) float32: per step the data, length and crossfield
    coefficients (`jnp.interp` of the step over the thresholds, constant
    outside them) and the rate lr·gamma^step, as JAX's scan computes them
    (:353-367): in float32, the interpolation's multiply-add fused (XLA
    contracts it; the float32 product is exact in float64) and gamma^step
    correctly rounded."""
    f32, f64 = np.float32, np.float64
    xp = np.asarray(step_thresholds, f32)
    x = np.arange(steps, dtype=f32)
    i = np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1)
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(f32).eps)
    cols = []
    for sched in (data, length, crossfield):
        fp = np.asarray(sched, f32)
        q = delta / np.where(dx0, f32(1), dx)
        f = (q.astype(f64) * (fp[i] - fp[i - 1]).astype(f64) + fp[i - 1].astype(f64)).astype(f32)
        f = np.where(dx0, fp[i - 1], f)
        f = np.where(x < xp[0], fp[0], f)
        cols.append(np.where(x > xp[-1], fp[-1], f).astype(f32))
    cols.append(f32(lr) * (f64(f32(gamma)) ** x.astype(f64)).astype(f32))
    return np.stack(cols, axis=1)


def asm_optimize(
    pos,
    node_batch,
    node_valid,
    pinned,
    edge_a,
    edge_b,
    edge_valid,
    indicator,
    c0c2,
    schedule,
    *,
    data_level: float = 0.5,
) -> torch.Tensor:
    """RMSprop (torch's defaults α=0.99, eps=1e-8, written out as JAX
    :366-368 does) with the exponentially decaying rate, one update per row
    of `schedule` (`step_schedule`, on the device). All tensors on one
    device; returns the optimized (N, 2) positions there."""
    free = (~pinned).to(torch.float32)[:, None]
    dl = float(np.float32(data_level))  # a float32 value, as JAX traces it
    p = pos.detach().clone().requires_grad_(True)
    v = torch.zeros_like(pos)
    for it in range(schedule.shape[0]):
        asm_step(p, v, schedule[it], free, edge_a, edge_b, edge_valid, node_batch, node_valid, indicator, c0c2, dl)
    return p.detach()


def asm_step(p, v, row, free, edge_a, edge_b, edge_valid, node_batch, node_valid, indicator, c0c2, data_level) -> None:
    """One RMSprop update of the leaf tensor `p` and its running square `v`
    in place, with the step's row (data, length, crossfield, rate) of the
    schedule, with no read back to the host:
    v = 0.99 v + 0.01 g², p -= rate·g / (√v + 1e-8) · free."""
    coefs = {"data": row[0], "length": row[1], "crossfield": row[2], "data_level": data_level}
    loss = _asm_loss(p, edge_a, edge_b, edge_valid, node_batch, node_valid, indicator, c0c2, coefs)
    (g,) = torch.autograd.grad(loss, p)
    with torch.no_grad():
        v.copy_(0.99 * v + 0.01 * g * g)
        p.sub_(row[3] * g / (torch.sqrt(v) + 1e-8) * free)


def asm_kwargs(mc, steps: int | None = None) -> tuple[np.ndarray, dict]:
    """(step_schedule, asm_optimize's keyword arguments) from the
    `asm_method` config; `steps` defaults to the last step threshold."""
    coefs = mc.loss_params.coefs
    thresholds = [float(t) for t in coefs.step_thresholds]
    schedule = step_schedule(
        int(thresholds[-1]) if steps is None else steps,
        thresholds,
        [float(x) for x in coefs.data],
        [float(x) for x in coefs.length],
        [float(x) for x in coefs.crossfield],
        float(mc.lr),
        float(mc.gamma),
    )
    return schedule, {"data_level": float(mc.data_level)}


# --------------------------------------------------------------------------
# host: polygon reconstruction (planar faces from polylines)
# --------------------------------------------------------------------------


def faces_from_polylines(polylines: list[np.ndarray]) -> list[np.ndarray]:
    """shapely polygonize_full equivalent: split the polyline arrangement
    into faces via half-edge traversal (turn most-CCW at each node)."""
    key = lambda pt: (round(pt[0] * 4) / 4, round(pt[1] * 4) / 4)
    node_ids: dict = {}
    nodes: list[np.ndarray] = []
    edges: set[tuple[int, int]] = set()
    for pl in polylines:
        prev = None
        for pt in pl:
            k = key(pt)
            if k not in node_ids:
                node_ids[k] = len(nodes)
                nodes.append(np.asarray(pt, np.float64))
            cur = node_ids[k]
            if prev is not None and prev != cur:
                edges.add((prev, cur))
                edges.add((cur, prev))
            prev = cur
    out_edges: dict[int, list[int]] = {}
    for a, b in edges:
        out_edges.setdefault(a, []).append(b)
    # sort outgoing edges by angle
    for a in out_edges:
        out_edges[a].sort(
            key=lambda b: math.atan2(nodes[b][0] - nodes[a][0], nodes[b][1] - nodes[a][1])
        )
    visited: set[tuple[int, int]] = set()
    faces = []
    for a0, b0 in edges:
        if (a0, b0) in visited:
            continue
        face = []
        a, b = a0, b0
        while True:
            visited.add((a, b))
            face.append(a)
            # find reverse edge (b, a) in b's sorted out list, take next CW
            lst = out_edges[b]
            i = lst.index(a)
            nxt = lst[(i - 1) % len(lst)]
            a, b = b, nxt
            if (a, b) == (a0, b0) or len(face) > 10 * len(nodes) + 10:
                break
        if len(face) >= 3:
            ring = np.stack([nodes[i] for i in face])
            # keep only CCW-in-ij faces (interior faces); signed shoelace
            y, x = ring[:, 0], ring[:, 1]
            signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
            if signed > 1e-9:
                faces.append(ring)
    return faces


# --------------------------------------------------------------------------
# the method
# --------------------------------------------------------------------------


def skeleton_graphs(mc, seg: np.ndarray) -> list:
    """Per sample of seg (B, Cs, H, W): (nodes (N, 2) (y, x), paths), the
    skeleton graph of the binarized seg's edge map (or, with
    `init_method` other than 'skeleton', the marching-squares rings as
    closed paths; JAX :449-483)."""
    per_sample = []
    for b in range(seg.shape[0]):
        if str(mc.get("init_method", "skeleton")) == "skeleton":
            em = edge_probability_map(seg[b], has_edge_channel=seg.shape[1] > 1, data_level=float(mc.data_level))
            mask = (em > float(mc.data_level)).astype(np.uint8)
            # pad (edge mode) + binary closing before thinning so that
            # border pixels survive and 1-px gaps close (get_skeleton :521-525)
            pad = 2
            mask = np.pad(mask, pad, mode="edge")
            kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 3))
            mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
            skel = zhang_suen_skeletonize(mask.astype(bool))[pad:-pad, pad:-pad]
            nodes, paths = skeleton_to_paths(skel)
        else:  # the marching-squares fallback (:581-640)
            rings = [ring for ring, _ in extract_contours_flagged(seg[b, 0], float(mc.data_level))]
            nodes_list, paths = [], []
            off = 0
            for r in rings:
                nodes_list.append(r)
                paths.append(list(range(off, off + len(r))) + [off])
                off += len(r)
            nodes = np.concatenate(nodes_list, axis=0) if nodes_list else np.zeros((0, 2))
        per_sample.append((nodes, paths))
    return per_sample


def asm_polygonize(poly_cfg, seg: np.ndarray, crossfield: np.ndarray, maps: tuple | None = None,
                   stats: dict | None = None) -> dict:
    """seg (B, Cs, H, W), crossfield (B, 4, H, W) numpy → {tol: per-sample
    polygon lists ((V, 2) (x, y) open rings)} (JAX :441-552). The
    optimization runs on the device of `maps`, the same (seg, crossfield)
    as tensors (the CPU if None). `stats`, if given, receives the host ms
    of the skeletons and of the post-processing, the optimization's ms
    (CUDA events on the card, the host clock on the CPU) and steps, and the
    nodes, paths, bucket and paths dropped."""
    stats = {} if stats is None else stats
    mc = poly_cfg.asm_method
    B = seg.shape[0]
    t = time.perf_counter()
    per_sample = skeleton_graphs(mc, seg)
    pos, node_batch, node_valid, pinned, edge_a, edge_b, edge_valid, paths_meta, dropped = pack_skeletons(per_sample)
    stats.update(skeleton_ms=(time.perf_counter() - t) * 1e3, nodes=int(node_valid.sum()), paths=len(paths_meta),
                 bucket=len(pos), dropped=dropped, optimize_ms=0.0, steps=0)
    if dropped:
        logging.getLogger("Polygonizer").warning(f"ASM dropped {dropped} paths (capacity)")

    if paths_meta:
        if maps is None:
            maps = (torch.from_numpy(seg), torch.from_numpy(crossfield))
        dev = maps[0].device
        indicator, c0c2 = maps[0][:, 0].float(), maps[1].float()
        schedule, kw = asm_kwargs(mc)
        args = [torch.from_numpy(a).to(dev) for a in (pos, node_batch.astype(np.int64), node_valid, pinned,
                                                       edge_a.astype(np.int64), edge_b.astype(np.int64), edge_valid)]
        cuda = dev.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        out = asm_optimize(*args, indicator, c0c2, torch.from_numpy(schedule).to(dev), **kw)
        if cuda:
            end.record()
        pos = out.cpu().numpy()
        stats["optimize_ms"] = start.elapsed_time(end) if cuda else (time.perf_counter() - t) * 1e3
        stats["steps"] = len(schedule)

    t = time.perf_counter()
    out = {}
    uv_cache: dict = {}
    for tol in list(mc.tolerance):
        per_out: list[list[np.ndarray]] = [[] for _ in range(B)]
        for b in range(B):
            # this sample's simplified polylines
            polylines = []
            for first, pb in paths_meta:
                if len(first) < 2 or pb != b:
                    continue
                pts = pos[first]
                if b not in uv_cache:
                    uv_cache[b] = c0c2_to_uv_lazy(crossfield[b])
                u, v = uv_cache[b]
                closed = len(first) > 2 and first[0] == first[-1]
                if closed:
                    ring = pts[:-1]
                    corners = detect_corners(ring, u, v)
                    simp = simplify_ring_with_corners(ring, corners, float(tol))
                    simp = np.concatenate([simp, simp[:1]], axis=0)
                else:
                    simp = douglas_peucker(pts, float(tol))
                polylines.append(simp)
            # the border-ring union so that border-crossing buildings close
            # (reference shapely_postprocess, polygonize_acm.py:288-306, as
            # the ACM's)
            faces = polygonize_with_border(polylines, seg.shape[2], seg.shape[3])
            kept = []
            for ring in faces:
                if ring_area(ring) < float(mc.min_area):
                    continue
                if mean_prob_in_ring(ring, seg[b, 0]) < float(mc.seg_threshold):
                    continue
                kept.append(ring[:, ::-1].copy())  # → (x, y)
            per_out[b] = kept
        out[f"tol_{tol}"] = per_out
    stats["post_ms"] = (time.perf_counter() - t) * 1e3
    return out
