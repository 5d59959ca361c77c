"""Planar faces from polylines — the port's copy of `faces_from_polylines`
from pixelspointspolygons_tpu/predict/ffl_asm.py (:382-433), which the ACM
polygonizer's image-border union needs (`ffl_polygonize.py::polygonize_with_border`).
The ASM method itself comes with ROADMAP 'Port queue' item 'FFL'."""

from __future__ import annotations

import math

import numpy as np


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
