"""Pix2Poly's host assembly, the reference's copy: the decoded tokens to
vertices, the Hungarian assignment of the vertex-pair scores, polygons by
following each vertex's successor and merging chains (Pix2Poly's
`predictor_pix2poly.py`, the published algorithm)."""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def decode_vertices(tokens: np.ndarray, s: dict) -> np.ndarray:
    """A tile's generated tokens (BOS not included) -> (V, 2) (x, y) pixel
    vertices: PAD dropped, cut at the first EOS, (y, x) pairs over
    num_bins - 1 levels."""
    bins = s["num_bins"]
    eos, pad = bins + 1, bins + 2
    t = np.asarray(tokens)
    t = t[t != pad]
    e = np.nonzero(t == eos)[0]
    if len(e):
        t = t[: e[0]]
    n = (len(t) // 2) * 2
    yx = t[:n].reshape(-1, 2).astype(np.float32) / (bins - 1)
    yx[:, 0] *= s["height"]
    yx[:, 1] *= s["width"]
    return yx[:, ::-1][: s["max_vertices"]]


def _merge(chains: list[list[int]]) -> list[list[int]]:
    merged = True
    while merged:
        merged = False
        a = 0
        while a < len(chains):
            head = chains[a][-1]
            b = a + 1
            while b < len(chains):
                if chains[b][0] == head:
                    chains[a] = chains[a] + chains[b][1:]
                    del chains[b]
                    merged = True
                    head = chains[a][-1]
                    b = a + 1
                else:
                    b += 1
            a += 1
    return chains


def polygons(tokens: np.ndarray, scores: np.ndarray, s: dict) -> list[np.ndarray]:
    """One tile's polygons from its tokens and (V, V) raw scores: the rows
    and columns past the decoded vertices pinned to themselves, the
    assignment that maximises the scores, each real vertex linked to its
    assigned successor, chains merged head to tail, closed rings of three
    vertices or more."""
    nmax = s["max_vertices"]
    verts = decode_vertices(tokens, s)
    n = len(verts)
    sc = np.array(scores, np.float32)
    sc[n:, :] = -1e9
    sc[:, n:] = -1e9
    sc[range(n, nmax), range(n, nmax)] = 1e9
    r, c = linear_sum_assignment(-sc)
    perm = np.zeros((nmax, nmax), np.float32)
    perm[r, c] = 1
    perm[n:, :] = 0
    perm[:, n:] = 0
    perm[range(n, nmax), range(n, nmax)] = 1
    real = np.nonzero(~(np.diagonal(perm) > 0.5))[0]
    out = []
    if len(real):
        succ = np.argmax(perm[np.ix_(real, real)], axis=1)
        for chain in _merge([[i, int(succ[i])] for i in range(len(real))]):
            if len(chain) >= 2 and chain[0] == chain[-1]:
                chain = chain[:-1]
            if len(chain) >= 3:
                out.append(verts[real[chain]])
    return out
