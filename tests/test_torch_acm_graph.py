"""The ACM's steps on the card replayed from one captured CUDA graph step
against the loop of `acm_step`, bit for bit. This file imports neither JAX
nor the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_acm_graph.py

Without a card the test skips: a CUDA graph has no CPU mode.
"""

import numpy as np
import pytest
import torch

from pixelspointspolygons_torch.predict import ffl_polygonize as fp


def _maps(seed: int, B: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """A seg map of a few soft rectangles a tile, and a random crossfield."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    seg = np.zeros((B, size, size), np.float32)
    for b in range(B):
        for _ in range(3):
            y0, x0 = rng.randint(4, size // 2, 2)
            h, w = rng.randint(8, size // 2, 2)
            inside = np.minimum(np.minimum(yy - y0, y0 + h - yy), np.minimum(xx - x0, x0 + w - xx))
            seg[b] = np.maximum(seg[b], 1.0 / (1.0 + np.exp(-inside)))
    crossfield = rng.uniform(-1.0, 1.0, (B, 4, size, size)).astype(np.float32)
    return seg, crossfield


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 60])
def test_acm_graph_replays_equal_the_loop(steps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    dev = torch.device("cuda")
    seg, crossfield = _maps(0, 2, 64)
    packed = fp.pack_contours([fp.extract_contours_flagged(seg[b], 0.5) for b in range(len(seg))])
    assert packed[1].sum() > 0
    args = [torch.from_numpy(a).to(dev) for a in (packed[0], packed[1], packed[2].astype(np.int64),
                                                 packed[3].astype(np.int64))]
    maps = torch.from_numpy(seg).to(dev), torch.from_numpy(crossfield).to(dev)
    pinned = torch.from_numpy(packed[4]).to(dev)
    loop = fp.acm_optimize(*args, *maps, pinned, steps=steps, graph=False)
    replayed = fp.acm_optimize(*args, *maps, pinned, steps=steps)
    again = fp.acm_optimize(*args, *maps, pinned, steps=steps)
    assert not torch.equal(loop, args[0])  # the vertices moved
    assert torch.equal(replayed, loop) and torch.equal(again, loop)
