"""Visual check of the Pix2Poly targets — twin of
scripts/test_wireframe_loader.py (reference scripts/test_wireframe_loader.py:10-40):
the val split's ground-truth token sequences and permutation matrices of
up to 8 tiles go through the tokenizer's decode and the polygon assembler,
and the polygons are drawn over their tiles into `wireframe_debug/tile_<i>.png`
in the working directory.

Usage: python -m pixelspointspolygons_torch.cli.wireframe_loader experiment=p2p_image dataset=synthetic [key.path=value ...]

Host code only (numpy and cv2): it runs on any machine.
"""

from __future__ import annotations

import numpy as np

from ..data import P3Dataset, ensure_synthetic_dataset
from ..models.pix2poly import Tokenizer
from ..predict.predictor_pix2poly import permutations_to_polygons
from ..utils.visualization import plot_polygons
from ._common import compose_from_argv, print_line


def main(argv: list[str] | None = None) -> list[list[np.ndarray]]:
    cfg, _ = compose_from_argv(argv)
    ensure_synthetic_dataset(cfg)
    tok = Tokenizer(cfg)
    ds = P3Dataset(cfg, "val", tokenizer=tok)
    drawn = []
    for i in range(min(len(ds), 8)):
        item = ds.get_item(i, np.random.RandomState(0))
        coords = tok.decode(item["y"])  # (V, 2) (y, x)
        nmax = tok.max_num_vertices
        vertices = np.zeros((1, nmax, 2), np.float32)
        nv = min(len(coords), nmax)
        vertices[0, :nv] = coords[:nv, ::-1]
        perm = item["y_perm"][None].astype(np.float64)
        polys = permutations_to_polygons(perm, vertices)[0]
        image = None
        if "images" in item:
            img = item["images"]
            image = (img - img.min()) / max(img.max() - img.min(), 1e-6)
        plot_polygons(polys, f"wireframe_debug/tile_{i}.png", image=image)
        print_line(f"tile {i}: {nv} vertices → {len(polys)} polygons")
        drawn.append(polys)
    return drawn


if __name__ == "__main__":
    main()
