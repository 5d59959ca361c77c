"""Fill the FFL ground-truth cache ahead of training — twin of
data_preprocess/ffl/preprocess_ffl.py (reference
data_preprocess/ffl/preprocess_ffl.py).

For each split (train, val, test) a process pool computes every tile's
rasterized interior, edge and vertex maps, distances, sizes and angle field
through `P3Dataset._ffl_gt`, which writes them to the port's cache
(`<dataset dir>/ffl_cache_torch/<split>/<id>.npz`, the files the loader
otherwise writes at first use); then it writes the split's stats file at
`experiment.dataset.ffl_stats[split]`: `class_freq` = [1 - f, f] with f the
mean interior fraction of the split's tiles.

The pool's processes are spawned, not forked (the parent may hold threads:
torch's, or a test runner's) and take the tiles in order, so the stats do
not depend on which process finished first.

Usage: python -m pixelspointspolygons_torch.cli.preprocess_ffl [experiment=ffl_image] [key.path=value ...]

Host code only (numpy and cv2): it runs on any machine.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys

import numpy as np

from ..config.engine import compose
from ..data.dataset import P3Dataset
from ..data.synthetic import ensure_synthetic_dataset
from ._common import print_line


def _process_one(args) -> float:
    overrides, split, idx = args
    ds = P3Dataset(compose(overrides), split)
    gt = ds._ffl_gt(ds.coco.imgs[ds.tile_ids[idx]])  # computes and caches
    return float((gt["gt_polygons_image"][..., 0] > 0).mean())


def main(argv: list[str] | None = None) -> dict[str, float]:
    overrides = list(sys.argv[1:] if argv is None else argv) or ["experiment=ffl_image"]
    if not any(o.startswith("model=") for o in overrides):
        overrides = overrides + ["model=ffl"]
    cfg = compose(overrides)
    ensure_synthetic_dataset(cfg)
    freqs = {}
    for split in ("train", "val", "test"):
        n = len(P3Dataset(cfg, split))
        args = [(overrides, split, i) for i in range(n)]
        with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1, max(n, 1))) as pool:
            fracs = list(pool.imap(_process_one, args, chunksize=4))
        freq = float(np.mean(fracs)) if fracs else 0.1
        stats_path = cfg.experiment.dataset.ffl_stats[split]
        os.makedirs(os.path.dirname(stats_path), exist_ok=True)
        np.savez(stats_path, class_freq=np.array([1.0 - freq, freq], np.float32))
        print_line(f"{split}: cached FFL GT for {n} tiles, class_freq={freq:.4f}")
        freqs[split] = freq
    return freqs


if __name__ == "__main__":
    main()
