"""Pack device-cache splits on the host ahead of training (the port's twin of
scripts/prebuild_caches.py): the synthetic dataset is written if it is
missing, and each split's pack is saved under the port's name in the
dataset directory (`data/device_cache.py`), where a trainer with
`training.device_cache` later loads it instead of packing it. Host numpy
only: no device is touched.

Usage: python -m pixelspointspolygons_torch.cli.prebuild_caches <experiment> <split> [<split> ...] \
    [key.path=value ...]
"""

from __future__ import annotations

import sys

from ..config.engine import compose

SPLITS = ("train", "val", "test")


def main(argv: list[str] | None = None) -> dict:
    """Pack each named split; returns {split: rows}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    experiment, rest = argv[0], argv[1:]
    splits = [a for a in rest if a in SPLITS]
    cfg = compose([f"experiment={experiment}", "dataset=synthetic", "run_type=release"]
                  + [a for a in rest if a not in SPLITS])

    from ..data import device_cache
    from ..data.synthetic import ensure_synthetic_dataset

    ensure_synthetic_dataset(cfg)
    model = cfg.experiment.model.name
    rows = {}
    for split in splits:
        if model == "pix2poly":
            from ..models.pix2poly import Tokenizer

            arrays = device_cache.build_p2p_cache_arrays(cfg, split, Tokenizer(cfg))
        elif model == "hisup":
            arrays = device_cache.build_hisup_cache_arrays(cfg, split)
        else:
            arrays, _ = device_cache.build_ffl_cache_arrays(cfg, split)
        rows[split] = int(arrays["image_id"].shape[0])
        print(f"PREBUILT {experiment} {split}: {rows[split]} rows", flush=True)
    return rows


if __name__ == "__main__":
    main()
