"""The cells at a size a CPU test run holds: the same configurations with a
32 px tile, a 48-wide ViT (its 12 blocks and 6 heads are fixed in the
port), a one-layer 32-wide decoder, 8 vertex slots, 16 to 64 tiles and
clouds of at most 600 points."""

from __future__ import annotations

import copy

from benchmark.harness.spec import BENCH_DIR, cell_spec, load_benchmark

PORT = ["experiment.encoder.in_size=32", "experiment.encoder.patch_feature_dim=48",
        "experiment.model.decoder.in_feature_dim=32", "experiment.model.decoder.num_layers=1",
        "experiment.model.decoder.num_heads=2", "experiment.model.tokenizer.max_num_vertices=8",
        "experiment.encoder.max_num_points=2000"]
SIZES = {"height": 32, "width": 32, "num_patches": 16, "vit_dim": 48, "decoder_dim": 32, "decoder_layers": 1,
         "decoder_heads": 2, "num_bins": 32, "vocab_size": 35, "max_vertices": 8, "max_len": 18}


def spec(cell: str, tiles: int = 32) -> dict:
    """The cell's spec from BENCHMARK.json, cut to the tiny size."""
    s = copy.deepcopy(cell_spec(load_benchmark(), cell))
    s["config"]["overrides"] = s["config"]["overrides"] + PORT
    s["config"]["sizes"].update(SIZES)
    if "max_num_points" in s["config"]["sizes"]:
        s["config"]["sizes"].update(max_num_points=2000, pfn_channels=[64, SIZES["vit_dim"]])
    tr = s["traffic"]
    tr["max_points"] = 600
    tr["splits"] = {k: v and {"train": 2 * tiles, "test": tiles}.get(k, 16) for k, v in tr["splits"].items()}
    tr["check_tiles"] = 8
    s["bench_dir"] = BENCH_DIR
    return s

