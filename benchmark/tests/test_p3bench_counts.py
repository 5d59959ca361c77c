"""The FLOP and byte counts against counts made by hand."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.counts import bytes as nbytes
from benchmark.counts import flops
from benchmark.harness.spec import BENCH_DIR

# a small model whose products are counted by hand below
S = {"encoder": "vit", "num_patches": 4, "patch_size": 2, "vit_dim": 6, "vit_depth": 1, "vit_mlp_ratio": 2,
     "decoder_dim": 4, "decoder_layers": 1, "decoder_ffn": 8, "vocab_size": 5, "max_vertices": 2, "max_len": 6,
     "sinkhorn_iterations": 3}


def test_vit_by_hand():
    # 5 tokens of width 6: qkv 2·5·6·18, logits 2·5·6·5, values 2·5·5·6,
    # out 2·5·6·6, MLP 2·5·6·12 + 2·5·12·6
    assert flops.vit(S, 4) == 1080 + 300 + 300 + 360 + 720 + 720
    assert flops.patch_embed(S) == 2 * 4 * 12 * 6


def test_decoder_by_hand():
    # position 2: projections 2·4·16, self-attention over 3 slots 2·(2·4·3),
    # cross q/o 2·4·8, over 4 tokens 2·(2·4·4), FFN 2·4·8 + 2·8·4, head 2·4·5
    assert flops.decoder_step(S, 2) == 128 + 48 + 64 + 64 + 64 + 64 + 40
    assert flops.memory_kv(S) == 2 * 4 * 4 * 8
    # teacher-forced over 3 positions: 6 causal pairs
    L = 3
    per_layer = 2 * L * 4 * 16 + 4 * 6 * 4 + 2 * L * 4 * 8 + 2 * (2 * L * 4 * 4) + 2 * L * 4 * 8 + 2 * L * 8 * 4
    assert flops.decoder_teacher(S, L) == per_layer + flops.memory_kv(S) + 2 * L * 4 * 5


def test_heads_by_hand():
    per_pair = 2 * (8 * 256 + 256 * 128 + 128 * 64 + 64)
    assert flops.scorenets(S) == 2 * 4 * per_pair
    assert flops.sinkhorn(S) == 3 * 2 * 5 * 9
    assert flops.pfn({"pfn_channels": [4, 6]}, 10) == 2 * 10 * 8 * 4 + 2 * 10 * 8 * 6


def test_totals_by_hand():
    fwd = (flops.patch_embed(S) + flops.vit(S, 4) + flops.decoder_teacher(S, 5) + flops.scorenets(S)
           + flops.sinkhorn(S))
    assert flops.train_tile(S) == 3 * fwd
    steps = flops.decoder_step(S, 0) + flops.decoder_step(S, 1)
    assert flops.predict_tile(S, 2) == flops.patch_embed(S) + flops.vit(S, 4) + flops.memory_kv(S) + steps + \
        flops.scorenets(S)


def test_the_published_pix2poly_counts():
    """~80 GFLOP a predicted tile (385 decode steps) and ~3x89 a trained one."""
    s = json.load(open(os.path.join(BENCH_DIR, "configs", "p2p_image.json")))["sizes"]
    assert flops.predict_tile(s, 385) == pytest.approx(80.5e9, rel=0.01)
    f = json.load(open(os.path.join(BENCH_DIR, "configs", "p2p_fusion.json")))["sizes"]
    assert flops.train_tile(f, 45000) == pytest.approx(3 * 89.0e9, rel=0.02)


def test_bytes_by_hand():
    # 10 kept points of 3 float32, 2 samples of 4 cells + a dump cell, each
    # pillar 3 float32 sums and an int32 count
    assert nbytes.pillar_sums(10, 2, 4) == 10 * 12 + 10 * 16
    # 6 rows' int64 ids, 4 of them kept with 4 float32 each, 3 pillars of 4
    # sums (the padding rows' channels and the dump cells' sums not counted)
    assert nbytes.run_sums(4, 6, 3, 4) == 48 + 64 + 48
    # a two-layer net: the last layer's tie counts once, the first's twice
    assert nbytes.pfn_run_sums(4, 6, 3, [4, 8]) == 2 * nbytes.run_sums(4, 6, 3, 4) + nbytes.run_sums(4, 6, 3, 8)
    assert nbytes.least_seconds(3.35e12) == 1.0
