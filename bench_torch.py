"""Pix2Poly inference benchmark of the PyTorch port: the twin of `bench.py`
(which benchmarks the JAX package and stays as it is). Prints one JSON line
with bench.py's keys:

    {"metric": "pix2poly_e2e_inference", "value": tiles/s, "unit": "tiles/sec",
     "vs_baseline": x, "spread_pct": p, "compute_dtype": "bfloat16", ...}

`value` is end-to-end Pix2Poly inference on `experiment=p2p_image` (ViT-S/8
at 224 px, 6-layer decoder, 192 vertex slots) at bfloat16, as bench.py runs
it: encoder, the fixed-length KV-cached greedy decode (all 385 steps) and
the Sinkhorn permutation head, on random images and a seeded model with
flax's default init. Tiles per second is the batch over the median time of
a batch over `repeats` repeats of `iters` batches; `spread_pct` is the
spread of the middle repeats over that median.

`vs_baseline` is measured live on the same card: the reference's decode
(one full decoder re-forward per generated token, no KV cache; bench.py:83-113)
probed over 16 steps and extrapolated to all 385, plus the encoder, against
the KV-cached decode. Every timing boundary synchronizes the card.

Usage: python3 bench_torch.py [--batch 16] [--iters 20] [--repeats 5]
       [--device cuda] [key.path=value ...]
It runs on the card; `--device cpu` runs on the CPU (the tests, at a tiny
size set by config overrides).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
PROBE_STEPS = 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(batch: int = 16, iters: int = 20, repeats: int = 5, device: str = "cuda",
        overrides: tuple[str, ...] = ()) -> dict:
    """Time the bfloat16 fixed-length decode and its no-cache baseline;
    returns bench.py's JSON object (plus the device and the batch)."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import resolve_device, set_tf32
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer, build_pix2poly, greedy_generate

    dev = resolve_device(device)
    set_tf32(False)
    cfg = compose(["experiment=p2p_image", "run_type=debug", *overrides])
    tokenizer = Tokenizer(cfg)
    model = build_pix2poly(cfg, tokenizer, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED),
                           dtype=torch.bfloat16).eval()
    steps = tokenizer.max_len - 1
    size = int(cfg.experiment.encoder.in_size)
    images = torch.from_numpy(np.random.RandomState(SEED).rand(batch, size, size, 3).astype(np.float32)).to(dev)
    inputs = {"images": images}

    def run_once() -> None:
        greedy_generate(model, inputs, tokenizer.BOS_code, steps)
        _sync(dev)

    with torch.inference_mode():
        run_once()  # warm-up
        per_batch = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                run_once()
            per_batch.append((time.perf_counter() - t0) / iters)
        per_batch.sort()
        dt = statistics.median(per_batch)
        trimmed = per_batch[1:-1] if len(per_batch) >= 3 else per_batch
        spread_pct = 100.0 * (trimmed[-1] - trimmed[0]) / dt

        # the reference's decode: a full re-forward of the decoder per token
        enc = model.encode(inputs)
        tgt = torch.full((batch, steps), tokenizer.PAD_code, dtype=torch.long, device=dev)
        tgt[:, 0] = tokenizer.BOS_code
        model.decoder(enc, tgt)  # warm-up
        _sync(dev)
        probe = min(PROBE_STEPS, steps)
        probe_ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(probe):
                logits, _ = model.decoder(enc, tgt)
                nxt = torch.argmax(logits[:, i], dim=-1).cpu()  # the reference reads each token on the host
                tgt[:, min(i + 1, steps - 1)] = nxt.to(dev)
            _sync(dev)
            probe_ts.append((time.perf_counter() - t0) / probe)
        enc_ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            model.encode(inputs)
            _sync(dev)
            enc_ts.append(time.perf_counter() - t0)
    baseline_dt = statistics.median(enc_ts) + statistics.median(probe_ts) * steps
    return {
        "metric": "pix2poly_e2e_inference",
        "value": round(batch / dt, 2),
        "unit": "tiles/sec",
        "vs_baseline": round(baseline_dt / dt, 2),
        "spread_pct": round(spread_pct, 1),
        "compute_dtype": "bfloat16",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "batch": batch,
    }


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    out = run(args.batch, args.iters, args.repeats, args.device, tuple(args.overrides))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
