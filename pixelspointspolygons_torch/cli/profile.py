"""Capture a `torch.profiler` trace of the flagship Pix2Poly steps — twin
of scripts/profile.py: `generate` (the greedy decode of all max_len − 1
steps, then the Sinkhorn permutation) or `train` (one AdamW train step),
at batch 8 on seeded 224 px images, for a model drawn from seed 0. One
untraced run first, then three traced runs (or `runs`), written as a Chrome
trace (`chrome://tracing`, Perfetto) to `<trace_dir>/trace_<mode>.json`.

Usage: python -m pixelspointspolygons_torch.cli.profile [trace_dir] [train|generate] [runs] [key.path=value ...] [device=cpu]

Runs on the card and traces the CPU and the card's kernels; `device=cpu`
runs and traces on the CPU. The default trace directory is `p3tpu_trace`
in the temporary directory.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from ..config.engine import compose
from ..device import resolve_device
from ._common import print_line, run, split_device

B = 8


def main(argv: list[str] | None = None) -> dict:
    """The trace file's path and the export's seconds."""
    from torch.profiler import ProfilerActivity, profile

    from ..models.pix2poly import Tokenizer, build_pix2poly, greedy_generate

    overrides, device = split_device(argv)
    args = [a for a in overrides if "=" not in a]
    trace_dir = args[0] if args else os.path.join(tempfile.gettempdir(), "p3tpu_trace")
    mode = args[1] if len(args) > 1 else "generate"
    runs = int(args[2]) if len(args) > 2 else 3
    dev = resolve_device(device)

    cfg = compose(["experiment=p2p_image", "run_type=debug"] + [a for a in overrides if "=" in a])
    tok = Tokenizer(cfg)
    model = build_pix2poly(cfg, tok, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(B, 224, 224, 3).astype(np.float32)).to(dev)

    if mode == "generate":
        model.eval()

        @torch.no_grad()
        def step():
            return greedy_generate(model, {"images": images}, tok.BOS_code, tok.max_len - 1)[0].cpu()
    else:
        from ..train.pix2poly_step import make_train_step
        from ..train.state import TrainState, make_optimizer, make_scheduler

        lr = 3e-4
        opt = make_optimizer("adamw", model.parameters(), lr, weight_decay=1e-4, b2=0.95)
        state = TrainState(model, opt, make_scheduler(opt, lambda n: lr, lr))
        train_step = make_train_step(1.0, 10.0, tok.PAD_code)
        y = torch.full((B, tok.max_len), tok.PAD_code, dtype=torch.int32, device=dev)
        y[:, 0] = tok.BOS_code
        batch = {
            "images": images,
            "y": y,
            "y_perm": torch.eye(tok.max_num_vertices, device=dev).expand(B, -1, -1).contiguous(),
        }

        def step():
            return float(train_step(state, batch)["loss"])

    step()  # untraced: the first call's set-up
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        for _ in range(runs):
            step()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{mode}.json")
    t0 = time.perf_counter()
    prof.export_chrome_trace(path)
    export_s = time.perf_counter() - t0
    print_line(f"trace written to {trace_dir} (mode={mode})")
    return {"path": path, "export_s": export_s}


if __name__ == "__main__":
    run(main)
