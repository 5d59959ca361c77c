"""Time HiSup's float32 train step with each form of its bilinear resizes.

Usage (from the repository root, on a machine with a CUDA card):

    python3 hisup_resize_bench.py [--batch 16] [--rounds 3]

At float32 the port resizes with `F.interpolate` (HRNet's align-corners
fusions and the decoder's 56 -> 224 enlargement); at bfloat16 it computes
JAX's two products with interpolation matrices, which round as JAX does.
This script builds `experiment=hisup_image` at full width (HRNetV2-W48,
head width 256) at float32 with TF32 off, and times one train-mode forward
and its backward on a synthetic batch with the port's resizes and with the
matrix products forced at float32, in turns (port, matrix, matrix, port,
port, matrix), each turn a warm-up and `--rounds` timed steps (CUDA events
for the forward and the backward, the host clock for the step). It prints
the card's name and power limit, each form's medians, the outputs' largest
relative difference between the two forms, and one JSON object as its last
line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on the card")
    sys.path.insert(0, ROOT)
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import set_tf32
    from pixelspointspolygons_torch.models import hrnet
    from pixelspointspolygons_torch.models.hisup import model as hisup
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup
    from pixelspointspolygons_torch.models.layers import _resize_matrix, layout_of

    set_tf32(False)
    card = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    cfg = compose(["experiment=hisup_image", "dataset=synthetic", "run_type=debug"])
    size = int(cfg.experiment.model.decoder.in_feature_size)
    model = build_hisup(cfg, device=card, generator=torch.Generator(device=card).manual_seed(0))
    images = torch.rand(args.batch, 224, 224, 3, generator=torch.Generator(device=card).manual_seed(1), device=card)
    port_align, port_bilinear = hrnet.resize_align_corners, hisup.resize_bilinear

    def matrix_align(x, out_hw):
        (H, W), (H2, W2) = x.shape[2:], (int(out_hw[0]), int(out_hw[1]))
        if (H, W) == (H2, W2):
            return x
        y = torch.matmul(hrnet._interp_matrix(H2, H, x.dtype, x.device), x)
        y = torch.matmul(y, hrnet._interp_matrix(W2, W, x.dtype, x.device).T)
        return y.contiguous(memory_format=layout_of(x))

    def matrix_bilinear(x, n):
        H, W = x.shape[2:]
        if (H, W) == (n, n):
            return x
        y = torch.matmul(_resize_matrix(H, n, x.device).to(x.dtype).T, x)
        y = torch.matmul(y, _resize_matrix(W, n, x.device).to(x.dtype))
        return y.contiguous(memory_format=layout_of(x))

    def use(form: str) -> None:
        hrnet.resize_align_corners = port_align if form == "port" else matrix_align
        hisup.resize_bilinear = port_bilinear if form == "port" else matrix_bilinear

    def step() -> tuple[float, float, float]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t = time.perf_counter()
        ev[0].record()
        out = model.train()({"images": images})
        ev[1].record()
        sum(v.float().mean() for v in out.values()).backward()
        ev[2].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        model.zero_grad(set_to_none=True)
        return wall, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    times: dict[str, list] = {"port": [], "matrix": []}
    for form in ("port", "matrix", "matrix", "port", "port", "matrix"):
        use(form)
        step()
        times[form] += [step() for _ in range(args.rounds)]
    with torch.no_grad():
        outs = {}
        for form in times:
            use(form)
            outs[form] = model.eval()({"images": images[:4]})
    use("port")
    diff = {k: float((outs["matrix"][k] - v).abs().max() / v.abs().max()) for k, v in outs["port"].items()}
    result = {"card": smi, "batch": args.batch, "pred_size": size, "output_max_rel_diff": diff}
    for form, rows in times.items():
        med = {name: statistics.median(r[i] for r in rows) for i, name in enumerate(("step_ms", "forward_ms",
                                                                                    "backward_ms"))}
        result[form] = med
        print(f"{form} resizes (float32): step {med['step_ms']:.1f} ms (host clock, median of {len(rows)}: "
              f"{[round(r[0], 1) for r in rows]}), forward {med['forward_ms']:.1f} ms, backward "
              f"{med['backward_ms']:.1f} ms (CUDA events), card {smi}", flush=True)
    print(f"outputs, matrix against port, max rel diff: {diff}", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
