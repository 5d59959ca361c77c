"""Time the synchronised BatchNorm's forms in HiSup's DDP step, on one card.

Usage (from the repository root, on a machine with a CUDA card):

    python3 sync_bn_bench.py [--batch 16] [--turns 3]

Under a process group every train-mode `BatchNorm` of the port takes the
statistics of the global batch (`models/layers.py::_SyncBatchNormFn`). At
world size 1 over NCCL this script builds `experiment=hisup_image` at full
width (HRNetV2-W48, 323 BatchNorms) at float32 with TF32 off, wraps it in
DDP as the trainers do, and times its forward and backward on a synthetic
batch (the loss is the sum of the outputs' means) with each form of the
layer, in turns with the plain model (another copy, without DDP, on the
layers' local path):

- `port`: the port's layer (`var_mean`, one all-gather and Chan's
  combination, `F.batch_norm`; torch's backward kernel and one all-reduce);
- `three_all_reduces`: float64 sums all-reduced, then the centred sums of
  squares, then the backward's two sums (elementwise PyTorch);
- `gather_two_pass`: two explicit float64 passes, one all-gather and
  Chan's combination, the same elementwise backward;
- `port_no_collectives`: the port's layer with its collectives replaced by
  what they return in one process, to split the layer's own calls from its
  collectives (a measurement only: it is right at world size 1 alone).

Then each form alone, forward and backward at three of HRNet's shapes
(host µs a call, the card's work included). Each form is checked against
the port's layer on one input first. Prints the card's name and power
limit, the medians, and one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FORMS = ("port", "three_all_reduces", "gather_two_pass", "port_no_collectives")
SHAPES = ((16, 64, 112, 112), (16, 48, 56, 56), (16, 384, 7, 7))


def elementwise_backward(ctx, g):
    """BatchNorm's backward with Σg and Σg·x̂ all-reduced (the other forms')."""
    from pixelspointspolygons_torch import parallel

    x, weight, mean, invstd = ctx.saved_tensors
    dims = [d for d in range(x.dim()) if d != 1]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xhat = (x - mean.view(shape)).mul_(invstd.view(shape))
    local = torch.stack([g.sum(dims), (g * xhat).sum(dims)])
    sum_g, sum_gx = parallel.all_reduce_sum(local.clone(), "batch_norm") / ctx.total
    grad = (g - sum_g.view(shape)).sub_(xhat.mul_(sum_gx.view(shape))).mul_((invstd * weight).view(shape))
    return grad, local[1], local[0], None


class ThreeAllReduces(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        from pixelspointspolygons_torch import parallel

        dims = [d for d in range(x.dim()) if d != 1]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        sums = x.sum(dims, dtype=torch.float64)
        stats = parallel.all_reduce_sum(torch.cat([sums, sums.new_full((1,), x.numel() // x.shape[1])]), "batch_norm")
        total = stats[-1]
        mean = (stats[:-1] / total).to(x.dtype)
        xc = x - mean.view(shape)
        var = (parallel.all_reduce_sum(xc.square().sum(dims, dtype=torch.float64), "batch_norm") / total).to(x.dtype)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.total = total.to(x.dtype)
        ctx.mark_non_differentiable(mean, var)
        return torch.addcmul(bias.view(shape), xc, (invstd * weight).view(shape)), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        return elementwise_backward(ctx, g)


class GatherTwoPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        from pixelspointspolygons_torch import parallel

        dims = [d for d in range(x.dim()) if d != 1]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        local_mean = x.mean(dims, dtype=torch.float64)
        m2 = (x - local_mean.to(x.dtype).view(shape)).square().sum(dims, dtype=torch.float64)
        rows = torch.stack([torch.full_like(m2, x.numel() // x.shape[1]), local_mean, m2])
        counts, means, m2s = parallel.all_gather_stacked(rows, "batch_norm").unbind(1)
        total = counts.sum(0)
        mean64 = (counts * means).sum(0) / total
        var = ((m2s + counts * (means - mean64).square()).sum(0) / total).to(x.dtype)
        mean = mean64.to(x.dtype)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.total = total.to(x.dtype)
        ctx.mark_non_differentiable(mean, var)
        return torch.addcmul(bias.view(shape), x - mean.view(shape), (invstd * weight).view(shape)), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        return elementwise_backward(ctx, g)


@contextlib.contextmanager
def form(name: str):
    """The layers' synchronised function replaced by `name`'s for the block."""
    from pixelspointspolygons_torch import parallel
    from pixelspointspolygons_torch.models import layers

    saved = (layers._SyncBatchNormFn, parallel.all_gather_stacked, parallel.all_reduce_sum)
    layers._SyncBatchNormFn = {"three_all_reduces": ThreeAllReduces, "gather_two_pass": GatherTwoPass}.get(
        name, saved[0])
    if name == "port_no_collectives":
        parallel.all_gather_stacked = lambda t, kind: t[None]
        parallel.all_reduce_sum = lambda t, kind: t
    try:
        yield layers._SyncBatchNormFn
    finally:
        layers._SyncBatchNormFn, parallel.all_gather_stacked, parallel.all_reduce_sum = saved


def timed(fn, calls: int) -> float:
    """Host ms a call over `calls` calls after a warm-up, the card's work
    included (synchronised before and after)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / calls


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--turns", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on the card")
    sys.path.insert(0, ROOT)
    from pixelspointspolygons_torch import parallel
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import set_deterministic, set_tf32
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup
    from pixelspointspolygons_torch.models.layers import BatchNorm

    card = torch.device("cuda")
    set_deterministic(card)
    set_tf32(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    parallel.init_distributed("cuda", world_size=1, rank=0, init_method=f"tcp://127.0.0.1:{parallel.free_port()}")
    try:
        # each form against the port's layer on one input, forward and backward
        gen = torch.Generator(device=card).manual_seed(0)
        x = (torch.randn(8, 32, 20, 20, device=card, generator=gen) * 2 + 0.5).requires_grad_()
        w = (torch.rand(32, device=card, generator=gen) + 0.5).requires_grad_()
        b = torch.rand(32, device=card, generator=gen).requires_grad_()
        g = torch.randn(8, 32, 20, 20, device=card, generator=gen)
        ref = None
        agree = {}
        for name in FORMS:
            with form(name) as fn:
                y, mean, var = fn.apply(x, w, b, 1e-5)
                got = [t.detach() for t in (y, mean, var, *torch.autograd.grad(y, (x, w, b), g))]
            ref = ref or got
            agree[name] = max(float((a - r).abs().max() / r.abs().max()) for a, r in zip(got, ref))
        print(f"each form against the port's layer (largest relative difference): {agree}", flush=True)
        cfg = compose(["experiment=hisup_image", "dataset=synthetic", "run_type=debug"])
        model, plain = (build_hisup(cfg, device=card, generator=torch.Generator(device=card).manual_seed(0)).train()
                        for _ in range(2))
        n_norms = sum(isinstance(m, BatchNorm) for m in model.modules())
        images = torch.rand(args.batch, 224, 224, 3, generator=torch.Generator(device=card).manual_seed(1),
                            device=card)
        ddp = parallel.wrap_model(model)

        def step(net):
            net.zero_grad(set_to_none=True)
            sum(v.float().mean() for v in net({"images": images}).values()).backward()

        steps: dict = {k: [] for k in ("plain",) + FORMS}
        collectives = {}
        for _ in range(args.turns):
            for name in steps:
                if name == "plain":  # another copy of the model, without DDP, on the layers' local path
                    steps[name].append(_without_group(timed, lambda: step(plain), 2))
                    continue
                with form(name):
                    parallel.collectives.clear()
                    steps[name].append(timed(lambda: step(ddp), 2))
                    collectives[name] = {k: v // 3 for k, v in parallel.collectives.items()}
        med = {k: statistics.median(v) for k, v in steps.items()}
        print(f"hisup_image forward and backward (float32, batch {args.batch}, world size 1, {n_norms} "
              f"BatchNorms), median ms of {args.turns} turns: "
              + ", ".join(f"{k} {v:.1f} ({100 * (v / med['plain'] - 1):+.1f} %)" for k, v in med.items())
              + f"; collectives a step {collectives}; card {smi}", flush=True)
        del ddp, model, plain
        torch.cuda.empty_cache()
        layer: dict = {}
        for shape in SHAPES:
            x = torch.randn(*shape, device=card).contiguous(memory_format=torch.channels_last).requires_grad_()
            w = torch.ones(shape[1], device=card, requires_grad=True)
            b = torch.zeros(shape[1], device=card, requires_grad=True)
            g = torch.randn_like(x)
            layer[str(shape)] = {"plain": 1e3 * timed(
                lambda: torch.nn.functional.batch_norm(x, None, None, w, b, True, 0.0, 1e-5).backward(g), 30)}
            for name in FORMS:
                with form(name) as fn:
                    layer[str(shape)][name] = 1e3 * timed(lambda: fn.apply(x, w, b, 1e-5)[0].backward(g), 30)
            print(f"BatchNorm {shape} forward and backward, µs a call: "
                  f"{ {k: round(v, 1) for k, v in layer[str(shape)].items()} }; card {smi}", flush=True)
    finally:
        parallel.destroy_distributed()
    print(smi, flush=True)
    print(json.dumps({"steps_ms": steps, "median_ms": med, "collectives": collectives, "layer_us": layer,
                      "agree": agree, "n_norms": n_norms, "card": smi}), flush=True)


def _without_group(fn, *args):
    """`fn(*args)` with the layers' local path (as without a group)."""
    from pixelspointspolygons_torch.models import layers

    synchronised = layers._synchronised
    layers._synchronised = lambda: False
    try:
        return fn(*args)
    finally:
        layers._synchronised = synchronised


if __name__ == "__main__":
    main()
