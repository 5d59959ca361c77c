"""One process of the 2-process gloo group that `tests/test_torch_ddp.py`
starts once per module (not a test module: pytest collects `test_*.py`).

    python tests/torch_ddp_worker.py INPUTS.pt WORKDIR RANK

INPUTS.pt holds the cases: each a family, a tiny model's initial
state_dict, a global batch, its dtype and its options. The process joins a group of
2 (a `file://` store under WORKDIR), runs each case's DDP train step on its
half of the global batch (rank 0 the first rows) and, for the negative
controls, the same step with the synchronisation switched off or with the
local token normalizer; then the synchronised layers alone. Rank 0 writes
these results to WORKDIR/results.pt, a list of both processes' results
where each has its own: metrics (global means), gradients (DDP's
averages), BatchNorm buffers, the collectives issued, and the layers'
outputs and gradients. Rank 1 then starts a group of 1, runs the
world-size-1 cases and writes them to WORKDIR/results_ws1.pt.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import graft_entry_torch as entry  # noqa: E402
from pixelspointspolygons_torch import parallel  # noqa: E402
from pixelspointspolygons_torch.config import compose  # noqa: E402
from pixelspointspolygons_torch.models import layers  # noqa: E402
from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss  # noqa: E402
from pixelspointspolygons_torch.train import ffl_step, hisup_step, pix2poly_step  # noqa: E402
from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler  # noqa: E402

LR = 1e-4


def build(case: dict, dtype: torch.dtype) -> torch.nn.Module:
    family, encoder = case["family"], case.get("encoder")
    gen = torch.Generator().manual_seed(0)
    if family == "pix2poly":
        model = entry.tiny_pix2poly(gen, dtype)
    elif family == "hisup":
        model = entry.tiny_hisup(encoder, gen, case.get("size", entry.S), dtype)
    else:
        model = entry.tiny_ffl(gen, dtype)
    model.load_state_dict(case["state_dict"])
    return model


def train_step(case: dict, batch: dict, dtype: torch.dtype | None = None) -> dict:
    """One train step of `case` on `batch` (tensors) in `dtype` (default:
    the case's, else float32): under a process group through DDP
    (`TrainState.wrap`, as the trainers wrap), else plain. Returns the
    metrics (means over processes), the gradients and the BatchNorm
    buffers after the step."""
    dtype = dtype or case.get("dtype", torch.float32)
    parallel.collectives.clear()
    model = build(case, dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    opt = make_optimizer("adam" if case["family"] == "ffl" else "adamw", model.parameters(), LR)
    state = TrainState(model, opt, make_scheduler(opt, lambda n: LR, LR))
    remat = bool(case.get("remat"))
    state.wrap(hisup_step.train_module(model, remat) if case["family"] == "hisup" else None)
    if case["family"] == "hisup":
        metrics = hisup_step.make_train_step(entry.HISUP_WEIGHTS, case.get("size", entry.S), remat=remat)(state, batch)
    elif case["family"] == "pix2poly":
        metrics = pix2poly_step.make_train_step(1.0, 10.0, 34)(state, batch)
    else:
        loss_fn, weights_for_epoch = make_ffl_loss(compose(["experiment=ffl_image", "dataset=synthetic",
                                                            "run_type=debug"]))
        metrics = ffl_step.make_train_step(loss_fn)(state, batch, weights_for_epoch(0))
    means = parallel.all_reduce_mean(torch.stack([metrics[k].double() for k in metrics]))
    return {
        "metrics": dict(zip(metrics, means.tolist())),
        "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
        "buffers": {n: b.detach().clone() for n, b in model.named_buffers()},
        "collectives": dict(parallel.collectives),
    }


def layer_outputs(inputs: dict) -> dict:
    """The synchronised `BatchNorm` on NCHW maps and `RowBatchNorm` on
    (N, C) rows, each on this process's rows of the inputs: the output and
    the input gradient of these rows, the weight and bias gradients summed
    over processes, the running statistics."""
    rank, world = parallel.process_index(), parallel.process_count()
    out = {}
    for name, cls in (("maps", layers.BatchNorm), ("rows", layers.RowBatchNorm)):
        x, g = inputs[f"{name}_x"], inputs[f"{name}_g"]
        n = x.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        bn = cls(x.shape[1])
        bn.load_state_dict(inputs[f"{name}_state"])
        xl = x[rows].clone().requires_grad_()
        y = bn(xl)
        (y * g[rows]).sum().backward()
        wg = parallel.all_reduce_sum(torch.stack([bn.weight.grad, bn.bias.grad]), "test")
        out[name] = {"y": y.detach(), "x_grad": xl.grad, "weight_grad": wg[0], "bias_grad": wg[1],
                     "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}
    return out


def halves(batch: dict, rank: int, world: int) -> dict:
    n = next(iter(batch.values())).shape[0] // world
    return {k: torch.from_numpy(v[rank * n:(rank + 1) * n]) for k, v in batch.items()}


def main() -> None:
    inputs_file, workdir, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    torch.set_num_threads(1)
    inputs = torch.load(inputs_file, weights_only=False)
    results: dict = {"ws2": {}, "controls": {}}
    parallel.init_distributed("cpu", world_size=2, rank=rank, init_method=f"file://{workdir}/store2")
    for name, case in inputs["cases"].items():
        results["ws2"][name] = parallel.all_gather_objects(train_step(case, halves(case["batch"], rank, 2)))
    synchronised = layers._synchronised
    layers._synchronised = lambda: False
    for name in inputs["sync_controls"]:
        case = inputs["cases"][name]
        results["controls"][f"{name}_unsynchronised"] = train_step(case, halves(case["batch"], rank, 2))
    layers._synchronised = synchronised
    global_count = pix2poly_step.global_token_count
    pix2poly_step.global_token_count = lambda count: count * parallel.process_count()
    case = inputs["cases"]["pix2poly_float64"]
    results["controls"]["pix2poly_local_normalizer"] = train_step(case, halves(case["batch"], rank, 2))
    pix2poly_step.global_token_count = global_count
    results["ws2"]["layers"] = parallel.all_gather_objects(layer_outputs(inputs["layers"]))
    parallel.destroy_distributed()
    if rank == 0:
        torch.save(results, os.path.join(workdir, "results.pt"))
        return
    parallel.init_distributed("cpu", world_size=1, rank=0, init_method=f"file://{workdir}/store1")
    ws1 = {name: [train_step(inputs["cases"][name], halves(inputs["cases"][name]["batch"], 0, 1))]
           for name in inputs["ws1_cases"]}
    ws1["layers"] = [layer_outputs(inputs["layers"])]
    parallel.destroy_distributed()
    torch.save(ws1, os.path.join(workdir, "results_ws1.pt"))


if __name__ == "__main__":
    main()
