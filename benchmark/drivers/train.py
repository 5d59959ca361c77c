"""The training window: after seeding as `Trainer.train` does and
`setup()`, `train_one_epoch` epoch after epoch from the device cache, the
last epoch finished and counted whole. Each step's time is the interval
between CUDA events recorded after consecutive calls of the trainer's step
(the first from an event at the window's start), so a gap that the host
leaves between steps counts.

Set-up builds the trainer once, warm-started from weights the benchmark
drew, and runs epoch 0 through the same `train_one_epoch`: that warms every
shape. Checked are the first three steps of epoch 0 and the first three of
the window (of epoch 1, past the first updates, with epoch 1's shuffle and
augmentation draws). After the window the reference replays epoch 0 and
those three steps from the same weights on the batches it works out again
from the files: each checked step's loss, the norm of each leaf's first
gradient (the optimizer's first moment after step 1, over 1 - beta1), and
of each leaf's change after the third step and after the window's third
step, against the reference's, by the worst leaf."""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from benchmark.counts import flops
from benchmark.harness.compare import numerics, reference_model, worst_leaf_gap
from benchmark.harness.runner import Check, program_seed
from benchmark.harness.trace import two_stretches
from benchmark.harness.weights import make_state, write_checkpoint
from benchmark.reference.data import TrainSplit, d4_keypoints, load_points, read_split, sample_params
from benchmark.reference.model import losses
from benchmark.traffic.generate import write_splits

# limits, set from the readings in PERF.md ("Correctness")
LIMITS = {"loss_gap": 2.5e-6, "grad_gap": 1.2e-3, "change_gap": 2e-2,
          "window_loss_gap": 2e-3, "window_change_gap": 6e-2}
CHECKED_STEPS = 3
# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone (a key's bias under softmax, a bias before a
# BatchNorm) and are left out of the leaf comparisons
NOUGHT_SHARE = 1e-3


def setup(ctx) -> dict:
    from pixelspointspolygons_torch.config.engine import compose
    from pixelspointspolygons_torch.train.trainer_pix2poly import Pix2PolyTrainer
    from pixelspointspolygons_torch.utils.seeding import seed_everything

    s, tr = ctx.sizes, ctx.traffic
    ctx.phase("imports")
    init = write_checkpoint(make_state(s, ctx.seed, ctx.device), os.path.join(ctx.work, "init"), "bench")
    ctx.phase("weights")
    cfg = compose(ctx.overrides() + [f"init_weights_from={init}"])
    ds = cfg.experiment.dataset
    points = write_splits(ds.in_path, ds.annotations, tr["splits"], ctx.seed, s["height"], s["use_lidar"],
                          tr["max_points"])
    ctx.phase("tiles")
    trainer = Pix2PolyTrainer(cfg, device=ctx.device)
    seed = int(cfg.seed)
    seed_everything(seed)
    trainer.generator = torch.Generator(device=trainer.device).manual_seed(seed)
    trainer.setup()
    ctx.phase("trainer set-up (packs, uploads, model)")
    state = {"cfg": cfg, "trainer": trainer, "init": init, "records": [], "events": None, "steps": 0,
             "points": points, "epoch": 0}
    _wrap(ctx, state)
    trainer.train_one_epoch(0)
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
        state["setup_peak"] = torch.cuda.max_memory_allocated()
    state["first_losses"] = [{k: float(v) for k, v in r.items()} for r in state["records"][:CHECKED_STEPS]]
    state["records"].clear()
    state["epoch0_steps"] = state["steps"]
    ctx.phase("epoch 0")
    return state


def _wrap(ctx, state: dict) -> None:
    """Time and observe each call of the trainer's step; snapshot the
    optimizer's first moment after step 1 and the weights after step 3 and
    after the window's step 3 (on the card, read after the window); plant
    the test's faults in the step."""
    trainer = state["trainer"]
    step_fn = trainer._train_step
    on_card = torch.device(ctx.device).type == "cuda"
    beta1 = trainer.state.optimizer.param_groups[0]["betas"][0]

    def step(train_state, batch, generator=None):
        if ctx.fault == "half_batch":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        if ctx.fault == "token":
            batch = dict(batch, y=batch["y"].clone())
            batch["y"][0, 3] = (batch["y"][0, 3] + 1) % ctx.sizes["num_bins"]
        saved = None
        if ctx.fault == "unchanged":
            saved = [p.detach().clone() for p in train_state.model.parameters()]
        out = step_fn(train_state, batch, generator)
        if saved is not None:
            with torch.no_grad():
                for p, q in zip(train_state.model.parameters(), saved):
                    p.copy_(q)
        state["steps"] += 1
        state["records"].append(out)
        if state.get("hook"):
            state["hook"](state["steps"])
        if state["events"] is not None:
            ev = torch.cuda.Event(enable_timing=True) if on_card else None
            if ev is not None:
                ev.record()
            state["events"].append(ev if on_card else time.perf_counter())
        if state["steps"] == 1:
            opt = train_state.optimizer
            state["grad1"] = {n: float(opt.state[p]["exp_avg"].double().norm()) / (1.0 - beta1)
                              for n, p in train_state.model.named_parameters() if p in opt.state}
        if state["steps"] == CHECKED_STEPS:
            state["weights3"] = {n: p.detach().double().cpu() for n, p in train_state.model.named_parameters()}
        if state.get("epoch0_steps") is not None and state["steps"] == state["epoch0_steps"] + CHECKED_STEPS:
            state["weights_w"] = {n: p.detach().clone() for n, p in train_state.model.named_parameters()}
        return out

    trainer._train_step = step


def window(ctx, state: dict, seconds: float) -> dict:
    trainer = state["trainer"]
    on_card = torch.device(ctx.device).type == "cuda"
    if on_card:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        state["events"] = [ev]
    else:
        state["events"] = [time.perf_counter()]
    t0 = time.perf_counter()
    epochs = 0
    while True:
        state["epoch"] += 1
        trainer.train_one_epoch(state["epoch"])
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    evs = state["events"]
    state["events"] = None
    if on_card:
        step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(len(evs) - 1)]
    else:
        step_ms = [(evs[i + 1] - evs[i]) * 1e3 for i in range(len(evs) - 1)]
    losses_ = torch.stack([r["loss"].float() for r in state["records"]]).cpu()
    if "window_losses" not in state:
        state["window_losses"] = [{k: float(v) for k, v in r.items()} for r in state["records"][:CHECKED_STEPS]]
    state["records"].clear()
    bs = int(state["cfg"].experiment.model.batch_size)
    pts = _valid_points(ctx, state)
    per_epoch = sum(flops.train_tile(ctx.sizes, p) for p in pts[: (len(pts) // bs) * bs])
    return {"seconds": elapsed, "steps": len(step_ms), "tiles": len(step_ms) * bs, "step_ms": step_ms,
            "attempted": len(step_ms), "failed": int((~torch.isfinite(losses_)).sum()), "epochs": epochs,
            "flops": per_epoch * epochs}


def _valid_points(ctx, state: dict) -> list[int]:
    """Each train tile's LiDAR points as the cache keeps them (0 without
    LiDAR)."""
    if not ctx.sizes["use_lidar"]:
        return [0] * int(ctx.traffic["splits"]["train"])
    counts = state["points"]["train"]
    return [min(c, _cache_cap(ctx, counts)) for c in counts]


def _cache_cap(ctx, counts: list[int]) -> int:
    """The device cache's points a cloud: the split's largest count rounded
    up to 1024, at most max_num_points."""
    return int(min(ctx.sizes["max_num_points"], ((max(counts) + 1023) // 1024) * 1024))


def traced(ctx, state: dict) -> dict:
    """Two more epochs, each traced from the end of its first step to its
    end (`two_stretches`: the device alone, then with the host operations),
    with what the kernels' byte counts need: the rows, kept points and
    pillars of the device-only epoch's traced steps."""
    epochs = []

    def run(hook):
        first = state["steps"]
        state["hook"] = lambda n: hook(n - first)
        state["epoch"] += 1
        epochs.append(state["epoch"])
        state["trainer"].train_one_epoch(state["epoch"])
        state["hook"] = None

    out = two_stretches(run, first=1)
    per_epoch = int(ctx.traffic["splits"]["train"]) // int(state["cfg"].experiment.model.batch_size)
    out["units"] = per_epoch - 1
    if ctx.sizes["use_lidar"]:
        out["lidar"] = _lidar_work(ctx, state, epochs[0], range(1, per_epoch))
    return out


def _lidar_work(ctx, state: dict, epoch: int, batches) -> dict:
    """The steps `batches` of `epoch`: the rows of the padded clouds the
    PillarFeatureNet sums, the points the voxelizer keeps (a pillar's first
    max_points_per_voxel), which are the rows whose sums are read, and the
    pillars, from the files and the epoch's D4 draws."""
    s, cfg = ctx.sizes, state["cfg"]
    bs = int(state["cfg"].experiment.model.batch_size)
    infos, _ = read_split(cfg.experiment.dataset.annotations["train"])
    root = cfg.experiment.dataset.in_path
    n = len(infos)
    cap = _cache_cap(ctx, state["points"]["train"])
    cells_x, cells_y = int(round(s["width"] / s["voxel_x"])), int(round(s["height"] / s["voxel_y"]))
    seed = program_seed(ctx.seed)
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    order = np.concatenate([order[b * bs:(b + 1) * bs] for b in batches])
    kept = 0
    augs = list(cfg.experiment.encoder.augmentations)
    for i in order:
        p = sample_params(np.random.RandomState((seed * 1_000_003 + epoch * 10_007 + int(i)) % (2**31)), augs)
        pts = load_points(root, infos[i], s["z_range"])[:cap]
        xy = d4_keypoints(pts[:, :2], p["d4"], s["height"], s["width"]) if p["d4"] != "e" else pts[:, :2]
        ix, iy = np.floor(xy[:, 0] / s["voxel_x"]), np.floor(xy[:, 1] / s["voxel_y"])
        inside = (ix >= 0) & (ix < cells_x) & (iy >= 0) & (iy < cells_y)
        counts = np.bincount((iy * cells_x + ix)[inside].astype(np.int64), minlength=cells_x * cells_y)
        kept += int(np.minimum(counts, s["max_points_per_voxel"]).sum())
    steps = len(batches)
    return {"steps": steps, "samples": bs, "cells": cells_x * cells_y, "rows": steps * bs * cap,
            "pillars": steps * bs * cells_x * cells_y, "kept_points": kept}


def release(state: dict) -> None:
    state.pop("trainer", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _lr(s: dict, n_train: int, bs: int, update: int) -> float:
    """The program's schedule: linear warmup from 0 over 5 % of the updates,
    then linear decay to 0 (update 0 uses the first value)."""
    t = s["training"]
    base, total = t["learning_rate"], (n_train // bs) * t["num_epochs"]
    warmup = max(int(total * t["warmup_frac"]), 1)
    if update < warmup:
        return base * min(update, warmup) / warmup
    rest = max(total - warmup, 1)
    return base * (1.0 - min(update - warmup, rest) / rest)


def reference_steps(ctx, state: dict, tf32: bool) -> dict:
    """The reference over epoch 0 and the first CHECKED_STEPS steps of
    epoch 1: the checked steps' losses, the first gradient's leaf norms,
    the leaf norms of the change after step CHECKED_STEPS and after the
    last step."""
    s, cfg = ctx.sizes, state["cfg"]
    t = s["training"]
    bs = int(state["cfg"].experiment.model.batch_size)
    ds = cfg.experiment.dataset
    split = TrainSplit(ds.in_path, ds.annotations["train"], s, list(cfg.experiment.encoder.augmentations),
                       s["max_num_points"], s["z_range"])
    model = reference_model(s, state["init"], ctx.device).train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().double().cpu() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2 = t["betas"]
    pad = s["num_bins"] + 2
    out = {"losses": [], "window_losses": []}
    seed = program_seed(ctx.seed)
    per_epoch = split.n // bs
    plan = [(0, k) for k in range(per_epoch)] + [(1, k) for k in range(CHECKED_STEPS)]

    def change() -> dict:
        return {n: float((p.detach().double().cpu() - p0).norm()) for n, p, p0 in zip(names, params, start)}

    for step, (epoch, k) in enumerate(plan):
        batch = split.batch(seed, epoch, k, bs, ctx.device)
        with numerics(tf32):
            logits, perm = model(batch, batch["y"][:, :-1], pad)
            ls = losses(logits, perm, batch["y"], batch["y_perm"], pad, s["vertex_loss_weight"],
                        s["perm_loss_weight"])
            grads = torch.autograd.grad(ls["loss"], params)
        if step < CHECKED_STEPS:
            out["losses"].append({k2: float(v2.detach()) for k2, v2 in ls.items()})
        if epoch == 1:
            out["window_losses"].append({k2: float(v2.detach()) for k2, v2 in ls.items()})
        if step == 0:
            out["grad1"] = {n: float(g.double().norm()) for n, g in zip(names, grads)}
        lr = _lr(s, split.n, bs, step)
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                p.mul_(1.0 - lr * t["weight_decay"])
                mi.lerp_(g, 1.0 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (vi.sqrt() / math.sqrt(1.0 - b2 ** (step + 1))).add_(t["eps"])
                p.addcdiv_(mi, denom, value=-lr / (1.0 - b1 ** (step + 1)))
        del logits, perm, ls, grads, batch
        if step == CHECKED_STEPS - 1:
            out["change"] = change()
    out["window_change"] = change()
    return out


def _gaps(prog: list, ref: list) -> float:
    """The worst relative gap of the checked steps' losses (inf where the
    program has fewer or a non-finite one)."""
    if len(prog) < len(ref) or not all(math.isfinite(p["loss"]) for p in prog):
        return math.inf
    return max(abs(p["loss"] - r["loss"]) / abs(r["loss"]) for p, r in zip(prog, ref))


def check(ctx, state: dict, control: bool = False) -> list[Check]:
    """The comparison; with `control` the reference at TF32 stands in for
    the program."""
    if "reference" not in state:
        state["reference"] = reference_steps(ctx, state, tf32=False)
    ref = state["reference"]
    if control:
        prog = reference_steps(ctx, state, tf32=True)
    else:
        init = torch.load(state["init"], map_location="cpu", weights_only=True)["model"]
        prog = {"losses": state["first_losses"], "window_losses": state.get("window_losses", []),
                "grad1": state["grad1"],
                "change": {n: float((w - init[n].double()).norm()) for n, w in state["weights3"].items()},
                "window_change": {n: float((w.double().cpu() - init[n].double()).norm())
                                  for n, w in state.get("weights_w", {}).items()}}
    med = float(np.median(list(ref["grad1"].values())))
    leaves = [n for n, g in ref["grad1"].items() if g >= NOUGHT_SHARE * med]
    state["leaves_compared"], state["leaves_left_out"] = len(leaves), len(ref["grad1"]) - len(leaves)

    def leaf_gap(key: str) -> float:
        if any(n not in prog[key] for n in leaves):
            return math.inf
        gap, leaf = worst_leaf_gap(prog[key], ref[key], leaves)
        state.setdefault("worst_leaves", {})[key] = [leaf, prog[key][leaf], ref[key][leaf]]
        return gap

    values = {"loss_gap": _gaps(prog["losses"], ref["losses"]), "grad_gap": leaf_gap("grad1"),
              "change_gap": leaf_gap("change"), "window_loss_gap": _gaps(prog["window_losses"], ref["window_losses"]),
              "window_change_gap": leaf_gap("window_change")}
    return [Check(k, v, LIMITS[k]) for k, v in values.items()]
