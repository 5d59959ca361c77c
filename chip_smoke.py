"""Smoke test of the PyTorch port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line) if it
fails:
  1. the card's name and power limit, and which host libraries import;
  2. build every CUDA kernel of the port from `pixelspointspolygons_torch/csrc`
     (one nvcc per source, all started together);
  3. each kernel against its plain PyTorch version on the card, at the shapes
     the main path gives it, with CUDA-event timings and its bound;
  4. the main path: HiSup-image training (HRNetV2-W48, 224 px, head width
     256, batch 16) through the trainer for 4 train steps and 1 val step,
     with every kernel launch counter set to 0 just before and read just
     after; then step time, peak memory, the host loader's time per batch,
     the step cut at its layers with its convolutions' operation rate, and
     the trained model's output on the card against the same model on the
     CPU.
The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# published peaks of one H100 SXM (dense): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per (pixel, valid segment) pair of the AFM: 2 sub, 2 mul,
# 1 add, 1 div, 2 clamp, 2 mul, 2 add, 2 sub (offsets), 2 mul + 1 add
# (distance), 1 compare
AFM_OPS_PER_PAIR = 18

B, L, S = 16, 256, 224
TRAIN_STEPS, VAL_STEPS = 4, 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, launches: int, rounds: int) -> float:
    """Median over `rounds` of the mean time of `launches` back-to-back
    calls, by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per)


def smoke_overrides(num_train: int) -> list[str]:
    return [
        "experiment=hisup_image",
        "dataset=synthetic",
        "run_type=debug",
        f"experiment.dataset.num_train={num_train}",
        "experiment.dataset.num_val=16",
        "experiment.dataset.num_test=16",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "experiment.model.batch_size=16",
        "experiment.model.num_epochs=1",
        "training.save_every=0",
    ]


def phase_host() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    libs = {}
    for mod in ("cv2", "yaml", "PIL"):
        try:
            importlib.import_module(mod)
            libs[mod] = True
        except ImportError:
            libs[mod] = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; host libraries: {libs}", flush=True)
    return smi


def phase_build() -> None:
    from pixelspointspolygons_torch.ops import build

    t0 = time.perf_counter()
    built = build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {sorted(built) or 'all cached'}", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}", flush=True)


def afm_inputs(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """B=16 samples of L=256 segments at 224 px: 12 with the edges of
    synthetic training tiles, 3 with 256 random segments, 1 with none."""
    from pixelspointspolygons_torch.data.loader import build_loader

    loader = build_loader(cfg, "train")
    batch = next(iter(loader))
    lines = np.zeros((B, L, 4), np.float32)
    valid = np.zeros((B, L), bool)
    lines[:12] = batch["edges"][:12]
    valid[:12] = batch["edges_valid"][:12]
    rng = np.random.RandomState(0)
    lines[12:15] = rng.uniform(0, S, (3, L, 4)).astype(np.float32)
    valid[12:15] = True
    dev = torch.device("cuda")
    return torch.from_numpy(lines).to(dev), torch.from_numpy(valid).to(dev)


def phase_afm(cfg) -> dict:
    from pixelspointspolygons_torch.ops.afm import afm, afm_cuda

    lines, valid = afm_inputs(cfg)
    got_map, got_lab = afm_cuda(lines, valid, S, S)
    want_map, want_lab = afm(lines, valid, S, S)
    torch.cuda.synchronize()
    n_bad = int((got_lab != want_lab).sum())
    err = float((got_map - want_map).abs().max())
    # labels exact: same IEEE operations in the same order (--fmad=false);
    # map 1e-5: the kernel's logf and torch's log may differ by an ulp
    # (|map| <= 14, so an ulp is under 1e-6)
    print(f"afm: label mismatches {n_bad}, map max abs err {err:.3g} (tol 1e-5)", flush=True)
    if n_bad:
        fail(f"afm labels differ from the plain version at {n_bad} pixels")
    if not err <= 1e-5:
        fail(f"afm map differs from the plain version by {err}")
    if float(got_map[15].abs().sum()) != 0.0 or int(got_lab[15].abs().sum()) != 0:
        fail("afm: a sample with no valid segment must give zeros")

    ms = cuda_ms(lambda: afm_cuda(lines, valid, S, S), launches=20, rounds=5)
    plain_ms = cuda_ms(lambda: afm(lines, valid, S, S), launches=2, rounds=3)
    pairs = int(valid.sum()) * S * S
    ops = pairs * AFM_OPS_PER_PAIR
    nbytes = lines.numel() * 4 + valid.numel() + B * 2 * S * S * 4 + B * S * S * 4
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((t_ops, "operations"), (t_bytes, "bytes"))
    print(
        f"afm: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{pairs} pixel-segment pairs, {ops/1e9:.3f} GFLOP, {nbytes/1e6:.2f} MB)",
        flush=True,
    )
    return {
        "name": "afm",
        "route": "cuda",
        "source": "pixelspointspolygons_torch/csrc/afm.cu",
        "replaces": "pixelspointspolygons_tpu/ops/afm_pallas.py:74",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the AFM
    }


def phase_train(cfg_overrides: list[str]) -> tuple[dict, dict]:
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS, HiSupTrainer

    cfg = compose(cfg_overrides)
    trainer = HiSupTrainer(cfg)
    torch.cuda.reset_peak_memory_stats()
    afm_cuda.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"afm": afm_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    n_train, n_val = len(trainer.train_loader), len(trainer.val_loader)
    print(
        f"main path: {n_train} train + {n_val} val steps in {wall:.1f} s (set-up included), "
        f"peak memory {peak/2**30:.2f} GiB; launches {launches}",
        flush=True,
    )
    print("history: " + json.dumps(history), flush=True)
    if (n_train, n_val) != (TRAIN_STEPS, VAL_STEPS):
        fail(f"expected {TRAIN_STEPS} train and {VAL_STEPS} val steps, got {n_train} and {n_val}")
    if not all(np.isfinite(v) for k, v in history.items() if k != "epoch"):
        fail(f"non-finite losses: {history}")
    if launches["afm"] != n_train + n_val:
        fail(f"afm launched {launches['afm']} times, expected {n_train + n_val}")
    if not trainer.manager.exists("latest") or not trainer.manager.exists("best_val_loss"):
        fail("trainer wrote no latest/best_val_loss checkpoint")

    # steady state on the same batches (not part of the counted run)
    t = time.perf_counter()
    host = list(trainer.train_loader)
    loader_ms = (time.perf_counter() - t) * 1e3 / len(host)
    batches = list(device_prefetch(host, trainer.device, _DEV_KEYS))
    trainer._train_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    times = []
    for batch in batches:
        t = time.perf_counter()
        trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times)
    t = time.perf_counter()
    trainer._val_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t) * 1e3
    print(f"train step {step_ms:.1f} ms (median of {len(times)}: {[round(x, 1) for x in times]}), "
          f"val step {val_ms:.1f} ms, host loader {loader_ms:.1f} ms per batch", flush=True)
    parts = [step_parts(trainer, batch) for batch in batches]
    breakdown = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    print("train step by layer (ms, median of %d): %s" % (len(parts), json.dumps(breakdown)), flush=True)
    flops = conv_flops(trainer.state.model, batches[0]["images"])
    print(
        f"convolutions: {flops / 1e12:.3f} TFLOP in the forward, about twice that in the backward; "
        f"forward {flops / breakdown['forward'] / 1e9:.1f} TFLOP/s, "
        f"backward {2 * flops / breakdown['backward'] / 1e9:.1f} TFLOP/s "
        f"(FP32 peak {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s, TF32 off)",
        flush=True,
    )
    check_against_cpu(trainer, batches[0])
    return launches, {"step_ms": step_ms, "val_ms": val_ms, "peak_bytes": peak}


def step_parts(trainer, batch: dict) -> dict:
    """One train step cut at its layers by CUDA events on the stream: the
    targets (with the AFM kernel), forward, losses, backward and AdamW. The
    same calls as train/hisup_step.py::make_train_step."""
    from pixelspointspolygons_torch.models.hisup.model import encode_targets, hisup_losses

    state = trainer.state
    weights = {k: float(v) for k, v in trainer.cfg.experiment.model.loss_weights.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    targets = encode_targets(batch, S)
    ev[1].record()
    state.model.train()
    outputs = state.model({"images": batch["images"]})
    ev[2].record()
    total = sum(weights[k] * v for k, v in hisup_losses(outputs, targets).items())
    ev[3].record()
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    ev[4].record()
    state.optimizer.step()
    ev[5].record()
    torch.cuda.synchronize()
    names = ("targets", "forward", "losses", "backward", "optimizer")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def conv_flops(model, images: torch.Tensor) -> int:
    """Operations of the forward's convolutions (2 per multiply-add), from
    the output shapes that a hook on every convolution sees in one forward."""
    total = 0

    def count(mod, args, out):
        nonlocal total
        total += 2 * out.numel() * (mod.in_channels // mod.groups) * math.prod(mod.kernel_size)

    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d))]
    handles = [m.register_forward_hook(count) for m in convs]
    try:
        with torch.no_grad():
            model.eval()({"images": images})
    finally:
        for h in handles:
            h.remove()
    return total


def check_against_cpu(trainer, batch: dict) -> None:
    """The trained model and the targets on the card against the same model
    and batch on the CPU, on one sample (the CPU path is held to the JAX
    package by tests/test_torch_*.py)."""
    import copy

    from pixelspointspolygons_torch.models.hisup.model import encode_targets

    small = {k: v[:1] for k, v in batch.items()}
    cpu_batch = {k: v.cpu() for k, v in small.items()}
    t_gpu = encode_targets(small, S)
    t_cpu = encode_targets(cpu_batch, S)
    for k in ("jloc", "joff"):
        if not torch.equal(t_gpu[k].cpu(), t_cpu[k]):
            fail(f"encode_targets {k} differs between card and CPU")
    afm_err = float((t_gpu["afmap"].cpu() - t_cpu["afmap"]).abs().max())

    model = trainer.state.model.eval()
    cpu_model = copy.deepcopy(model).cpu().eval()
    with torch.no_grad():
        out_gpu = model({"images": small["images"]})
        out_cpu = cpu_model({"images": cpu_batch["images"]})
    worst = 0.0
    for k, v in out_cpu.items():
        g = out_gpu[k].cpu()
        if g.shape != v.shape or not torch.isfinite(g).all():
            fail(f"model output {k}: shape {tuple(g.shape)} or non-finite values")
        worst = max(worst, float((g - v).abs().max() / v.abs().max().clamp(min=1e-6)))
    # float32 on both sides with TF32 off; cuDNN and the CPU sum convolutions
    # in different orders, through HRNet's ~100 layers: 1e-3 relative
    print(f"card vs CPU: afmap max abs err {afm_err:.3g} (tol 1e-5), model outputs max rel err {worst:.3g} (tol 1e-3)",
          flush=True)
    if not afm_err <= 1e-5:
        fail(f"afmap differs between card and CPU by {afm_err}")
    if not worst <= 1e-3:
        fail(f"model output differs between card and CPU by {worst} (relative)")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    os.environ["P3_DATASET_ROOT"] = os.path.join(WORK, "data")
    os.environ["P3_MODEL_ROOT"] = os.path.join(WORK, "outputs")
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import set_tf32

    smi = phase_host()
    print(f"card: {smi}", flush=True)
    set_tf32(False)
    phase_build()
    overrides = smoke_overrides(num_train=TRAIN_STEPS * B)
    afm_row = phase_afm(compose(overrides))
    launches, train = phase_train(overrides)
    afm_row["launches"] = launches["afm"]
    print(f"main path: train step {train['step_ms']:.1f} ms, val step {train['val_ms']:.1f} ms, "
          f"peak {train['peak_bytes']} bytes, card {smi}", flush=True)
    print(json.dumps({"kernels": [afm_row]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
