"""Time what repeatable training costs, path by path, on one card.

Usage (from the repository root, on a machine with a CUDA card):

    python3 repeat_bench.py [--paths NAME,NAME,...] [--out FILE.json]

Every entry point of the port turns the card's ordered operations on
(`device.set_deterministic`: cuDNN's deterministic algorithms,
`torch.use_deterministic_algorithms(True)`, cuBLAS's fixed workspace), and
the port takes ordered forms of the operations that had none: the bilinear
resizes' backward as products with the interpolation matrices
(`layers.InterpolateByProducts`), HiSup's cross-entropy as JAX's
log_softmax, one-hot and mean, and the PillarFeatureNet's gather and
segment-max backwards as the run-sums kernel (`ops/run_sums.py`,
`csrc/run_sums.cu`). For each training path (chip_smoke.py phase 27's, and
the LiDAR and fusion steps of its phase 19) this script builds the trainer
at full width and batch 16 (hisup_fusion from the cache with remat at 8, as
phase 27 takes it) and, from one snapshot of its weights, optimizer and
schedule, runs REPEAT_STEPS steps twice under each route. Each route is a
process of its own over all the paths, started in turns (ordered, parent,
unflagged, parent, ordered), so that each route has the process-wide
settings it names, cuBLAS's workspace variable among them (cuBLAS reads it
once per process):

- `ordered`: the port as it is, its entry points' set-up included;
- `parent`: the route before the change, as the parent's entry points ran
  it: no `set_deterministic` (no deterministic algorithms, cuDNN free to
  choose, `CUBLAS_WORKSPACE_CONFIG` unset), and swapped in by this script
  alone `F.interpolate`'s own backward, `F.cross_entropy`, autograd's
  backward of `pooled[pillar_id]` and of `scatter_reduce(..., "amax")`;
- `unflagged`: the port's forms without the set-up, which leaves cuDNN's
  and cuBLAS's own choices as the only unordered operations.

For each path and route it prints the median step time (host clock to a
synchronize; each turn's first step left out), the peak memory, whether
the two runs gave the same bits (losses, first-step gradients,
parameters, buffers, optimizer state) and, where they did not, the first
module in forward order whose gradient differs and the largest gap of the
first step's gradients relative to their largest magnitude. An error
inside a route is printed and the path goes on. Then the card's name and
power limit, and one JSON object as its last line.

`--costs` measures instead what each part of the set-up costs the host:
- in child processes with `CUBLAS_WORKSPACE_CONFIG` unset and set to
  `:4096:8`, the flags off and on: the host µs of a small float32 and
  bfloat16 `addmm`, `mm` and batched product (2,000 back-to-back calls to
  a synchronize), and a seeded full-width Pix2Poly-image's greedy decode
  of 16 tiles, ms a step over 384 steps, as the loop and replayed from its
  CUDA graph;
- in this process, under the set-up, the HiSup-image train step at both
  dtypes and Pix2Poly-image's at float32 with PyTorch's NaN fill of new
  tensors on and off, in turns (on, off, off, on), medians of 2 steps.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import itertools
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUTES = ("ordered", "parent", "unflagged", "parent", "ordered")
EXTRA_PATHS = ("p2p_lidar", "hisup_fusion", "ffl_lidar", "ffl_fusion")


def overrides(cs, path: str) -> list[str]:
    """The config of a training path, as chip_smoke.py's phases compose it."""
    f32 = "host.compute_dtype=float32"
    img = lambda exp: cs.smoke_overrides(cs.TRAIN_STEPS * cs.B, exp)  # noqa: E731
    table = {
        "hisup_image_float32": img("hisup_image") + [f32],
        "hisup_image_bfloat16": img("hisup_image") + ["host.compute_dtype=bfloat16"],
        "p2p_image_float32": img("p2p_image") + [f32],
        "p2p_image_bfloat16": img("p2p_image") + ["host.compute_dtype=bfloat16"],
        "ffl_image_float32": img("ffl_image") + [f32],
        "ffl_image_cache_float32": img("ffl_image") + [f32, "training.device_cache=true"],
        "ffl_image_cache_bfloat16": img("ffl_image") + ["host.compute_dtype=bfloat16", "training.device_cache=true"],
        "hisup_lidar": cs.lidar_overrides("hisup_lidar") + [f32],
        "p2p_fusion": cs.lidar_overrides("p2p_fusion") + [f32],
        "hisup_fusion_cache_remat": cs.lidar_overrides("hisup_fusion") + [
            f32, "training.remat=true", "training.device_cache=true",
            f"experiment.model.batch_size={cs.REPEAT_FUSION_BATCH}",
            f"run_type.train_subset={cs.REPEAT_STEPS * cs.REPEAT_FUSION_BATCH}"],
        "hisup_image_ddp": img("hisup_image") + [f32],
        "ffl_unetresnet101": img("ffl_image") + ["encoder=unetresnet101", f"experiment.encoder.in_size={cs.S}", f32],
        "ffl_convnext": img("ffl_image") + ["encoder=convnext", f"experiment.encoder.in_size={cs.S}", f32],
        "hisup_lidar_dense": cs.smoke_overrides(cs.GRID_TRAIN_STEPS * cs.B, "hisup_lidar") + ["encoder=pointpillars",
                                                                                              f32],
        **{exp: cs.lidar_overrides(exp) + [f32] for exp in EXTRA_PATHS},
    }
    return table[path]


def setup(cs, path: str):
    """(trainer, batches(), the step's extra arguments) of a path."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.train import trainer_ffl, trainer_hisup, trainer_pix2poly

    families = {"hisup": (trainer_hisup.HiSupTrainer, trainer_hisup._DEV_KEYS),
                "pix2poly": (trainer_pix2poly.Pix2PolyTrainer, trainer_pix2poly._DEV_KEYS),
                "ffl": (trainer_ffl.FFLTrainer, trainer_ffl.FFL_BATCH_KEYS)}
    cfg = compose(overrides(cs, path))
    name = cfg.experiment.model.name
    cls, keys = families[name]
    trainer = cls(cfg, device=cs.CARD)
    trainer.generator = torch.Generator(device=cs.CARD).manual_seed(int(cfg.get("seed", 42)))
    trainer.setup()
    if trainer.cache:
        def batches():
            return list(itertools.islice(trainer.epoch_batches("train", 0, keys), cs.REPEAT_STEPS))
    else:
        host = list(itertools.islice(iter(trainer.train_loader), cs.REPEAT_STEPS))
        fixed = list(device_prefetch(host, cs.CARD, keys))

        def batches():
            return fixed
    args = (trainer._weights_for_epoch(0), None) if name == "ffl" else (trainer.generator,) if name == "pix2poly" \
        else ()
    return trainer, batches, args


def set_route(cs, name: str) -> None:
    """Set this process up for one route (module docstring)."""
    import torch.nn.functional as F

    from pixelspointspolygons_torch.device import set_deterministic, set_tf32
    from pixelspointspolygons_torch.models import layers, pointpillars
    from pixelspointspolygons_torch.models.hisup import model as hisup_model
    from pixelspointspolygons_torch.ops import segment, voxelize

    set_tf32(False)
    if name == "ordered":
        set_deterministic(cs.CARD)
        cs.check_deterministic("repeat_bench, the ordered route")
    else:  # the trainers' constructors call the set-up: not in these routes
        from pixelspointspolygons_torch.predict import predictor
        from pixelspointspolygons_torch.train import trainer

        trainer.set_deterministic = predictor.set_deterministic = lambda device: None
        print(f"repeat_bench, the {name} route: {json.dumps(cs.deterministic_flags())}", flush=True)
    if name == "parent":
        layers.InterpolateByProducts.apply = lambda x, rows, cols, corners: F.interpolate(
            x, size=(rows.shape[0], cols.shape[0]), mode="bilinear", align_corners=corners)
        hisup_model.ce_loss_2d = lambda logits, labels: F.cross_entropy(logits.float(), labels.long())
        pointpillars.gather_rows = lambda table, ids, samples: table[ids]
        voxelize.segment_max_rows = lambda x, ids, n, samples: segment.segment_max(x, ids, n)


def timed_runs(cs, trainer, batches, args: tuple, snap: dict) -> dict:
    """Two runs of REPEAT_STEPS steps from `snap`, each step timed."""
    state, model = trainer.state, trainer.state.model
    seed = int(trainer.cfg.get("seed", 42))
    runs, times, order = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for run in range(2):
        model.load_state_dict(snap["model"])
        state.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))
        state.scheduler.load_state_dict(snap["scheduler"])
        state.step = snap["step"]
        torch.manual_seed(seed)
        trainer.generator.manual_seed(seed)
        hooks = cs.number_calls(model, order) if run == 0 else []
        data = batches()
        losses, grads = [], {}
        for s in range(cs.REPEAT_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = trainer._train_step(state, data[s % len(data)], *args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append({k: v.detach().clone() for k, v in metrics.items()})
            if s == 0:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
        for h in hooks:
            h.remove()
        optim = {f"{i}.{k}": v.detach().clone() for i, st in state.optimizer.state_dict()["state"].items()
                 for k, v in st.items() if isinstance(v, torch.Tensor)}
        runs.append({"losses": losses, "grads": grads, "optimizer": optim,
                     "state": {k: v.detach().clone() for k, v in model.state_dict().items()}})
    peak = torch.cuda.max_memory_allocated()
    _, differ, _ = cs.runs_differ(runs[0], runs[1])
    same = not differ
    g0, g1 = runs[0]["grads"], runs[1]["grads"]
    gap = max(((g0[n].double() - g1[n].double()).abs().max() / g0[n].double().abs().max().clamp(min=1e-30)).item()
              for n in g0)
    return {"step_ms": times[1:], "median_ms": statistics.median(times[1:]), "peak_bytes": peak, "repeat": same,
            "grad_gap": gap, "first_module": None if same else cs.first_differing_module(order, g0, g1),
            "first_leaf": differ[0] if differ else None}


def route_turn(cs, path: str) -> dict:
    """One turn of a path in this process's route: the trainer built, two
    timed runs from one snapshot, the trainer freed."""
    trainer, batches, args = setup(cs, path)
    state, model = trainer.state, trainer.state.model
    snap = {"model": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()),
            "scheduler": copy.deepcopy(state.scheduler.state_dict()), "step": state.step}
    group = cs.world_of_one(cs.CARD) if path == "hisup_image_ddp" else contextlib.nullcontext()
    try:
        with group:
            if path == "hisup_image_ddp":
                state.wrap()
            try:
                return timed_runs(cs, trainer, batches, args, snap)
            finally:
                cs.unwrap(state)
    except Exception as e:  # a route that fails is reported; the next goes on
        torch.cuda.synchronize()
        return {"error": f"{type(e).__name__}: {str(e).splitlines()[0][:400]}"}
    finally:
        del trainer, batches, snap
        torch.cuda.empty_cache()


def summarize(path: str, turns: dict) -> dict:
    """A path's medians, peaks and repeats over its turns in each route."""
    summary = {}
    for name, by_turn in turns.items():
        ok = [t for t in by_turn if "error" not in t]
        summary[name] = {"median_ms": statistics.median(x for t in ok for x in t["step_ms"]) if ok else None,
                         "peak_bytes": max((t["peak_bytes"] for t in ok), default=None),
                         "repeat": all(t["repeat"] for t in ok) if ok else None,
                         "grad_gap": max((t["grad_gap"] for t in ok), default=None),
                         "first_module": next((t["first_module"] for t in ok if t["first_module"]), None),
                         "errors": [t["error"] for t in by_turn if "error" in t]}
    o, p = summary["ordered"]["median_ms"], summary["parent"]["median_ms"]
    slower = f"{100 * (o / p - 1):+.1f} %" if o and p else "n/a"
    print(f"{path}: ordered {o} ms, parent {p} ms ({slower}); peak ordered {summary['ordered']['peak_bytes']}, parent "
          f"{summary['parent']['peak_bytes']} bytes; repeats: ordered {summary['ordered']['repeat']}, parent "
          f"{summary['parent']['repeat']} (first module {summary['parent']['first_module']}, gap "
          f"{summary['parent']['grad_gap']}), unflagged {summary['unflagged']['repeat']} (first module "
          f"{summary['unflagged']['first_module']}, gap {summary['unflagged']['grad_gap']})", flush=True)
    return summary


def run_routes(paths: list[str]) -> dict:
    """Each route of ROUTES in a child process of its own, in turns, with
    `CUBLAS_WORKSPACE_CONFIG` unset (the ordered route's set-up sets it);
    returns each path's summary."""
    import subprocess
    import tempfile

    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    turns = {path: {} for path in paths}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for i, name in enumerate(ROUTES):
            out = os.path.join(tmp, f"turn{i}.json")
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--route", name, "--paths", ",".join(paths),
                                "--out", out], env=env, cwd=ROOT)
            if r.returncode:
                sys.exit(f"repeat_bench: the {name} route's process failed with exit code {r.returncode}")
            with open(out) as f:
                got = json.load(f)
            for path in paths:
                print(f"{path} turn {i} ({name}): {json.dumps(got[path])}", flush=True)
                turns[path].setdefault(name, []).append(got[path])
    return {path: summarize(path, turns[path]) for path in paths}


def host_costs_child(flags: str) -> dict:
    """One child of `--costs`: the products' host µs and the decode's ms a
    step in this process's cuBLAS setting, the flags "on" or "off"."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import set_tf32
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer, build_pix2poly
    from pixelspointspolygons_torch.models.pix2poly.model import _greedy_decode

    set_tf32(False)
    torch.use_deterministic_algorithms(flags == "on")
    torch.backends.cudnn.deterministic = flags == "on"
    torch.utils.deterministic.fill_uninitialized_memory = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG"), "flags": flags}
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn(16, 256, device=dev, generator=gen).to(dtype)
        w = torch.randn(256, 256, device=dev, generator=gen).to(dtype)
        b = torch.randn(256, device=dev, generator=gen).to(dtype)
        q, k = a.reshape(16, 8, 1, 32), torch.randn(16, 8, 32, 385, device=dev, generator=gen).to(dtype)
        for name, fn in (("addmm", lambda: torch.addmm(b, a, w)), ("mm", lambda: torch.mm(a, w)),
                         ("bmm", lambda: torch.matmul(q, k))):
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            out[f"{name}_{str(dtype)[6:]}_us"] = (time.perf_counter() - t) / 2000 * 1e6
    cfg = compose(["experiment=p2p_image", "dataset=synthetic", "run_type=debug"])
    tok = Tokenizer(cfg)
    model = build_pix2poly(cfg, tok, device=dev, generator=gen).eval()
    with torch.inference_mode():
        enc = model.encode({"images": torch.rand(16, 224, 224, 3, device=dev, generator=gen)})
        for graph in (False, True):
            _greedy_decode(model, enc, tok.BOS_code, 8, None, capture=graph)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _greedy_decode(model, enc, tok.BOS_code, 384, None, capture=graph)
            torch.cuda.synchronize()
            out[f"decode_{'graph' if graph else 'loop'}_ms_per_step"] = (time.perf_counter() - t) * 1e3 / 384
    return out


def host_costs(cs) -> dict:
    """`--costs` (module docstring)."""
    import subprocess

    children = []
    for env, flags in ((None, "off"), (":4096:8", "off"), (":4096:8", "on"), (None, "off"), (":4096:8", "on")):
        e = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
        if env:
            e["CUBLAS_WORKSPACE_CONFIG"] = env
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", flags], env=e, cwd=ROOT,
                           capture_output=True, text=True)
        if r.returncode:
            sys.exit(f"--costs child failed:\n{r.stderr[-3000:]}")
        children.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(f"host costs: {json.dumps(children[-1])}", flush=True)
    fills = {}
    for path in ("hisup_image_bfloat16", "hisup_image_float32", "p2p_image_float32"):
        trainer, batches, args = setup(cs, path)
        data = batches()
        for fill in (True, False, False, True):
            torch.utils.deterministic.fill_uninitialized_memory = fill
            times = []
            for s in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainer._train_step(trainer.state, data[s % len(data)], *args)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            fills.setdefault(path, {}).setdefault("fill" if fill else "no_fill", []).append(
                statistics.median(times[1:]))
        torch.utils.deterministic.fill_uninitialized_memory = False
        print(f"host costs, {path} step ms with and without the NaN fill, in turns: {json.dumps(fills[path])}",
              flush=True)
        del trainer, batches, data
        torch.cuda.empty_cache()
    return {"cublas": children, "fill": fills}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--paths", default=None, help="comma-separated paths (default: all)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--costs", action="store_true", help="the set-up's host costs (module docstring)")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--route", default=None, choices=sorted(set(ROUTES)), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on the card")
    sys.path.insert(0, ROOT)
    if args.child:
        print(json.dumps(host_costs_child(args.child)), flush=True)
        return
    import chip_smoke as cs

    # a data and model root of its own: chip_smoke.py's phases size their
    # splits themselves
    os.environ["P3_DATASET_ROOT"] = os.path.join(cs.WORK, "repeat_bench", "data")
    os.environ["P3_MODEL_ROOT"] = os.path.join(cs.WORK, "repeat_bench", "outputs")
    paths = args.paths.split(",") if args.paths else list(cs.TRAIN_REPEAT_PATHS) + list(EXTRA_PATHS)
    if args.route:
        set_route(cs, args.route)
        turns = {path: route_turn(cs, path) for path in paths}
        print(f"repeat_bench, the {args.route} route after its paths: {json.dumps(cs.deterministic_flags())}",
              flush=True)
        with open(args.out, "w") as f:
            json.dump(turns, f)
        return
    smi = cs.phase_host()
    if args.costs:
        from pixelspointspolygons_torch.device import set_deterministic, set_tf32

        set_deterministic(cs.CARD)
        set_tf32(False)
        cs.check_deterministic("repeat_bench --costs")
        line = json.dumps({"card": smi, "costs": host_costs(cs)})
    else:
        t0 = time.perf_counter()
        results = run_routes(paths)
        print(f"repeat_bench: {len(paths)} paths in {time.perf_counter() - t0:.1f} s; card {smi}", flush=True)
        line = json.dumps({"card": smi, "routes": ROUTES, "steps": cs.REPEAT_STEPS, "paths": results})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(smi, flush=True)
    print(line, flush=True)


if __name__ == "__main__":
    main()
