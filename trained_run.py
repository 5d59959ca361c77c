"""Train a model of the port from scratch on the card through its entry
points, then score the val split as `scripts/round_eval.sh` does.

Usage (from the repository root, on a machine with a CUDA card):

    python3 trained_run.py ffl --epochs 65 [--out FILE.json] [override ...]
    python3 trained_run.py hisup --epochs 100 [--out FILE.json] [override ...]

Trains `experiment=ffl_image` or `hisup_image` with `dataset=synthetic
run_type=release experiment.model.num_epochs=N` through `cli.train`'s
`main` (float32 unless `host.compute_dtype=bfloat16` is given), in
`build/trained_run/` (`P3_DATASET_ROOT`, `P3_MODEL_ROOT`), then predicts
the val split from `best_val_iou` through `cli.predict`'s `main` with the
round's `evaluation.modes`. For FFL it also scores, through `cli.evaluate`,
the ACM's polygons at each of its simplification tolerances (the config
scores tolerance 1, `acm_method.eval_tolerance`).

Prints one line per epoch (every loss term's mean, the val loss, the LR of
the epoch's last step, FFL's loss weights, the val IoU and C-IoU where the
val pass ran, wall seconds, peak device memory, AFM launches), the SHA-256
of the `best_val_iou` checkpoint's model and optimizer tensors (two runs
from one seed give the same one: training repeats its bits on the card),
then the metric row, the card's name and power limit, and writes all of it as JSON
to `--out` (default `build/trained_run/trained_<family>.json`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "trained_run")
EXPERIMENT = {"ffl": "ffl_image", "hisup": "hisup_image"}
# the modes `scripts/round_eval.sh` scores the val split with
EVAL_MODES = "evaluation.modes=[iou,subset_iou,coco,boundary-coco,polis,chamfer,hausdorff,mta,topdig,juncs,stats]"
# the columns of the round's table of trained results
ROW_KEYS = ("IoU", "C-IoU", "NR", "AP", "AP50", "polis", "mta")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def record_epochs(trainer_cls, epochs: list[dict], trainers: list | None = None):
    """While open, every `trainer_cls` run appends one dict per epoch to
    `epochs`: the trainer's own history (every loss term's mean, the val
    loss, the val IoU), the LR that each train step of the epoch used (read
    from the optimizer before the step), the loss weights passed to the
    steps (FFL), the val pass's IoU and C-IoU, the AFM launches, the peak
    device memory and the wall seconds from the epoch's first batch to
    its log line; and, with `trainers`, each trainer once set up. Nothing
    of the run changes."""
    import torch

    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.utils import experiment_log

    module = sys.modules[trainer_cls.__module__]
    cuda = torch.cuda.is_available()
    current: dict = {}
    saved = {name: getattr(trainer_cls, name) for name in ("setup", "train_one_epoch", "predict_and_eval")}
    saved_iou, saved_log = module.compute_iou_ciou, experiment_log.RunLogger.log

    def setup(self):
        saved["setup"](self)
        if trainers is not None:
            trainers.append(self)
        step = self._train_step

        def recorded(state, batch, *args):
            current.setdefault("lrs", []).append(float(state.optimizer.param_groups[0]["lr"]))
            if args and isinstance(args[0], dict):
                current.setdefault("weights", []).append(dict(args[0]))
            return step(state, batch, *args)

        self._train_step = recorded

    def train_one_epoch(self, epoch):
        current.clear()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        current.update(epoch=epoch, t0=time.perf_counter(), afm0=afm_cuda.launches)
        out = saved["train_one_epoch"](self, epoch)
        current["step"] = int(self.state.step)
        return out

    def predict_and_eval(self, epoch):
        t = time.perf_counter()
        afm0 = afm_cuda.launches
        iou = saved["predict_and_eval"](self, epoch)
        current["val_pass_s"] = time.perf_counter() - t
        current["val_pass_afm"] = afm_cuda.launches - afm0
        return iou

    def compute_iou_ciou(*args, **kwargs):
        results = saved_iou(*args, **kwargs)
        current["val_ciou"] = float(results["C-IoU"])
        return results

    def log(self, metrics, step=None):
        saved_log(self, metrics, step)
        if "t0" not in current:
            return
        if cuda:
            torch.cuda.synchronize()
        lrs, weights = current.get("lrs", []), current.get("weights", [])
        rec = {**{k: float(v) for k, v in metrics.items()}, "epoch": current["epoch"], "step": current["step"],
               "steps": len(lrs), "lr_first": lrs[0] if lrs else None, "lr_last": lrs[-1] if lrs else None,
               "lrs": lrs, "weights": weights[-1] if weights else None,
               "weights_constant": all(w == weights[0] for w in weights),
               "afm_launches": afm_cuda.launches - current["afm0"],
               "wall_s": time.perf_counter() - current["t0"]}
        for k in ("val_ciou", "val_pass_s", "val_pass_afm"):
            if k in current:
                rec[k] = current[k]
        if cuda:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            rec["allocated_bytes"] = torch.cuda.memory_allocated()
        epochs.append(rec)
        current.clear()

    for name, fn in (("setup", setup), ("train_one_epoch", train_one_epoch), ("predict_and_eval", predict_and_eval)):
        setattr(trainer_cls, name, fn)
    module.compute_iou_ciou = compute_iou_ciou
    experiment_log.RunLogger.log = log
    try:
        yield epochs
    finally:
        for name, fn in saved.items():
            setattr(trainer_cls, name, fn)
        module.compute_iou_ciou = saved_iou
        experiment_log.RunLogger.log = saved_log


def checkpoint_digest(path: str) -> str:
    """SHA-256 over a checkpoint's model and optimizer tensors (name,
    dtype, shape and bytes, in sorted order) and its epoch: two runs that
    wrote the same bits give the same digest."""
    import hashlib

    import torch

    payload = torch.load(path, map_location="cpu", weights_only=True)
    h = hashlib.sha256(str(payload.get("epoch")).encode())

    def walk(prefix: str, x) -> None:
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(f"{prefix}.{k}", x[k])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}.{i}", v)
        elif isinstance(x, torch.Tensor):
            h.update(f"{prefix}:{x.dtype}:{tuple(x.shape)}".encode())
            h.update(x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(f"{prefix}={x!r}".encode())

    walk("model", payload["model"])
    walk("optimizer", payload["optimizer"])
    return h.hexdigest()


def epoch_line(rec: dict) -> str:
    """One epoch's record on one line."""
    skip = {"epoch", "step", "steps", "lrs", "lr_first", "lr_last", "weights", "weights_constant", "wall_s",
            "afm_launches", "peak_bytes", "allocated_bytes", "val_ciou", "val_pass_s", "val_pass_afm"}
    terms = " ".join(f"{k}={v:.5f}" for k, v in rec.items() if k not in skip)
    line = (f"epoch {rec['epoch']}: {terms}; steps {rec['steps']} (to step {rec['step']}), "
            f"lr at the last step {rec['lr_last']!r}")
    if rec.get("weights"):
        line += f", weights {json.dumps(rec['weights'])}"
    if "val_ciou" in rec:
        line += f"; val pass {rec['val_pass_s']:.1f} s, C-IoU {rec['val_ciou']:.4f}"
    line += f"; {rec['wall_s']:.2f} s, afm launches {rec['afm_launches']}"
    if "peak_bytes" in rec:
        line += f", peak {rec['peak_bytes'] / 2**30:.2f} GiB, allocated at its end {rec['allocated_bytes'] / 2**30:.2f}"
    return line


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("family", choices=sorted(EXPERIMENT))
    parser.add_argument("--epochs", type=int, required=True)
    parser.add_argument("--out", default=None)
    args, overrides = parser.parse_known_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("trained_run.py trains on the card: no CUDA device")
    os.environ.setdefault("P3_DATASET_ROOT", os.path.join(WORK, "data"))
    os.environ.setdefault("P3_MODEL_ROOT", os.path.join(WORK, "outputs"))
    from pixelspointspolygons_torch.cli import evaluate as cli_evaluate
    from pixelspointspolygons_torch.cli import predict as cli_predict
    from pixelspointspolygons_torch.cli import train as cli_train
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import set_deterministic
    from pixelspointspolygons_torch.ops.afm import afm_cuda

    set_deterministic("cuda")

    if args.family == "ffl":
        from pixelspointspolygons_torch.train.trainer_ffl import FFLTrainer as trainer_cls
    else:
        from pixelspointspolygons_torch.train.trainer_hisup import HiSupTrainer as trainer_cls

    smi = card_line()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    base = [f"experiment={EXPERIMENT[args.family]}", "dataset=synthetic", "run_type=release",
            f"experiment.model.num_epochs={args.epochs}", *overrides]
    epochs: list[dict] = []
    t0 = time.perf_counter()
    with record_epochs(trainer_cls, epochs):
        cli_train.main(base)
    train_s = time.perf_counter() - t0
    for rec in epochs:
        print(epoch_line(rec), flush=True)
    out = {"family": args.family, "card": smi, "overrides": base, "train_s": train_s, "epochs": epochs}
    best = os.path.join(compose(base).output_dir, "checkpoints", "best_val_iou.pt")
    out["best_val_iou_sha256"] = checkpoint_digest(best) if os.path.isfile(best) else None
    print(f"best_val_iou checkpoint: model and optimizer SHA-256 {out['best_val_iou_sha256']}", flush=True)
    afm_cuda.launches = 0
    t = time.perf_counter()
    results = cli_predict.main(base + ["evaluation=val", "checkpoint=best_val_iou", EVAL_MODES])
    out.update(predict_s=time.perf_counter() - t, predict_afm=afm_cuda.launches,
               results={k: float(v) for k, v in results.items() if isinstance(v, (int, float))})
    row = {k: out["results"].get(k) for k in ROW_KEYS}
    print(f"val row ({args.family}, best_val_iou): {json.dumps(row)}; prediction {out['predict_s']:.1f} s, "
          f"afm launches {out['predict_afm']}", flush=True)
    if args.family == "ffl":
        pred_file = compose(base + ["evaluation=val", "checkpoint=best_val_iou"]).evaluation.pred_file
        out["by_tolerance"] = {}
        for tol in (1, 2, 3):
            path = pred_file.replace(".json", f"_acm.tol_{tol}.json")
            res = cli_evaluate.main(base + ["evaluation=val", "checkpoint=best_val_iou", EVAL_MODES,
                                            f"evaluation.pred_file={path}"])
            out["by_tolerance"][tol] = {k: float(res[k]) for k in ROW_KEYS if k in res}
            print(f"val row (ffl, best_val_iou, ACM tolerance {tol}): {json.dumps(out['by_tolerance'][tol])}",
                  flush=True)
    curve = [(r["epoch"], round(r["val_iou"], 4)) for r in epochs if "val_iou" in r]
    print(f"val curve: {curve}; trained {len(epochs)} epochs in {train_s:.1f} s; card {smi}", flush=True)
    path = args.out or os.path.join(WORK, f"trained_{args.family}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
