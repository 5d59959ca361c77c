"""The readings that the correctness limits are set from, several seeds in
one process (the benchmark's own runs never run this):

    python benchmark/control.py --workload <cell> --seeds 11 12 13 [--fault NAME]

For each seed: the cell's set-up and the shortest window (one pass, one
epoch), then each compared number of the program against the reference,
and of the control against the reference: the reference computed with TF32
products, the nearest precision below the configuration's float32, in the
program's place. With `--fault` the program runs with that fault planted
instead (`half_batch`, `token`, `decode_token`, `unchanged`) and no control
is read. One JSON line a seed."""

import argparse
import gc
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import guard  # noqa: E402
from benchmark.harness.runner import Context, work_dir  # noqa: E402
from benchmark.harness.spec import ROOT, cell_spec, driver, load_benchmark  # noqa: E402


def readings(spec: dict, seed: int, fault: str | None, device: str = "cuda") -> dict:
    import torch

    ctx = Context(spec, seed, device, fault, work_dir(spec["cell"]["name"]))
    shutil.rmtree(ctx.work, ignore_errors=True)
    os.makedirs(ctx.work)
    drv = driver(spec["traffic"]["mode"], spec["bench_dir"])
    try:
        state = drv.setup(ctx)
        drv.window(ctx, state, 0.0)
        drv.release(state)
        out = {"seed": seed, "fault": fault, "program": {c.name: c.value for c in drv.check(ctx, state)}}
        if "worst_leaves" in state:
            out["program_worst_leaves"] = state.pop("worst_leaves")
        if fault is None:
            out["control"] = {c.name: c.value for c in drv.check(ctx, state, control=True)}
        for key in ("leaves_compared", "leaves_left_out"):
            if key in state:
                out[key] = state[key]
    finally:
        shutil.rmtree(ctx.work, ignore_errors=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    spec = cell_spec(load_benchmark(ROOT), args.workload)
    guard.fix_cache_dirs(ROOT)
    guard.require_chips(int(spec["cell"]["chips"]))
    for seed in args.seeds:
        print(json.dumps(readings(spec, seed, args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
