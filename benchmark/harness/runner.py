"""One run of one cell: set-up (inputs and weights from the seed, the
program built and warmed up on the cell's shapes), the measured window, an
optional traced stretch after it, the program's state freed, the
comparison with the reference, and the result line.

The mode's driver (`drivers/<mode>.py`) provides `setup(ctx)`,
`window(ctx, state, seconds)`, `traced(ctx, state)`, `release(state)` and
`check(ctx, state)`; the metric readers (`metrics/<name>.py`) turn what
they leave in `data` into numbers."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import sys
import tempfile
import time

from . import guard
from .spec import ROOT, cell_spec, driver, load_benchmark, reader


@dataclasses.dataclass
class Check:
    """One number compared with its limit; it passes at or under the limit.
    A reading with no limit is printed and not compared."""

    name: str
    value: float
    limit: float | None

    @property
    def ok(self) -> bool:
        return self.limit is None or (math.isfinite(self.value) and self.value <= self.limit)


@dataclasses.dataclass
class Context:
    spec: dict
    seed: int
    device: str = "cuda"
    fault: str | None = None  # a fault planted in the timed path (tests only)
    work: str = ""
    phases: dict = dataclasses.field(default_factory=dict)
    _t: float = dataclasses.field(default_factory=time.perf_counter)

    def phase(self, name: str) -> None:
        """Record the seconds since the previous mark under `name`."""
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    @property
    def sizes(self) -> dict:
        return self.spec["config"]["sizes"]

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]

    def overrides(self) -> list[str]:
        """The port's config: the configuration's and the mix's overrides,
        the tiles of each of the mix's splits, the data and model roots
        under the run's work directory, the seed."""
        c = self.spec["config"]
        return ([f"experiment={c['experiment']}", *c.get("overrides", []), *self.traffic.get("overrides", []),
                 *(f"experiment.dataset.num_{k}={v}" for k, v in self.traffic["splits"].items()),
                 f"host.dataset_root={os.path.join(self.work, 'data')}",
                 f"host.model_root={os.path.join(self.work, 'models')}", f"seed={program_seed(self.seed)}"])


def program_seed(seed: int) -> int:
    """The seed the program's config takes: the run's seed folded into 31
    bits, so that numpy's seeds of every epoch and item stay in range."""
    return seed % (2**31 - 2**20)


def work_dir(cell: str) -> str:
    """A fixed directory under TMPDIR for the run's inputs and outputs."""
    return os.path.join(tempfile.gettempdir(), "p3bench", cell)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
             fault: str | None = None) -> tuple[dict, list[Check]]:
    """The result line's object (without the checks) and the checks."""
    import torch

    cell = spec["cell"]["name"]
    ctx = Context(spec, seed, device, fault, work_dir(cell))
    shutil.rmtree(ctx.work, ignore_errors=True)
    os.makedirs(ctx.work)
    drv = driver(spec["traffic"]["mode"], spec["bench_dir"])
    on_card = torch.device(device).type == "cuda"
    try:
        state = drv.setup(ctx)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        win = drv.window(ctx, state, seconds)
        window_peak = torch.cuda.max_memory_allocated() if on_card else None
        t_window = time.perf_counter()
        tr = drv.traced(ctx, state) if trace else None
        run_peak = max(state.get("setup_peak", 0), window_peak or 0, torch.cuda.max_memory_allocated()) \
            if on_card else None
        t_traced = time.perf_counter()
        drv.release(state)
        checks = drv.check(ctx, state)
        print("p3bench: set-up phases " + ", ".join(f"{k} {v:.2f} s" for k, v in ctx.phases.items()),
              file=sys.stderr)
        print(f"p3bench: set-up {setup_s:.2f} s, window {win['seconds']:.2f} s, traced stretch and its reading "
              f"{t_traced - t_window:.2f} s, comparison {time.perf_counter() - t_traced:.2f} s", file=sys.stderr)
        if tr is not None and tr["window_s"] > 0:
            _print_idle(tr, win)
    finally:
        shutil.rmtree(ctx.work, ignore_errors=True)
    data = {"setup_s": setup_s, "window": win, "trace": tr, "sizes": ctx.sizes, "window_peak_bytes": window_peak,
            "traffic": ctx.traffic}
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        v = reader(m["name"], spec["bench_dir"])(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(spec["cell"]["chips"]), "memory_peak_bytes": run_peak}
    result = {"correct": all(c.ok for c in checks) and win["failed"] == 0, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    return result, checks


def _print_idle(tr: dict, win: dict) -> None:
    """The traced stretch's idle share beside the window's, estimated from
    the traced busy seconds a unit of work (a step, a batch) times the
    window's units over its seconds, and the profiler's records."""
    units = win.get("steps") or len(win.get("batch_times") or [])
    untraced = 100.0 * (1.0 - tr["busy_s"] / tr["units"] * units / win["seconds"])
    print(f"p3bench: device idle {100.0 * (1.0 - tr['busy_s'] / tr['window_s']):.2f} % over the traced "
          f"{tr['window_s']:.3f} s ({tr['units']} units, {tr['device_events']} device records, busy "
          f"{tr['busy_s']:.3f} s, CUDA events {tr.get('events_busy_s')}); {untraced:.2f} % in the window at that "
          "busy time a unit", file=sys.stderr)


def main(argv: list[str], t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = cell_spec(load_benchmark(ROOT), args.workload)
    guard.fix_cache_dirs(ROOT)
    try:
        guard.require_chips(int(spec["cell"]["chips"]))
    except guard.NoChip as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    result, checks = run_cell(spec, args.seed, args.seconds, bool(args.trace), t_start)
    bad = guard.forbidden_modules()
    if bad:
        print(f"no result: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    compared = [c for c in checks if c.limit is not None]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    for c in checks:
        if c.limit is None:
            print(f"reading {c.name} = {c.value!r} (not compared)", file=sys.stderr)
    for c in compared:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
