"""Run chip_smoke.py with a stack sampler on its main thread, and write where
its time went as JSON: seconds by chip_smoke function (inclusive), by its
innermost line, by its call chain, by the innermost frame anywhere and by
the innermost frame inside the port's package.

Usage (from the repository root, on a machine with a CUDA card):

    python3 smoke_sampler.py [OUT.json]

OUT.json defaults to build/chip_smoke_samples.json. The sampler wakes every
PERIOD_S seconds and reads the main thread's stack, so the script runs as
it would alone (its processes spawned with phase 22 are not sampled). A
sample counts PERIOD_S seconds; the counts are written when the run ends,
whether it passes or fails.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import runpy
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(ROOT, "chip_smoke.py")
PACKAGE = "pixelspointspolygons_torch" + os.sep
PERIOD_S = 0.25
TOP = 300


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT, "build", "chip_smoke_samples.json")
    main_id = threading.main_thread().ident
    counts = {k: collections.Counter() for k in ("by_func", "by_line", "by_chain", "by_leaf", "by_package")}
    done = threading.Event()

    def sample() -> None:
        while not done.wait(PERIOD_S):
            frame = sys._current_frames().get(main_id)
            chain, leaf, package = [], None, None
            while frame is not None:
                code = frame.f_code
                where = f"{code.co_name}:{frame.f_lineno}"
                if leaf is None:
                    leaf = f"{os.path.basename(code.co_filename)}:{where}"
                if package is None and PACKAGE in code.co_filename:
                    package = f"{code.co_filename.split(PACKAGE)[-1]}:{where}"
                if code.co_filename == SMOKE:
                    chain.append(where)
                frame = frame.f_back
            if chain:
                counts["by_line"][chain[0]] += 1
                counts["by_chain"][" < ".join(chain[:6])] += 1
                for name in {c.split(":")[0] for c in chain}:
                    counts["by_func"][name] += 1
            counts["by_leaf"][leaf] += 1
            if package:
                counts["by_package"][package] += 1

    def dump() -> None:
        if done.is_set():
            return
        done.set()
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"period_s": PERIOD_S, "written_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                       **{k: [(name, round(n * PERIOD_S, 2)) for name, n in c.most_common(TOP)]
                          for k, c in counts.items()}}, f, indent=0)

    atexit.register(dump)
    threading.Thread(target=sample, daemon=True).start()
    sys.argv = [SMOKE]
    sys.path[0] = ROOT
    try:
        runpy.run_path(SMOKE, run_name="__main__")
    finally:
        dump()


if __name__ == "__main__":
    main()
