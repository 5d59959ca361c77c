"""Time versions of the AFM kernel against each other on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 afm_bench.py [--parent OLD.cu] [--sweep 4x2x8,2x2x8,...]

It builds `pixelspointspolygons_torch/csrc/afm.cu` as the port builds it
and, beside it, every other version asked for with the same nvcc flags:
`--parent` names an earlier copy of the source with the same C interface
(`afm_launch`), and `--sweep` lists pixel tiles and block sizes as
ROWSxCOLSxWARPS, each built from the current source with AFM_ROWS,
AFM_COLS and AFM_WARPS defined on the command line. On chip_smoke.py's
main-path inputs (16 samples x 256 segments -> 224 x 224; 3 samples hold
768 of the 1,033 valid segments) every version is held to the plain
version (labels exact, map within 1e-5) and timed by CUDA events over
back-to-back calls, in turns: parent, current, current, parent, then the
sweep forward and backward.
Then every version's device time, without the host's cost of a call, comes
from 50 calls replayed in a CUDA graph, on these inputs and on three more
that tell the pair loop's rate from the cost of a block: "uniform" (all 16 samples with
256 valid random segments), "light" (the main path's inputs without its 3
random samples) and "empty" (no valid segment). Where the toolkit has `cuobjdump`, it counts the SASS
instructions of each version's pair loop. It prints one JSON object as its
last line and writes the SASS into build/afm_bench/sass.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

import chip_smoke
from pixelspointspolygons_torch.ops import build
from pixelspointspolygons_torch.ops.afm import _launch, afm

OUT = os.path.join(chip_smoke.ROOT, "build", "afm_bench")


def sass_pair_loop(so: str, out: str) -> dict | None:
    """The pair loop of the AFM kernel's SASS: of the innermost loops, the
    one with the most floating-point instructions. Returns its instruction
    count, its opcodes, and the two counts that give its pairs per
    iteration: 16-byte shared loads (two per segment, R x C pairs each, in
    the current kernel) and reciprocals (one per pair in a kernel that
    divides).
    The whole SASS goes to the file `out`."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    with open(out, "w") as f:
        f.write(sass)
    body = sass[sass.index("afm_kernel"):]
    if "Function :" in body:
        body = body[: body.index("Function :")]
    instrs = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);", body)
    instrs = [(int(a, 16), op, rest) for a, op, rest in instrs]
    loops = []
    for addr, op, rest in instrs:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, e) for a, e in loops if not any(a <= a2 and e2 < e for a2, e2 in loops if (a2, e2) != (a, e))]
    fp_ops = ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "MUFU")
    best = max(
        ([op for addr, op, _ in instrs if a <= addr <= e] for a, e in inner),
        key=lambda loop: sum(op.split(".")[0] in fp_ops for op in loop),
        default=None,
    )
    if best is None:
        return None
    return {
        "instructions": len(best),
        "opcodes": dict(collections.Counter(op.split(".")[0] for op in best).most_common()),
        "lds128": sum(op == "LDS.128" for op in best),
        "mufu_rcp": sum(op == "MUFU.RCP" for op in best),
        "ffma_sat": sum(op.startswith("FFMA") and ".SAT" in op for op in best),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier afm.cu with the same C interface")
    ap.add_argument("--sweep", default="", help="comma-separated ROWSxCOLSxWARPS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script times kernels on the card")
    os.makedirs(os.path.join(OUT, "sass"), exist_ok=True)
    os.environ["P3_DATASET_ROOT"] = os.path.join(chip_smoke.WORK, "data")
    os.environ["P3_MODEL_ROOT"] = os.path.join(chip_smoke.WORK, "outputs")
    from pixelspointspolygons_torch.config import compose

    smi = chip_smoke.phase_host()
    print(f"card: {smi}", flush=True)
    current = os.path.join(build.CSRC_DIR, build.SOURCES["afm"])
    sources = {"current": (current, [])}
    if args.parent:
        sources["parent"] = (os.path.abspath(args.parent), [])
    for spec in filter(None, args.sweep.split(",")):
        r, c, w = (int(x) for x in spec.split("x"))
        sources[spec] = (current, [f"-DAFM_ROWS={r}", f"-DAFM_COLS={c}", f"-DAFM_WARPS={w}"])
    libs = {name: ctypes.CDLL(so) for name, so in build.compile_versions(sources, OUT, "afm_kernel").items()}

    lines, valid = chip_smoke.afm_inputs(compose(chip_smoke.smoke_overrides(chip_smoke.TRAIN_STEPS * chip_smoke.B)))
    S = chip_smoke.S
    want_map, want_lab = afm(lines, valid, S, S)
    for name, lib in libs.items():
        got_map, got_lab = _launch(lib, lines, valid, S, S)
        torch.cuda.synchronize()
        bad, err = int((got_lab != want_lab).sum()), float((got_map - want_map).abs().max())
        print(f"{name}: label mismatches {bad}, map max abs err {err:.3g}", flush=True)
        if bad or not err <= 1e-5:
            chip_smoke.fail(f"{name} disagrees with the plain version")

    uniform = (torch.rand(lines.shape, generator=torch.Generator().manual_seed(0)) * S).to(lines.device)
    light = valid.clone()
    light[12:15] = False
    inputs = {
        "main": (lines, valid),
        "uniform": (uniform, torch.ones_like(valid)),
        "light": (lines, light),
        "empty": (lines, torch.zeros_like(valid)),
    }

    def time_one(name: str, which: str) -> float:
        x, v = inputs[which]
        return chip_smoke.cuda_ms(lambda: _launch(libs[name], x, v, S, S), launches=50, rounds=7)

    def device_one(name: str, which: str) -> float:
        x, v = inputs[which]
        return chip_smoke.graph_ms(lambda: _launch(libs[name], x, v, S, S), launches=50, rounds=7)

    order = ["parent", "current", "current", "parent"] if args.parent else ["current", "current"]
    others = [n for n in libs if n not in ("current", "parent")]
    order += others + others[::-1]
    times = collections.defaultdict(list)
    for name in order:
        times[name].append(time_one(name, "main"))
        print(f"{name}: {times[name][-1]:.5f} ms", flush=True)
    by_input = collections.defaultdict(dict)
    for which in inputs:
        for name in list(libs) + list(libs)[::-1]:
            by_input[which].setdefault(name, []).append(device_one(name, which))
        print(f"{which}, device time in a CUDA graph: "
              + ", ".join(f"{n} {statistics.median(t):.5f} ms" for n, t in by_input[which].items()), flush=True)
    sass = {n: sass_pair_loop(os.path.join(OUT, f"lib{n}.so"), os.path.join(OUT, "sass", f"{n}.sass")) for n in libs}
    for name, info in sass.items():
        if info:
            # the tile of a build that reports it; an earlier source without
            # afm_config divides once per pair
            if hasattr(libs[name], "afm_config"):
                conf = (ctypes.c_int * 4)()
                libs[name].afm_config(conf)
                per_iter = info["lds128"] // 2 * conf[0] * conf[1]
            else:
                per_iter = info["mufu_rcp"]
            info["pairs_per_iteration"] = per_iter
            info["instructions_per_pair"] = info["instructions"] / per_iter if per_iter else None
        print(f"{name} pair loop SASS: {json.dumps(info)}", flush=True)
    pairs = int(valid.sum()) * S * S
    # the least time the SASS pair loop can take on the main path: one warp
    # instruction per clock on each of an SM's 4 schedulers, at the card's
    # highest SM clock
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, info in sass.items():
        if info and info["instructions_per_pair"]:
            info["issue_bound_ms"] = pairs * info["instructions_per_pair"] / 32 / (4 * sms) / (mhz * 1e6) * 1e3
    print(f"{sms} SMs, highest SM clock {mhz} MHz; issue bound of the pair loop on the main path: "
          + ", ".join(f"{n} {i['issue_bound_ms']:.5f} ms" for n, i in sass.items() if i and "issue_bound_ms" in i),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "card": smi,
        "pairs": pairs,
        "ms": {k: v for k, v in times.items()},
        "ms_median": {k: statistics.median(v) for k, v in times.items()},
        "ms_median_by_input": {w: {k: statistics.median(v) for k, v in d.items()} for w, d in by_input.items()},
        "pairs_by_input": {w: int(v.sum()) * S * S for w, (_, v) in inputs.items()},
        "sass_pair_loop": sass,
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
