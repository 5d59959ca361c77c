"""Time versions of the voxelizer's pillar-sums kernel against each other on
one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 pillar_sums_bench.py [--parent OLD.cu] [--other NAME=OTHER.cu ...]
                                 [--sweep 8x8x2944x4,8x4x2944,...] [--trace]

It builds `pixelspointspolygons_torch/csrc/pillar_sums.cu` as the port
builds it and, beside it, every other version asked for with the same nvcc
flags: `--parent` (and each `--other`) names an earlier copy of the source
with the same C interface (`pillar_sums_launch`), and `--sweep` lists
WARPSxPERWARPxBYTES[xSCAN[xMINBLOCKS]], each built from the current source
with PS_WARPS (warps a block), PS_PER_WARP (pillars a warp),
PS_STAGE_BYTES (bytes a staged chunk) and, where given, PS_SCAN (tile rows
a thread reads) and PS_MIN_BLOCKS (blocks an SM must hold) defined on the
command line; ptxas's registers, shared memory and spills are printed for
each. On chip_smoke.py phase 3's inputs (the synthetic train split's first
16 clouds at 200,000 points, sorted by pillar) every version is held
bitwise to the plain version at caps 4, 64 and 512 in float32 and float64.
Then each is timed in float32 at each cap by CUDA events, in turns
(parent, current, current, parent, then the sweep forward and backward):
back-to-back eager calls (`ms`), 50 calls replayed in a CUDA graph
(`graph_ms`: the device's time without the host's cost of a call), and one
call at a time after a 256 MB write that flushes the L2 cache (`cold_ms`).
`--trace` also builds the current source with PS_TRACE, whose kernel
stamps clock64() at its steps (start, the padding check read, the owned
pillars' starts found, the warp's first chunk landed, the sums done) and
globaltimer at each block's start and end, and prints for one warm and one
cold call the steps' cycles (median and largest over the blocks that
summed) and the spread of the blocks' starts and ends. Prints one JSON
object as its last line; builds into build/pillar_sums_bench.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import statistics
import sys

import torch

import chip_smoke
from pixelspointspolygons_torch.ops import build
from pixelspointspolygons_torch.ops.voxelize import _launch, bind, pillar_sums, sort_by_pillar

OUT = os.path.join(chip_smoke.ROOT, "build", "pillar_sums_bench")


def trace_steps(lib: ctypes.CDLL, pts_s: torch.Tensor, pid_s: torch.Tensor, n_cells: int) -> dict:
    """The PS_TRACE build's stamps for one warm and one cold (L2 flushed)
    call at cap 64: per step the median and largest cycles over blocks,
    and the spread (ns) of the blocks' starts and ends."""
    conf = (ctypes.c_int * 7)()
    lib.pillar_sums_config(conf)  # warps, pillars a warp, chunk bytes, scan, ...
    blocks = pts_s.shape[0] * (pts_s.shape[1] // (32 * conf[0] * conf[3]) + 1)  # tiles of 32 * warps * scan rows
    marks = (ctypes.c_longlong * (7 * blocks))()
    lib.pillar_sums_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    flush = torch.empty(64 << 20, dtype=torch.int32, device=pts_s.device)
    names = ("check", "starts", "first_chunk", "sums")  # the kernel's marks 0-1, 1-2, 2-3, 3-4
    out = {}
    for how in ("warm", "cold"):
        for _ in range(3):
            _launch(lib, pts_s, pid_s, 64, n_cells)
        if how == "cold":
            flush.zero_()
        _launch(lib, pts_s, pid_s, 64, n_cells)
        torch.cuda.synchronize()
        lib.pillar_sums_trace(marks, blocks)
        m = torch.tensor(list(marks), dtype=torch.int64).reshape(blocks, 7)
        m = m[m[:, 4] != 0]  # the blocks that summed (a padding tile stops after its check)
        d = (m[:, 1:5] - m[:, 0:4]).double()
        out[how] = {name: {"median_cycles": float(d[:, i].median()), "max_cycles": float(d[:, i].max())}
                    for i, name in enumerate(names)}
        out[how]["blocks_that_summed"] = int(m.shape[0])
        out[how]["starts_spread_ns"] = int(m[:, 5].max() - m[:, 5].min())
        out[how]["kernel_ns"] = int(m[:, 6].max() - m[:, 5].min())
        out[how]["block_ns_median"] = float((m[:, 6] - m[:, 5]).double().median())
        print(f"trace, {how}, cap 64, {blocks} blocks: " + json.dumps(out[how]), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier pillar_sums.cu with the same C interface")
    ap.add_argument("--other", action="append", default=[], help="NAME=PATH of another version")
    ap.add_argument("--sweep", default="", help="comma-separated WARPSxPERWARPxBYTES[xSCAN[xMINBLOCKS]]")
    ap.add_argument("--trace", action="store_true", help="time the kernel's steps in a PS_TRACE build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script times kernels on the card")
    os.makedirs(OUT, exist_ok=True)
    os.environ["P3_DATASET_ROOT"] = os.path.join(chip_smoke.WORK, "data")
    os.environ["P3_MODEL_ROOT"] = os.path.join(chip_smoke.WORK, "outputs")
    smi = chip_smoke.phase_host()
    print(f"card: {smi}", flush=True)
    current = os.path.join(build.CSRC_DIR, build.SOURCES["pillar_sums"])
    sources = {"current": (current, [])}
    if args.parent:
        sources["parent"] = (os.path.abspath(args.parent), [])
    for spec in args.other:
        name, path = spec.split("=", 1)
        sources[name] = (os.path.abspath(path), [])
    for spec in filter(None, args.sweep.split(",")):
        macros = ("PS_WARPS", "PS_PER_WARP", "PS_STAGE_BYTES", "PS_SCAN", "PS_MIN_BLOCKS")
        sources[spec] = (current, [f"-D{m}={int(x)}" for m, x in zip(macros, spec.split("x"))])
    if args.trace:
        sources["trace"] = (current, ["-DPS_TRACE"])
    built = build.compile_versions(sources, OUT, "pillar_sums_kernel")
    libs = {name: bind(ctypes.CDLL(so)) for name, so in built.items()}

    pts, valid, grid = chip_smoke.lidar_batch(chip_smoke.lidar_overrides("hisup_lidar"))
    inputs = {}
    for dtype in (torch.float32, torch.float64):
        pts_s, pid_s, n_cells = sort_by_pillar(pts.to(dtype), valid, **grid)
        inputs[dtype] = (pts_s, pid_s, n_cells)
        for cap in chip_smoke.LIDAR_CAPS:
            want = pillar_sums(pts_s, pid_s, cap, n_cells)
            for name, lib in libs.items():
                got = _launch(lib, pts_s, pid_s, cap, n_cells)
                torch.cuda.synchronize()
                if not all(chip_smoke.same_bits(g, w) for g, w in zip(got, want)):
                    chip_smoke.fail(f"{name} differs from the plain version at cap {cap} ({dtype})")
    print(f"every version bitwise equal to the plain version at caps {chip_smoke.LIDAR_CAPS}, float32 and float64",
          flush=True)

    pts_s, pid_s, n_cells = inputs[torch.float32]

    def timings(name: str, cap: int) -> dict:
        def call():
            return _launch(libs[name], pts_s, pid_s, cap, n_cells)

        return {"ms": chip_smoke.cuda_ms(call, launches=50, rounds=7),
                "graph_ms": chip_smoke.graph_ms(call, launches=50, rounds=7),
                "cold_ms": chip_smoke.cold_ms(call, rounds=9)}

    order = ["parent", "current", "current", "parent"] if args.parent else ["current", "current"]
    others = [n for n in libs if n not in ("current", "parent", "trace")]
    order += others + others[::-1]
    runs = {cap: collections.defaultdict(list) for cap in chip_smoke.LIDAR_CAPS}
    for cap in chip_smoke.LIDAR_CAPS:
        for name in order:
            runs[cap][name].append(timings(name, cap))
            t = runs[cap][name][-1]
            print(f"cap {cap} {name}: {t['ms']:.5f} ms warm, {t['graph_ms']:.5f} ms in a CUDA graph, "
                  f"{t['cold_ms']:.5f} ms cold", flush=True)
    medians = {cap: {name: {k: statistics.median(t[k] for t in ts) for k in ts[0]} for name, ts in d.items()}
               for cap, d in runs.items()}
    steps = trace_steps(libs["trace"], pts_s, pid_s, n_cells) if args.trace else None
    print(smi, flush=True)
    print(json.dumps({"card": smi, "runs": runs, "median": medians, "trace": steps}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
