"""Time versions of the PillarFeatureNet's run-sums kernel against each other
on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 run_sums_bench.py [--parent OLD.cu] [--sweep 4x6x16384,6x12x8192,...] [--trace]

It builds `pixelspointspolygons_torch/csrc/run_sums.cu` as the port builds
it and, beside it, every other version asked for with the same nvcc flags:
`--parent` names an earlier copy of the source with the same C interface
(`run_sums_launch`), and `--sweep` lists
PRODUCERSxSTAGESxBYTES[xGROUP[xRUNSCAN]], each built from the current source
with RS_PRODUCERS (warps that fill a chain block's ring), RS_STAGES (its
slots), RS_STAGE_BYTES (bytes a slot), and, where given, RS_GROUP (rows the
chain reads ahead) and RS_RUN_SCAN (ids a lane reads in a run tile)
defined on the command line; ptxas's registers, shared memory and spills
are printed for each. The inputs are chip_smoke.py phase 3's: the synthetic
train split's first 16 clouds at 200,000 points, their PillarFeatureNet ids
at cap 64, float32 rows at 64 channels (the gather's gradient and the first
layer's tie count) and at 384 (the second layer's), and the dense encoder's
grid (`ops/pillar_layouts.py::dense_layout`, cap 4) at 64. Every version is
held bitwise to the plain version `ops/run_sums.py::run_sums` in each case
before it is timed. Then each is timed by CUDA events, in turns (parent,
current, current, parent, then the sweep forward and backward): back-to-back
eager calls (`ms`), calls replayed in a CUDA graph (`graph_ms`: the
device's time without the host's cost of a call), and one call at a time
after a 256 MB write that flushes the L2 cache (`cold_ms`).

It also measures the latency of the kernel's dependent add on the card (a
chain of 3.2M adds, `Add<T>` of the source, in one warp, clock64() and
globaltimer around it) for float32, float64 and bfloat16, and the chain
warp's loop alone (float32 rows read from shared memory in groups of 16 and
32, the next group read while this one is added), and gives each
case's two bounds: bytes (rows, ids and sums moved once, at 3.35 TB/s) and
the chain (the longest sample's dump rows x the add's cycles / the clock
read in the same microbenchmark).

`--trace` also builds the current source with RS_TRACE, and the parent's
too where it has the same marks (where it defines `run_sums_trace`), whose
kernels stamp clock64() at each chain tile's steps (copies requested,
landed, added) and globaltimer at each chain block's start and end, and
prints for one warm and one cold call at
64 channels the steps' cycles (medians over the tiles of every chain block:
requested to landed, landed to added, the chain's stall before a tile and
the period between tiles) and the blocks' times. Prints one JSON object as
its last line; builds into build/run_sums_bench.
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
from pixelspointspolygons_torch.ops.run_sums import _DTYPES, _launch, bind, run_sums

OUT = os.path.join(chip_smoke.ROOT, "build", "run_sums_bench")
TRACE_BLOCKS, TRACE_TILES = 64, 2048  # the trace build's arrays (csrc/run_sums.cu, RS_TRACE)
LATENCY_ADDS = 200_000 * 16

LATENCY_SOURCE = r"""
// the dependent add of run_sums.cu (its Add<T>), 16 values a round, one warp
#include "run_sums.cu"

template <typename T>
__global__ void add_chain(const T* in, T* out, long long* stamps, int rounds) {
  T v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = in[(threadIdx.x + i) % 32];
  typename Add<T>::Acc acc = 0;
  long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long c0 = clock64();
  for (int k = 0; k < rounds; ++k) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc = Add<T>::add(acc, v[i]);
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  out[threadIdx.x] = Add<T>::out(acc);
  if (threadIdx.x == 0) {
    stamps[0] = c1 - c0;
    stamps[1] = ns1 - ns0;
  }
}

// the chain warp's loop alone: groups of G rows of 32 floats read from a
// 128-row shared buffer, the next group read while this one is added
template <int G>
__global__ void smem_chain(const float* in, float* out, long long* stamps, int rounds) {
  __shared__ float buf[128 * 32];
  for (int i = threadIdx.x; i < 128 * 32; i += 32) buf[i] = in[i % 32];
  __syncwarp();
  const int lane = threadIdx.x;
  float acc = 0.0f;
  float v[G];
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = buf[i * 32 + lane];
  const long long c0 = clock64();
  for (int r = 0; r < rounds; ++r) {
    for (int k = 0; k < 128; k += G) {
      const int next = (k + G) & 127;
      float w[G];
#pragma unroll
      for (int i = 0; i < G; ++i) w[i] = buf[(next + i) * 32 + lane];
#pragma unroll
      for (int i = 0; i < G; ++i) acc = acc + v[i];
#pragma unroll
      for (int i = 0; i < G; ++i) v[i] = w[i];
    }
  }
  const long long c1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) stamps[0] = c1 - c0;
}

extern "C" int smem_chain_cycles(int group, const void* in, void* out, long long* stamps, int rounds) {
  if (group == 16) smem_chain<16><<<1, 32>>>((const float*)in, (float*)out, stamps, rounds);
  if (group == 32) smem_chain<32><<<1, 32>>>((const float*)in, (float*)out, stamps, rounds);
  return (int)cudaGetLastError();
}

extern "C" int add_latency(int dtype, const void* in, void* out, long long* stamps, int rounds) {
  if (dtype == 0) add_chain<float><<<1, 32>>>((const float*)in, (float*)out, stamps, rounds);
  if (dtype == 1) add_chain<double><<<1, 32>>>((const double*)in, (double*)out, stamps, rounds);
  if (dtype == 2) add_chain<__nv_bfloat16><<<1, 32>>>((const __nv_bfloat16*)in, (__nv_bfloat16*)out, stamps, rounds);
  return (int)cudaGetLastError();
}
"""

def add_latency(so: str) -> dict:
    """Cycles a dependent add of each dtype, and the clock (cycles per ns)
    over the same chain."""
    lib = ctypes.CDLL(so)
    lib.add_latency.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    out = {}
    for dtype, code in _DTYPES.items():
        vals = (torch.rand(32, device=chip_smoke.CARD) * 1e-3).to(dtype)
        res = torch.empty(32, dtype=dtype, device=chip_smoke.CARD)
        stamps = torch.zeros(2, dtype=torch.int64, device=chip_smoke.CARD)
        for _ in range(2):  # the first launch warms up
            err = lib.add_latency(code, vals.data_ptr(), res.data_ptr(), stamps.data_ptr(), LATENCY_ADDS // 16)
            if err != 0:
                chip_smoke.fail(f"add latency launch failed with CUDA error {err}")
            torch.cuda.synchronize()
        cycles, ns = stamps.tolist()
        out[str(dtype)[6:]] = {"cycles_per_add": cycles / LATENCY_ADDS, "ghz": cycles / ns}
    lib.smem_chain_cycles.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    vals = torch.rand(32, device=chip_smoke.CARD) * 1e-3
    res = torch.empty(32, device=chip_smoke.CARD)
    stamps = torch.zeros(2, dtype=torch.int64, device=chip_smoke.CARD)
    for group in (16, 32):
        for _ in range(2):
            err = lib.smem_chain_cycles(group, vals.data_ptr(), res.data_ptr(), stamps.data_ptr(), LATENCY_ADDS // 128)
            if err != 0:
                chip_smoke.fail(f"shared-memory chain launch failed with CUDA error {err}")
            torch.cuda.synchronize()
        out[f"float32_from_shared_group{group}"] = {"cycles_per_add": stamps[0].item() / (LATENCY_ADDS // 128 * 128)}
    print(f"dependent add latency (one warp, {LATENCY_ADDS} adds): " + json.dumps(out), flush=True)
    return out


def trace_steps(so: str, x: torch.Tensor, ids: torch.Tensor, S: int, B: int, what: str) -> dict:
    """A trace build's stamps for one warm and one cold (L2 flushed) call:
    medians over every traced chain block's tiles of requested -> landed,
    landed -> added, the chain's stall (its wait for the tile) and the
    period (added -> added), in cycles; the blocks' ns."""
    lib = bind(ctypes.CDLL(so))
    lib.run_sums_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    blocks = min(B * ((x.shape[1] + 31) // 32), TRACE_BLOCKS)
    marks = torch.zeros((blocks, TRACE_TILES, 4), dtype=torch.int64)
    ns = torch.zeros((blocks, 2), dtype=torch.int64)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=x.device)
    tiles = None
    out = {}
    for how in ("warm", "cold"):
        for _ in range(3):
            _launch(lib, x, ids, S, B)
        if how == "cold":
            flush.zero_()
        marks.zero_()
        _launch(lib, x, ids, S, B)
        torch.cuda.synchronize()
        err = lib.run_sums_trace(marks.data_ptr(), ns.data_ptr(), blocks)
        if err != 0:
            chip_smoke.fail(f"run_sums trace copy failed with CUDA error {err}")
        if tiles is None:  # the tiles every block stamped
            tiles = int((marks[:, :, 3] != 0).all(dim=0).sum())
        m = marks[:, :tiles].double()
        steps = {"requested_to_landed": m[:, :, 2] - m[:, :, 0], "landed_to_added": m[:, :, 3] - m[:, :, 2],
                 "stall": m[:, :, 2] - m[:, :, 1], "period": m[:, 1:, 3] - m[:, :-1, 3]}
        out[how] = {k: {"median_cycles": float(v.median()), "p90_cycles": float(v.quantile(0.9))}
                    for k, v in steps.items()}
        out[how]["tiles"] = tiles
        out[how]["block_ns_median"] = float((ns[:, 1] - ns[:, 0]).double().median())
        out[how]["blocks_ns"] = int(ns[:, 1].max() - ns[:, 0].min())
        print(f"trace {what}, {how}, {blocks} chain blocks x {tiles} tiles: " + json.dumps(out[how]), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier run_sums.cu with the same C interface")
    ap.add_argument("--sweep", default="", help="comma-separated PRODUCERSxSTAGESxBYTES[xGROUP[xRUNSCAN]]")
    ap.add_argument("--trace", action="store_true", help="time the chain's steps in RS_TRACE builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script times kernels on the card")
    os.makedirs(OUT, exist_ok=True)
    os.environ["P3_DATASET_ROOT"] = os.path.join(chip_smoke.WORK, "data")
    os.environ["P3_MODEL_ROOT"] = os.path.join(chip_smoke.WORK, "outputs")
    smi = chip_smoke.phase_host()
    print(f"card: {smi}", flush=True)
    current = os.path.join(build.CSRC_DIR, build.SOURCES["run_sums"])
    sources = {"current": (current, [])}
    if args.parent:
        sources["parent"] = (os.path.abspath(args.parent), [])
    for spec in filter(None, args.sweep.split(",")):
        macros = ("RS_PRODUCERS", "RS_STAGES", "RS_STAGE_BYTES", "RS_GROUP", "RS_RUN_SCAN")
        sources[spec] = (current, [f"-D{m}={int(v)}" for m, v in zip(macros, spec.split("x"))])
    traced = {}
    if args.trace:
        traced["current"] = "trace"
        sources["trace"] = (current, ["-DRS_TRACE"])
        if args.parent:
            with open(sources["parent"][0]) as f:
                if "run_sums_trace" in f.read():
                    traced["parent"] = "parent_trace"
                    sources["parent_trace"] = (sources["parent"][0], ["-DRS_TRACE"])
                else:
                    print("the parent's source has no RS_TRACE marks: its chain is not traced", flush=True)
    latency_src = os.path.join(OUT, "add_latency.cu")
    with open(latency_src, "w") as f:
        f.write(LATENCY_SOURCE)
    sources["add_latency"] = (latency_src, ["-I", build.CSRC_DIR])
    built = build.compile_versions(sources, OUT, "run_sums_kernel")
    latency = add_latency(built.pop("add_latency"))
    libs = {name: bind(ctypes.CDLL(so)) for name, so in built.items()}
    conf = (ctypes.c_int * 9)()
    libs["current"].run_sums_config(conf)
    print(f"current: warps, slot bytes, slots, group rows, run tile rows, smem bytes, blocks per SM "
          f"(float, double, bfloat16): {list(conf)}", flush=True)

    from pixelspointspolygons_torch.ops.pillar_layouts import DENSE_CAP, dense_layout
    from pixelspointspolygons_torch.ops.voxelize import sort_by_pillar

    pts, valid, grid = chip_smoke.lidar_batch(chip_smoke.lidar_overrides("hisup_lidar"))
    _, pid_s, n_cells = sort_by_pillar(pts, valid, **grid)
    B = pid_s.shape[0]
    main_ids = chip_smoke.run_sums_ids(pid_s, 64, n_cells)
    _, dpid, dense_cells = dense_layout()
    dpid = torch.from_numpy(dpid).to(chip_smoke.CARD)
    dense_ids = chip_smoke.run_sums_ids(dpid, DENSE_CAP, dense_cells)
    cases = {
        "main_64": (chip_smoke.run_rows(len(main_ids), 64, 0, torch.float32), main_ids, B * (n_cells + 1)),
        "main_384": (chip_smoke.run_rows(len(main_ids), 384, 1, torch.float32), main_ids, B * (n_cells + 1)),
        "dense_64": (chip_smoke.run_rows(len(dense_ids), 64, 2, torch.float32), dense_ids,
                     B * (dense_cells + 1)),
    }
    bounds = {}
    for case, (x, ids, S) in cases.items():
        want = run_sums(x, ids, S)
        for name, lib in libs.items():
            print(f"checking {name} on {case}", flush=True)
            got = _launch(lib, x, ids, S, B)
            torch.cuda.synchronize()
            if not chip_smoke.same_bits(got, want):
                chip_smoke.fail(f"{name} differs from the plain version on {case}")
        del want
        dump = ids.reshape(B, -1) == (torch.arange(B, device=ids.device)[:, None] + 1) * (S // B) - 1
        longest = int(dump.sum(dim=1).max())
        nbytes = x.numel() * x.element_size() + ids.numel() * 8 + S * x.shape[1] * x.element_size()
        lat = latency["float32"]
        bounds[case] = {"bytes_ms": nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3, "bytes": nbytes,
                        "longest_dump_rows": longest,
                        "chain_ms": longest * lat["cycles_per_add"] / lat["ghz"] * 1e-6}
        print(f"{case}: every version bitwise equal to the plain version; bounds {json.dumps(bounds[case])}",
              flush=True)
    torch.cuda.empty_cache()

    def timings(name: str, case: str) -> dict:
        x, ids, S = cases[case]

        def fn():
            return _launch(libs[name], x, ids, S, B)

        return {"ms": chip_smoke.cuda_ms(fn, launches=20, rounds=5),
                "graph_ms": chip_smoke.graph_ms(fn, launches=20, rounds=3),
                "cold_ms": chip_smoke.cold_ms(fn, rounds=7)}

    order = ["parent", "current", "current", "parent"] if args.parent else ["current", "current"]
    swept = [n for n in libs if n not in ("current", "parent", "trace", "parent_trace")]
    order += swept + swept[::-1]
    runs = {case: collections.defaultdict(list) for case in cases}
    for case in cases:
        for name in order:
            t = timings(name, case)
            runs[case][name].append(t)
            print(f"{case} {name}: {t['ms']:.5f} ms warm, {t['graph_ms']:.5f} ms in a CUDA graph, "
                  f"{t['cold_ms']:.5f} ms cold", flush=True)
    medians = {case: {name: {k: statistics.median(t[k] for t in ts) for k in ts[0]} for name, ts in d.items()}
               for case, d in runs.items()}
    steps = None
    if args.trace:
        x, ids, S = cases["main_64"]
        steps = {version: trace_steps(built[lib], x, ids, S, B, version) for version, lib in traced.items()}
    print(smi, flush=True)
    print(json.dumps({"card": smi, "latency": latency, "bounds": bounds, "runs": runs, "median": medians,
                      "trace": steps}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
