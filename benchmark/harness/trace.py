"""The device trace of a traced run: `torch.profiler` (CUPTI) over steady
stretches after the window, reduced to the card's busy seconds (the union
of its kernels, copies and sets), the device seconds of each kernel name,
the costliest device operations, and the longest idle gaps named by the
innermost host operation running over them.

A stretch starts without a synchronize, so the queue keeps the lead the
host had built, and ends with one; its window is the device's own span,
from the first recorded operation's start to the last one's end. The
profiler's raw records are read as they are (no tree of host events is
built), which keeps the reading to seconds.

Recording every host operation slows a train step's host by about a fifth
(a fifth of the card's time then reads idle that is not), so the same
stretch is traced twice, in two runs of the same work: first the device
alone, which gives every number, then with the host operations, which only
name the longest gaps."""

from __future__ import annotations

import time
from typing import Callable


class DeviceTrace:
    """start() / stop() around the traced stretch; summary() after."""

    def __init__(self, host_ops: bool = True):
        import torch

        acts = [torch.profiler.ProfilerActivity.CUDA]
        if host_ops:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> dict:
        out = summarize(raw_events(self.prof))
        out["host_s"] = self.t1 - self.t0
        return out


def raw_events(prof) -> tuple[list, list]:
    """(device, host) records of a stopped profile as (start ns, end ns,
    name), without user annotations."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.name()))
        elif kind == DeviceType.CPU:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    return dev, host


def stretch(run: Callable, host_ops: bool, first: int, last: int | None = None) -> DeviceTrace:
    """Trace one call of `run(hook)`, which calls `hook(n)` after its unit
    of work n (a batch, a step; from 1), from unit `first` to unit `last`,
    or to the call's end where `last` is None."""
    tr = DeviceTrace(host_ops)

    def hook(n: int) -> None:
        if n == first:
            tr.start()
        elif n == last:
            tr.stop()

    run(hook)
    if tr.t1 is None:
        tr.stop()
    return tr


def two_stretches(run: Callable, first: int, last: int | None = None) -> dict:
    """`stretch` with the device alone (every number), then again with the
    host operations (the names of the longest gaps)."""
    out = stretch(run, False, first, last).summary()
    named = stretch(run, True, first, last).summary()
    out["breakdown"]["idle_gaps"] = named["breakdown"]["idle_gaps"]
    out["named_stretch"] = {"busy_s": named["busy_s"], "window_s": named["window_s"]}
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: tuple[list, list], top: int = 10) -> dict:
    """busy_s, window_s (the device's span), {kernel name: device seconds,
    launches} and the breakdown of one stretch's (device, host) records."""
    dev, host = events
    by_name: dict = {}
    for a, b, name in dev:
        s, n = by_name.get(name, (0, 0))
        by_name[name] = (s + (b - a), n + 1)
    busy = _union([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    window_s = (busy[-1][1] - busy[0][0]) * 1e-9 if busy else 0.0
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  reverse=True)[:top]
    idle = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        over = [h for h in host if h[0] <= mid <= h[1]]
        name = min(over, key=lambda h: h[1] - h[0])[2] if over else "no host op"
        idle.append([name, length * 1e-9])
    ops = sorted(([k, v[0] * 1e-9] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": {k: {"seconds": v[0] * 1e-9, "launches": v[1]} for k, v in by_name.items()},
        "device_events": len(dev),
        "breakdown": {"device_ops": ops, "idle_gaps": idle},
    }


def kernel_seconds(trace: dict, fragment: str) -> tuple[float, int]:
    """(device seconds, launches) of the kernels whose name holds `fragment`."""
    s = n = 0
    for name, v in trace.get("kernels", {}).items():
        if fragment in name:
            s += v["seconds"]
            n += v["launches"]
    return s, n
