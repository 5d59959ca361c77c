"""Arithmetic that several metric readers share. A reader returns None
where its run has nothing to read: another mode's window, no trace, no
card."""

from __future__ import annotations

# the H100 SXM's float32 rate outside the tensor cores (NVIDIA's data
# sheet, dense); TF32 is off on every path of the program
H100_FP32_FLOPS = 67e12


def mean_batch_ms(data: dict, key: str) -> float | None:
    times = data["window"].get("batch_times")
    vals = [b[key] for b in times or [] if b.get(key) is not None]
    return sum(vals) / len(vals) if vals else None


def mfu(data: dict, mode_key: str) -> float | None:
    w = data["window"]
    if mode_key not in w or data.get("window_peak_bytes") is None:
        return None
    return 100.0 * w["flops"] / w["seconds"] / H100_FP32_FLOPS


def idle_pct(data: dict, mode_key: str) -> float | None:
    tr = data["trace"]
    if mode_key not in data["window"] or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_gib(data: dict, mode_key: str) -> float | None:
    if mode_key not in data["window"] or data.get("window_peak_bytes") is None:
        return None
    return data["window_peak_bytes"] / 2**30
