"""mfu.predict (%): the window's forward FLOPs (`counts/flops.py`:
encoder, every decode step run, ScoreNets, per tile) over its seconds,
against 67 TFLOP/s, the H100 SXM's float32 peak without tensor cores (TF32
is off)."""

from benchmark.harness.readers import mfu


def read(data):
    return mfu(data, "batch_times")
