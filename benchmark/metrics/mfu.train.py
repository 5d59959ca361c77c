"""mfu.train (%): the window's training FLOPs (`counts/flops.py`: three
times each tile's forward, Sinkhorn's iterations counted, the LiDAR
padding not) over its seconds, against 67 TFLOP/s, the H100 SXM's float32
peak without tensor cores (TF32 is off)."""

from benchmark.harness.readers import mfu


def read(data):
    return mfu(data, "step_ms")
