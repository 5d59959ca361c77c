"""device.peak_gib.train (GiB): `torch.cuda.max_memory_allocated()` over the
window, reset at its start."""

from benchmark.harness.readers import peak_gib


def read(data):
    return peak_gib(data, "step_ms")
