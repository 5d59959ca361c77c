"""device.peak_gib.predict (GiB): `torch.cuda.max_memory_allocated()` over
the window, reset at its start."""

from benchmark.harness.readers import peak_gib


def read(data):
    return peak_gib(data, "batch_times")
