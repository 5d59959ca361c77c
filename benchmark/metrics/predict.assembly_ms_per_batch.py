"""predict.assembly_ms_per_batch (ms): the host assembly a batch
(`Pix2PolyPredictor.assemble`: tokens to vertices, Hungarian, chains; host
clock of `batch_times`), the mean over the window's batches."""

from benchmark.harness.readers import mean_batch_ms


def read(data):
    return mean_batch_ms(data, "host_ms")
