"""predict.decode_ms_per_batch (ms): the decode loop's device time a batch
(`greedy_decode`, CUDA events of `Pix2PolyPredictor.batch_times`), the mean
over the window's batches."""

from benchmark.harness.readers import mean_batch_ms


def read(data):
    return mean_batch_ms(data, "decode_ms")
