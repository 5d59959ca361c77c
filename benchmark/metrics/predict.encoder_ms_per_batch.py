"""predict.encoder_ms_per_batch (ms): the encoder's device time a batch
(`models/vit.py`, CUDA events of `Pix2PolyPredictor.batch_times`), the mean
over the window's batches."""

from benchmark.harness.readers import mean_batch_ms


def read(data):
    return mean_batch_ms(data, "encoder_ms")
