"""predict_tiles_per_s (tiles/s, host clock): every tile the window's passes
wrote to their COCO files, over the time from the first pass's start to the
last pass's end."""


def read(data):
    w = data["window"]
    return w["tiles"] / w["seconds"] if "batch_times" in w else None
