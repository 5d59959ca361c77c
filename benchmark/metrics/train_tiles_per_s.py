"""train_tiles_per_s (tiles/s, host clock): the window's steps times the
batch, over the window, which ends in a synchronize."""


def read(data):
    w = data["window"]
    return w["tiles"] / w["seconds"] if "step_ms" in w else None
