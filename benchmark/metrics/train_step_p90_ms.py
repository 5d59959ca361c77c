"""train_step_p90_ms (ms): the 90th percentile of every step of the window,
a step being the interval between CUDA events recorded after consecutive
calls of the trainer's step (the first from the window's start)."""

import numpy as np


def read(data):
    w = data["window"]
    return float(np.percentile(w["step_ms"], 90)) if w.get("step_ms") else None
