"""Seeding (reference: misc/shared_utils.py:120-126 seed_everything):
python `random`, numpy's global RNG and torch's. The seeds alone do not
make a run repeat its bits on the card: the reference's function also sets
`cudnn.deterministic`, which the port sets, with PyTorch's deterministic
algorithms and cuBLAS's fixed workspace, in `device.set_deterministic`
(every entry point calls it)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
