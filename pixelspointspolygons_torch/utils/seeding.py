"""Deterministic seeding (reference: misc/shared_utils.py:120-126
seed_everything): python `random`, numpy's global RNG and torch's."""

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
