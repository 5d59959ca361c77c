"""Process rank and count from `torch.distributed` when it is initialised,
else a single process (0 of 1)."""

from __future__ import annotations

import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
