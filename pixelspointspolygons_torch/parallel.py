"""Process rank and count from `torch.distributed` when it is initialised,
else a single process (0 of 1), and the host-object gather that the val IoU
uses."""

from __future__ import annotations

from typing import Any

import torch.distributed as dist


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if _distributed() else 1


def all_gather_objects(obj: Any) -> list[Any]:
    """Every process's `obj`, in rank order ([obj] in a single process) —
    the counterpart of the JAX package's `parallel.all_gather_objects`."""
    if not _distributed():
        return [obj]
    out: list[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
