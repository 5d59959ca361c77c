"""Data parallelism over processes with `torch.distributed` — the port's
counterpart of pixelspointspolygons_tpu/parallel/mesh.py.

JAX runs one jitted step on a batch sharded over a device mesh, and every
mean over the batch axis is global under `jit`. The port runs one process
per card (or gloo processes on the CPU), each on its own shard of the
global batch (`data/loader.py`), and makes the same means global by hand:

- gradients: `DistributedDataParallel` (`wrap_model`) averages them;
- BatchNorm statistics: `models/layers.py` gathers them whenever a
  process group is initialised (`is_distributed`);
- loss normalizers that are not plain means over equal shards
  (`train/pix2poly_step.py::token_ce_loss`) divide by the global count;
- logged metrics: `all_reduce_mean` (`Trainer.summarize_deferred`).

`make_mesh`, `shard_batch` and `replicate` have no counterpart: DDP
broadcasts rank 0's weights when it wraps the model, and each process holds
its own shard of the batch, copied to its own device by
`data/loader.py::device_prefetch`. `local_values` has none either: a
process's outputs are its own rows.

Processes start from `P3_LAUNCH=N` (`maybe_launch`: the command runs again
N times with the three variables below set) or from
`P3_NUM_PROCESSES`/`P3_PROCESS_ID`/`P3_COORDINATOR` given by an outside
launcher (`init_distributed`), as the JAX package's scripts/_common.py
reads them. NCCL serves the card, one process per card (on
`cuda:{local rank}`; `LOCAL_RANK` and `LOCAL_WORLD_SIZE` place processes
across hosts); gloo serves the CPU. There is no fallback: NCCL asked for
more processes on a host than it has cards raises.

`collectives` counts the collectives issued through this module and DDP's
gradient buckets, by kind (`chip_smoke.py` reads it per step).
"""

from __future__ import annotations

import collections
import os
import socket
import subprocess
import sys
import time
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

# collectives issued, by kind: "batch_norm" (layers.py), "bucket" (DDP's
# gradient all-reduces), "metrics", "count", "gather", "barrier"
collectives: collections.Counter = collections.Counter()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def free_port() -> int:
    """A free TCP port on this host, for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def maybe_launch() -> int | None:
    """The `P3_LAUNCH=N` launcher (JAX scripts/_common.py:20-66): with N > 1,
    run the command of this process N times, each with
    `P3_NUM_PROCESSES=N`, its `P3_PROCESS_ID` and one `P3_COORDINATOR` on a
    free local port (and `LOCAL_RANK`, `LOCAL_WORLD_SIZE`), wait for them
    and return the exit code of the process that failed (0 if none did); a
    process that fails ends the others, which would wait at their next
    collective. Otherwise None: the caller runs the command itself. Under
    `python -m pkg.mod` `sys.argv[0]` is the module's file, so the command
    is rebuilt from `__main__.__spec__`."""
    n = int(os.environ.pop("P3_LAUNCH", "0") or 0)
    if n <= 1:
        return None
    spec = getattr(sys.modules["__main__"], "__spec__", None)
    cmd = [sys.executable, "-m", spec.name, *sys.argv[1:]] if spec is not None else [sys.executable, *sys.argv]
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [
        subprocess.Popen(cmd, env={**os.environ, "P3_NUM_PROCESSES": str(n), "P3_PROCESS_ID": str(i),
                                   "P3_COORDINATOR": coordinator, "LOCAL_RANK": str(i), "LOCAL_WORLD_SIZE": str(n)})
        for i in range(n)
    ]
    try:
        codes = [p.poll() for p in procs]
        while None in codes and not any(codes):
            time.sleep(0.1)
            codes = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()
    return next((c for c in codes if c), 0)


def init_distributed(device: str | torch.device | None = None, world_size: int | None = None,
                     rank: int | None = None, init_method: str | None = None) -> torch.device:
    """Start the process group and return this process's device.

    The world size, rank and rendezvous come from the arguments, else from
    `P3_NUM_PROCESSES`, `P3_PROCESS_ID` and `P3_COORDINATOR` (`host:port`,
    or an `init_method` URL such as `file:///path`). With one process and
    no arguments nothing is started and the device is returned as given.
    `device` `cpu` takes gloo; the card (the default) takes NCCL with each
    process on `cuda:{local rank}`, and raises when this host has fewer
    cards than processes. The local rank and the host's process count are
    `LOCAL_RANK` and `LOCAL_WORLD_SIZE` where a launcher sets them
    (`maybe_launch` does, as torchrun does; across hosts the outside
    launcher must), else the rank and the world size: one host."""
    if world_size is None:
        world_size = int(os.environ.get("P3_NUM_PROCESSES", "1") or 1)
        if world_size <= 1:
            return torch.device("cuda" if device is None else device)
    rank = int(os.environ.get("P3_PROCESS_ID", "0")) if rank is None else rank
    if init_method is None:
        coordinator = os.environ.get("P3_COORDINATOR")
        if not coordinator:
            raise ValueError("P3_NUM_PROCESSES > 1 needs P3_COORDINATOR (host:port)")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local_count = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if local_count > cards:
            raise RuntimeError(
                f"NCCL runs one process per card: {local_count} processes were asked for on this host and it has "
                f"{cards} card(s); start at most {cards} a host (across hosts, give each process LOCAL_RANK and "
                f"LOCAL_WORLD_SIZE), or pass device=cpu for gloo"
            )
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, world_size=world_size, rank=rank,
                                device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, world_size=world_size, rank=rank)
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    return dev


def destroy_distributed() -> None:
    if is_distributed():
        dist.destroy_process_group()


def sync_processes(tag: str = "p3_sync") -> None:
    """Barrier across processes (none in one process); `tag` names the
    point, as JAX's `sync_processes` does."""
    if not is_distributed():
        return
    collectives["barrier"] += 1
    dist.barrier()


def all_reduce_sum(t: torch.Tensor, kind: str) -> torch.Tensor:
    """`t` summed over processes, in place (unchanged in one process);
    counted under `kind`."""
    if is_distributed():
        collectives[kind] += 1
        dist.all_reduce(t)
    return t


def all_gather_stacked(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Every process's `t` stacked on a new first axis, in rank order
    (`t[None]` in a single process); one collective, counted under `kind`.
    The output is `t`'s rows concatenated, the layout that both NCCL and
    gloo gather into."""
    if not is_distributed():
        return t[None]
    collectives[kind] += 1
    out = t.new_empty((dist.get_world_size() * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous())
    return out.view(-1, *t.shape)


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over processes (for metrics), in place."""
    if not is_distributed():
        return t
    return all_reduce_sum(t, "metrics").div_(dist.get_world_size())


def all_gather_objects(obj: Any) -> list[Any]:
    """Every process's `obj`, in rank order ([obj] in a single process) —
    the counterpart of the JAX package's `parallel.all_gather_objects`."""
    if not is_distributed():
        return [obj]
    collectives["gather"] += 1
    out: list[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _counted_allreduce(state, bucket):
    from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import allreduce_hook

    collectives["bucket"] += 1
    return allreduce_hook(state, bucket)


def wrap_model(module: nn.Module) -> nn.Module:
    """`DistributedDataParallel` around `module` on its device, which
    broadcasts rank 0's parameters and buffers now and averages gradients
    in each backward (the default all-reduce hook, counted). The
    BatchNorms' running statistics come from global batch statistics, the
    same on every process, so no buffer is broadcast per forward
    (`broadcast_buffers=False`)."""
    dev = next(module.parameters()).device
    ddp = nn.parallel.DistributedDataParallel(
        module,
        device_ids=[dev] if dev.type == "cuda" else None,
        broadcast_buffers=False,
        find_unused_parameters=False,
    )
    ddp.register_comm_hook(None, _counted_allreduce)
    return ddp
