"""Command-line plumbing shared by the port's entry points: hydra-style
`key.path=value` overrides go to the config engine; `device=cpu` (or any
torch device) picks the device, which is the card when it is not given.

`run(main)` is each command's `__main__`: under `P3_LAUNCH=N` it runs the
command N times as one process group (`parallel.maybe_launch`) and exits
with their status. `main` starts the group from `P3_NUM_PROCESSES`,
`P3_PROCESS_ID` and `P3_COORDINATOR` (`process_group`: NCCL on the card,
gloo with `device=cpu`) and destroys it at the end, as the JAX package's
scripts/_common.py:20-66 initialises `jax.distributed`.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, Iterator

import torch

from .. import parallel
from ..config.engine import Config, compose


def split_device(argv: list[str] | None = None) -> tuple[list[str], str | None]:
    """(the config overrides, the `device=` value or None) of `argv`
    (default `sys.argv[1:]`)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    overrides = []
    for a in argv:
        if a.startswith("device="):
            device = a.split("=", 1)[1]
        else:
            overrides.append(a)
    return overrides, device


def compose_from_argv(argv: list[str] | None = None) -> tuple[Config, str | None]:
    overrides, device = split_device(argv)
    return compose(overrides), device


@contextlib.contextmanager
def process_group(device: str | None) -> Iterator[str | torch.device | None]:
    """The command's process group for the span of the block, from the
    environment; yields this process's device (`cuda:<rank>` under NCCL).
    In one process nothing is started and `device` is yielded as given; a
    group that the caller already started is used and left to it."""
    if parallel.is_distributed():
        yield device
        return
    dev = parallel.init_distributed(device)
    if not parallel.is_distributed():
        yield device
        return
    try:
        yield dev
    finally:
        parallel.destroy_distributed()


def run(main: Callable[[], object]) -> None:
    rc = parallel.maybe_launch()
    if rc is not None:
        sys.exit(rc)
    main()


def print_line(obj: object) -> None:
    """`obj` and a newline in one write to stdout, flushed: the processes of
    a group share the stream, and a line written in one piece stays whole."""
    sys.stdout.write(f"{obj}\n")
    sys.stdout.flush()


def format_results(results: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in results.items()}
