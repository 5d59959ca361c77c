"""Device choice for the port's entry points, and their numerics on it.

Every entry point runs on the card unless its caller asks for the CPU
(`device="cpu"`, as the tests do). There is no fallback: asking for `cuda`
on a machine without a card raises. Each one turns TF32 off (`set_tf32`)
and, on the card, makes every operation take an ordered form
(`set_deterministic`), so that training and prediction give the same bits
twice from one seed, as the JAX package does on its TPU.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def set_tf32(enabled: bool) -> None:
    """TF32 for float32 matmuls and cuDNN convolutions, and cuBLAS's
    reduced-precision sums inside bfloat16 products. The port keeps all
    off: float32 as the JAX package computes it at
    host.compute_dtype=float32, and bfloat16 products summed in float32, as
    XLA sums them."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = enabled


def set_deterministic(device: str | torch.device) -> None:
    """On a CUDA device: cuDNN's deterministic algorithms (and no
    benchmarking of them), `torch.use_deterministic_algorithms(True)`, so
    that an operation with no ordered form on the card raises instead of
    adding in another order each run, and cuBLAS with a fixed workspace
    (`CUBLAS_WORKSPACE_CONFIG=:4096:8`). There is no switch: upstream's
    `seed_everything` always sets the cuDNN flag and the JAX package has
    none. PyTorch's filling of every new uninitialized tensor with NaN,
    which the flag turns on, is turned off: it changes no result of code
    that writes what it reads, and it doubled the kernels of a HiSup
    forward on the card (`PERF.md` §6); `chip_smoke.py` phase 27 holds
    every training path to the same bits twice without it. The flags are
    global to the process. On the CPU this does nothing: the port's CPU
    kernels add in a fixed order already, and the flags would outlive the
    caller.

    cuBLAS reads the variable when PyTorch creates its handle, at the
    process's first product on the card: each entry point (the trainers'
    and predictors' constructors, `graft_entry_torch`, `bench_torch.py`,
    `chip_smoke.py`, `trained_run.py`) calls this before any tensor
    reaches the card, which is where that order is guaranteed."""
    if torch.device(device).type != "cuda":
        return
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
