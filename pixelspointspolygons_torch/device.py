"""Device choice for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU
(`device="cpu"`, as the tests do). There is no fallback: asking for `cuda`
on a machine without a card raises.
"""

from __future__ import annotations

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


def check_compute_dtype(cfg) -> None:
    """`host.compute_dtype=bfloat16` runs for Pix2Poly and HiSup; FFL
    computes in float32 until its bfloat16 is ported with its training."""
    bf16 = str(cfg.host.get("compute_dtype", "float32")).lower() in ("bf16", "bfloat16")
    if bf16 and cfg.experiment.model.name == "ffl":
        raise NotImplementedError("host.compute_dtype=bfloat16 for ffl: ROADMAP 'Port queue' item 'FFL'")
