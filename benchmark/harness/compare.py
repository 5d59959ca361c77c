"""What the comparisons share: the numerics the reference runs under, its
model loaded from the benchmark's checkpoint, and the gap measures."""

from __future__ import annotations

import contextlib

import torch

from ..reference.model import Pix2Poly


@contextlib.contextmanager
def numerics(tf32: bool):
    """Float32 products in full precision (`tf32=False`, the reference) or in
    TF32 (the control), and no ordered-algorithm check: the program's
    process turns that on, and the reference needs none of it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.use_deterministic_algorithms(saved[2])


def reference_model(s: dict, checkpoint: str, device) -> Pix2Poly:
    """The reference Pix2Poly with the weights the benchmark wrote."""
    model = Pix2Poly(s)
    model.load_state_dict(torch.load(checkpoint, map_location="cpu", weights_only=True)["model"])
    return model.to(device)


def worst_leaf_gap(prog: dict, ref: dict, leaves: list[str]) -> tuple[float, str]:
    """max over `leaves` of |prog norm - ref norm| / max(ref norm, median ref
    norm over `leaves`), and the leaf that gives it."""
    med = float(torch.tensor([ref[k] for k in leaves], dtype=torch.float64).median())
    worst, at = 0.0, ""
    for k in leaves:
        g = abs(prog[k] - ref[k]) / max(ref[k], med)
        if g != g:  # a non-finite norm on either side
            return float("inf"), k
        if g > worst or not at:
            worst, at = g, k
    return worst, at
