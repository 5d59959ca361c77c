"""Seeded weights, made on the card by the benchmark and handed to the
program through its own checkpoint format (`<output_dir>/checkpoints/
<name>.pt`, a dict with the state under "model").

The names and shapes are the reference model's (`reference/model.py`),
which are the program's. Every matrix, convolution and embedding is drawn
N(0, 1/fan_in), the position embeddings and the CLS token N(0, 0.02²),
biases 0, norm scales 1, running statistics (0, 1), the dustbin score 1:
one `torch.randn` for all of them from a generator on the card."""

from __future__ import annotations

import math
import os

import torch

from ..reference.model import Pix2Poly


def _scale(name: str, shape: torch.Size) -> float | None:
    """The draw's standard deviation of a leaf, or None for a constant."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("pos_embed", "cls_token", "decoder_pos_embed", "encoder_pos_embed"):
        return 0.02
    if leaf == "weight" and len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:]))
    return None


def _constant(name: str, shape: torch.Size) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight", "running_var", "bin_score"):
        return 1.0
    return 0.0


def make_state(s: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for the Pix2Poly of sizes `s`."""
    with torch.device("meta"):
        skeleton = Pix2Poly(s).state_dict()
    drawn = [(k, v.shape) for k, v in skeleton.items() if _scale(k, v.shape) is not None]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise = torch.randn(sum(math.prod(shape) for _, shape in drawn), generator=gen, device=device)
    state, at = {}, 0
    for k, shape in drawn:
        n = math.prod(shape)
        state[k] = (noise[at: at + n] * _scale(k, shape)).view(shape).clone()
        at += n
    for k, v in skeleton.items():
        if k not in state:
            state[k] = torch.full(v.shape, _constant(k, v.shape), dtype=torch.float32, device=device)
    return {k: state[k] for k in skeleton}


def write_checkpoint(state: dict, output_dir: str, name: str) -> str:
    path = os.path.join(output_dir, "checkpoints", f"{name}.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"model": state, "epoch": 0}, path)
    return path
