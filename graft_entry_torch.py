"""The PyTorch port's twin of `__graft_entry__.entry()`.

`entry(device=None)` returns `(fn, example_args)`: `fn(images, y)` is the
float32 teacher-forced forward of the full-size Pix2Poly-image
(`experiment=p2p_image`: ViT-S/8 at 224 px, vocabulary 227, 784 patches,
192 vertex slots) in eval mode, returning the logits (B, 385, 227) and the
Sinkhorn permutation (B, 192, 192); the example arguments are those of the
JAX entry: two zero images and token rows of BOS then PAD. The weights are
flax's default init drawn from seed 0 on the CPU, the same on every
device. It runs on the card unless `device="cpu"` is asked for, with TF32
off.

    python3 -c "import graft_entry_torch as g; fn, args = g.entry(); print([t.shape for t in fn(*args)])"
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def entry(device: str | torch.device | None = None):
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import resolve_device, set_tf32
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer, build_pix2poly

    dev = resolve_device(device)
    set_tf32(False)
    cfg = compose(["experiment=p2p_image", "run_type=debug"])
    tokenizer = Tokenizer(cfg)
    # drawn on the CPU, so that every device gets the same weights
    model = build_pix2poly(cfg, tokenizer, generator=torch.Generator().manual_seed(0)).to(dev).eval()

    B = 2
    images = torch.zeros(B, 224, 224, 3, device=dev)
    y = torch.full((B, tokenizer.max_len), tokenizer.PAD_code, dtype=torch.int32, device=dev)
    y[:, 0] = tokenizer.BOS_code

    @torch.inference_mode()
    def fn(images: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return model({"images": images}, y[:, :-1])

    return fn, (images, y)
