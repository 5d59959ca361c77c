"""The PyTorch port's twins of `__graft_entry__.entry()` and
`__graft_entry__.dryrun_multichip(n)`.

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

`dryrun_multichip(n, device=None)` starts n processes as one process group
(NCCL on the first n cards, gloo with `device="cpu"`) and runs one
data-parallel train step (DDP, the synchronised BatchNorms, one AdamW or
Adam update) of each family on tiny shapes, each process on its two rows
of a global batch of 2n: Pix2Poly with the `early_fusion_vit` encoder,
HiSup with `vit_cnn`, HiSup with a tiny HRNet (its BatchNorms) and FFL
with `vit_cnn`. Rank 0 prints one line per family with the step's global
metrics, as the JAX twin does.

    python3 -c "import graft_entry_torch as g; g.dryrun_multichip(2, 'cpu')"
"""

from __future__ import annotations

import multiprocessing
import os
import sys

import numpy as np
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


S = 16  # the dry run's tile size
HISUP_WEIGHTS = {"loss_jloc": 8.0, "loss_joff": 0.25, "loss_mask": 1.0, "loss_afm": 0.1, "loss_remask": 1.0}


def tiny_pix2poly(generator: torch.Generator, dtype: torch.dtype = torch.float32):
    """`__graft_entry__._tiny_cfg_model`'s Pix2Poly: the early-fusion ViT
    at 16 px, two decoder layers of width 32, 6 vertex slots; its
    parameters and computation in `dtype`."""
    from pixelspointspolygons_torch.models.layers import init_flax_defaults
    from pixelspointspolygons_torch.models.pix2poly.model import Pix2Poly

    model = Pix2Poly(vocab_size=35, encoder_len=16, dim=32, num_heads=4, num_layers=2, max_len=14, pad_idx=34,
                     max_num_vertices=6, sinkhorn_iterations=10,
                     encoder_cfg={"name": "early_fusion_vit", "img_size": S, "patch_size": 4, "dim": 32, "depth": 2,
                                  "num_heads": 2, "width": float(S), "height": float(S), "voxel_x": 4.0,
                                  "voxel_y": 4.0, "max_points_per_voxel": 8}, dtype=dtype)
    init_flax_defaults(model, generator)
    return model.to(dtype)


def tiny_hisup(encoder: str, generator: torch.Generator, size: int = S, dtype: torch.dtype = torch.float32):
    """HiSup at `size` px (the dry run's 16), heads of width 32, with the
    `vit_cnn` encoder or a tiny HRNet (`__graft_entry__.py:170-178`),
    in `dtype`."""
    from pixelspointspolygons_torch.models.hisup.model import HiSup
    from pixelspointspolygons_torch.models.hrnet import HRNetEncoder
    from pixelspointspolygons_torch.models.layers import init_flax_defaults
    from pixelspointspolygons_torch.models.vit import ViTCNNEncoder

    if encoder == "vit_cnn":
        enc = ViTCNNEncoder(img_size=size, patch_size=4, dim=32, depth=2, num_heads=2, out_size=size, out_dim=32,
                            dtype=dtype)
    else:
        enc = HRNetEncoder(in_size=size, out_dim=32, width=4, stage1_planes=4, stage1_blocks=1, num_blocks=1,
                           num_modules=(1, 1, 1), stem_ch=4, dtype=dtype)
    model = HiSup(enc, dim=32, pred_size=size, dtype=dtype)
    init_flax_defaults(model, generator)
    return model.to(dtype)


def tiny_ffl(generator: torch.Generator, dtype: torch.dtype = torch.float32):
    """FFL at 16 px with the `vit_cnn` encoder, 3 seg channels, in `dtype`."""
    from pixelspointspolygons_torch.models.ffl import FFL
    from pixelspointspolygons_torch.models.layers import init_flax_defaults
    from pixelspointspolygons_torch.models.vit import ViTCNNEncoder

    model = FFL(ViTCNNEncoder(img_size=S, patch_size=4, dim=32, depth=2, num_heads=2, out_size=S, out_dim=32,
                              dtype=dtype), dim=32, seg_channels=3, out_size=S, dtype=dtype)
    init_flax_defaults(model, generator)
    return model.to(dtype)


def dryrun_batches(n_rows: int, seed: int = 0, size: int = S) -> dict:
    """The dry run's global batches of `n_rows` rows of `size` px, drawn
    from `seed` as the JAX twin draws them: {"pix2poly", "hisup", "ffl"} →
    numpy leaves."""
    rng = np.random.RandomState(seed)
    B, J = n_rows, 8
    p2p = {
        "images": rng.rand(B, size, size, 3).astype(np.float32),
        "lidar": rng.uniform(0, size, (B, 64, 3)).astype(np.float32),
        "lidar_mask": np.ones((B, 64), bool),
        "y": np.full((B, 14), 34, np.int64),
        "y_perm": np.eye(6, dtype=np.float32)[None].repeat(B, 0),
    }
    p2p["y"][:, 0] = 32  # BOS
    p2p["y"][:, 1:9] = rng.randint(0, 32, (B, 8))  # coordinate tokens
    p2p["y"][:, 9] = 33  # EOS
    hisup = {
        "images": rng.rand(B, size, size, 3).astype(np.float32),
        "junctions": rng.uniform(1, size - 1, (B, J, 2)).astype(np.float32),
        "junc_tags": rng.randint(1, 3, (B, J)).astype(np.int64),
        "junc_valid": np.ones((B, J), bool),
        "edges": rng.uniform(1, size - 1, (B, J, 4)).astype(np.float32),
        "edges_valid": np.ones((B, J), bool),
        "mask": (rng.rand(B, size, size) > 0.5).astype(np.float32),
    }
    ffl = {
        "images": rng.rand(B, size, size, 3).astype(np.float32),
        "gt_polygons_image": (rng.rand(B, 3, size, size) > 0.6).astype(np.float32),
        "distances": rng.rand(B, 1, size, size).astype(np.float32),
        "sizes": np.clip(rng.rand(B, 1, size, size), 0.1, 1).astype(np.float32),
        "gt_crossfield_angle": (rng.rand(B, 1, size, size) * np.pi).astype(np.float32),
        "class_freq": np.tile(np.array([[0.8, 0.2]], np.float32), (B, 1)),
    }
    return {"pix2poly": p2p, "hisup": hisup, "ffl": ffl}


def _dryrun_worker(rank: int, n: int, device: str | None, init_method: str) -> None:
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import set_tf32
    from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss
    from pixelspointspolygons_torch.parallel import all_reduce_mean, destroy_distributed, init_distributed
    from pixelspointspolygons_torch.train import ffl_step, hisup_step, pix2poly_step
    from pixelspointspolygons_torch.train.state import (TrainState, linear_warmup_decay, make_optimizer,
                                                        make_scheduler)

    dev = init_distributed(device, world_size=n, rank=rank, init_method=init_method)
    set_tf32(False)
    try:
        batches = dryrun_batches(2 * n)
        rows = slice(2 * rank, 2 * rank + 2)

        def shard(batch):
            return {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}

        def state(model, name, lr, **kw):
            model = model.to(dev)
            opt = make_optimizer(name, model.parameters(), lr, **kw)
            st = TrainState(model, opt, make_scheduler(opt, linear_warmup_decay(lr, 100), lr))
            st.wrap()
            return st

        def report(family, metrics):
            values = all_reduce_mean(torch.stack([metrics[k].float() for k in metrics])).tolist()
            if rank == 0:
                print(f"dryrun_multichip({n}) {family} OK — "
                      + ", ".join(f"{k}={v:.4f}" for k, v in zip(metrics, values)), flush=True)

        gen = torch.Generator().manual_seed(0)
        st = state(tiny_pix2poly(gen), "adamw", 3e-4, weight_decay=1e-4, b2=0.95)
        report("pix2poly", pix2poly_step.make_train_step(1.0, 10.0, 34)(st, shard(batches["pix2poly"])))
        hstep = hisup_step.make_train_step(HISUP_WEIGHTS, S)
        for family, encoder, seed in (("hisup", "vit_cnn", 1), ("hisup-hrnet", "hrnet", 3)):
            st = state(tiny_hisup(encoder, torch.Generator().manual_seed(seed)), "adamw", 1e-4)
            report(family, hstep(st, shard(batches["hisup"])))
        cfg = compose(["experiment=ffl_image", "dataset=synthetic", "run_type=debug"])
        loss_fn, weights_for_epoch = make_ffl_loss(cfg)
        st = state(tiny_ffl(torch.Generator().manual_seed(2)), "adam", 1e-4)
        report("ffl", ffl_step.make_train_step(loss_fn)(st, shard(batches["ffl"]), weights_for_epoch(0)))
    finally:
        destroy_distributed()


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> None:
    """One data-parallel train step of each family on `n_devices`
    processes (module docstring); raises if a process fails, and, on the
    card, before any starts when there are fewer cards than processes."""
    from pixelspointspolygons_torch.parallel import free_port

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and n_devices > (torch.cuda.device_count() if torch.cuda.is_available() else 0):
        raise RuntimeError(f"dryrun_multichip({n_devices}) on the card needs {n_devices} cards; "
                           "pass device='cpu' for gloo")
    ctx = multiprocessing.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_dryrun_worker, args=(r, n_devices, dev.type, init_method))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the processes exited with {codes}")
