"""Host data loader — the port's copy of pixelspointspolygons_tpu/data/loader.py
(deterministic epoch shuffling, numpy batch collation, pad-to-batch, threaded
prefetch), plus the host→device copy that JAX's `shard_batch` did.

Process index and count come from `torch.distributed` when it is
initialised, else 0 and 1 (DistributedSampler semantics).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterable, Iterator

import numpy as np
import torch

from ..parallel import process_count as _process_count
from ..parallel import process_index as _process_index
from .dataset import P3Dataset

# float fields that the JAX package ships to the device as float16
# (parallel/mesh.py _F16_SAFE_KEYS: the images, HiSup's masks and FFL's
# rasters, distance and size maps and angle field); the port rounds them the
# same way so both train on the same numbers, and promotes back to float32
# on the device
F16_KEYS = frozenset({"images", "mask", "mask_ori", "gt_polygons_image", "distances", "sizes", "gt_crossfield_angle"})


def collate(items: list[dict]) -> dict:
    out: dict = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if np.ndim(vals[0]) > 0 else np.asarray(vals)
    return out


class Loader:
    def __init__(
        self,
        dataset: P3Dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 42,
        pad_to_batch: bool = True,
        num_workers: int = 0,
        prefetch: int = 2,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.pad_to_batch = pad_to_batch
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.epoch = 0
        self.process_index = int(_process_index() if process_index is None else process_index)
        self.process_count = int(_process_count() if process_count is None else process_count)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _num_local(self) -> int:
        n = len(self.dataset)
        if self.process_count <= 1:
            return n
        return (n + self.process_count - 1) // self.process_count

    def __len__(self) -> int:
        n = self._num_local()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idxs)
        if self.process_count > 1:
            per = self._num_local()
            total = per * self.process_count
            if total > len(idxs):  # wrap-pad like DistributedSampler
                idxs = np.concatenate([idxs, idxs[: total - len(idxs)]])
            idxs = idxs[self.process_index :: self.process_count]
        return idxs

    def _make_batch(self, batch_idxs: np.ndarray) -> dict:
        items = []
        for i in batch_idxs:
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + self.epoch * 10_007 + int(i)) % (2**31)
            )
            items.append(self.dataset.get_item(int(i), rng))
        batch = collate(items)
        n = len(batch_idxs)
        if self.pad_to_batch and n < self.batch_size:
            # repeat-pad the final partial batch; mask via 'sample_valid'
            reps = np.concatenate([np.arange(n), np.zeros(self.batch_size - n, int)])
            batch = {k: v[reps] for k, v in batch.items()}
            valid = np.zeros((self.batch_size,), bool)
            valid[:n] = True
            batch["sample_valid"] = valid
        else:
            batch["sample_valid"] = np.ones((n,), bool)
        return batch

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        n_batches = len(self)
        slices = [
            order[b * self.batch_size : (b + 1) * self.batch_size] for b in range(n_batches)
        ]
        if self.num_workers <= 0:
            for s in slices:
                yield self._make_batch(s)
            return
        with cf.ThreadPoolExecutor(self.num_workers) as ex:
            futures: list = []
            it = iter(slices)
            for _ in range(self.prefetch):
                s = next(it, None)
                if s is not None:
                    futures.append(ex.submit(self._make_batch, s))
            while futures:
                batch = futures.pop(0).result()
                s = next(it, None)
                if s is not None:
                    futures.append(ex.submit(self._make_batch, s))
                yield batch


def build_loader(
    cfg, split: str, tokenizer=None, eval_mode: bool = False, batch_size: int | None = None
) -> Loader:
    """get_{train,val,test}_loader equivalent (build_datasets.py:26-49);
    eval_mode builds the test-transform loader for any split (prediction).
    `batch_size` overrides the model batch size (e.g. larger eval batches)."""
    from .synthetic import ensure_synthetic_dataset

    ensure_synthetic_dataset(cfg)
    ds = P3Dataset(cfg, split, tokenizer=tokenizer, eval_mode=eval_mode)
    train = split == "train" and not eval_mode
    return Loader(
        ds,
        batch_size=int(batch_size or cfg.experiment.model.batch_size),
        shuffle=train and cfg.run_type.name != "debug",
        drop_last=False,
        seed=int(cfg.get("seed", 42)),
        num_workers=int(cfg.get("num_workers", 0) or 0),
    )


def to_device(batch: dict, device: torch.device, keys: Iterable[str]) -> dict:
    """Copy the named numpy leaves of a host batch to `device`. F16_KEYS
    travel as float16 and become float32 on the device. On a card the copy
    goes from pinned memory and does not block the host."""
    out = {}
    for k in keys:
        if k not in batch:
            continue
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if k in F16_KEYS and t.dtype == torch.float32:
            t = t.half()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t.float() if t.dtype == torch.float16 else t
    return out


def device_prefetch(batches: Iterable[dict], device: torch.device, keys: Iterable[str]) -> Iterator[dict]:
    """Yield device batches with the next batch's copy already queued: the
    host builds and pins batch n+1 while the device runs step n."""
    keys = tuple(keys)
    it = iter(batches)
    nxt = next(it, None)
    staged = None if nxt is None else to_device(nxt, device, keys)
    while staged is not None:
        cur = staged
        nxt = next(it, None)
        staged = None if nxt is None else to_device(nxt, device, keys)
        yield cur
