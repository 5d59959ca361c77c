"""Pix2Poly predictor: KV-cached greedy decode and raw vertex-pair scores on
the device, Hungarian assignment and successor-chain polygon assembly on the
host, COCO json — port of pixelspointspolygons_tpu/predict/predictor_pix2poly.py
(:29-239; reference predict/predictor_pix2poly.py).

`predict_dataset` keeps one batch in flight, as the HiSup predictor does:
each batch's tokens and scores are copied into pinned host buffers right
after its decode, with an event behind the copy; batch k+1 is dispatched;
then the host waits on batch k's event alone and assembles batch k. The
decode issues its steps without reading a device value (the early exit
looks once every `EXIT_CHECK_EVERY` steps), so the host runs ahead of the
card, as far as the launches let it.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..data.loader import INPUT_KEYS, build_loader, to_device
from ..models.pix2poly import Pix2Poly, Tokenizer, build_pix2poly, greedy_decode
from ..train.state import compute_dtype
from ..utils.coco import generate_coco_ann
from .predictor import Predictor, valid_image_ids

def scores_to_permutations(scores: np.ndarray) -> np.ndarray:
    """Hungarian-optimal hard permutation per sample (raw score maximization)."""
    B, N, _ = scores.shape
    perm = np.zeros_like(scores)
    for b in range(B):
        r, c = linear_sum_assignment(-scores[b])
        perm[b, r, c] = 1
    return perm


def permutations_to_polygons(perm: np.ndarray, vertices: np.ndarray) -> list[list[np.ndarray]]:
    """Assemble polygons by following successor links.

    perm: (B, N, N) hard permutation; vertices: (B, N, 2) (x, y) coords where
    row i corresponds to perm slot i (rows beyond the decoded vertex count
    must have perm[i, i] == 1 so they are skipped).
    Returns per-sample lists of (V, 2) open rings.
    """
    B, N, _ = perm.shape
    out: list[list[np.ndarray]] = []
    for b in range(B):
        real = ~(perm[b, np.arange(N), np.arange(N)] > 0.5)
        idx = np.nonzero(real)[0]
        polys_b: list[np.ndarray] = []
        if len(idx):
            sub = perm[b][np.ix_(idx, idx)]
            succ = np.argmax(sub, axis=1)
            chains = [[i, int(succ[i])] for i in range(len(idx))]
            chains = _bubble_merge(chains)
            for chain in chains:
                if len(chain) >= 2 and chain[0] == chain[-1]:
                    chain = chain[:-1]
                if len(chain) >= 3:
                    polys_b.append(vertices[b][idx[chain]])
        out.append(polys_b)
    return out


def _bubble_merge(chains: list[list[int]]) -> list[list[int]]:
    """Merge chains whose head matches another chain's tail
    (reference bubble_merge, predictor_pix2poly.py:218-234), iteratively."""
    merged = True
    while merged:
        merged = False
        s = 0
        while s < len(chains):
            head = chains[s][-1]
            t = s + 1
            while t < len(chains):
                if chains[t][0] == head:
                    chains[s] = chains[s] + chains[t][1:]
                    del chains[t]
                    merged = True
                    head = chains[s][-1]
                    t = s + 1
                else:
                    t += 1
            s += 1
    return chains


class Pix2PolyPredictor(Predictor):
    def __init__(self, cfg, device: str | torch.device | None = None, model: Pix2Poly | None = None):
        """`model`: a Pix2Poly already on `device` whose weights the caller
        owns (the trainer's, at its compute dtype); else one is built at
        the config's compute dtype and takes its weights from the
        checkpoint."""
        super().__init__(cfg, device)
        self.tokenizer = Tokenizer(cfg)
        if model is None:
            model = build_pix2poly(cfg, self.tokenizer, device=self.device, dtype=compute_dtype(cfg))
        self.model = model
        self.generation_steps = int(cfg.experiment.model.tokenizer.generation_steps)
        # per batch of the last predict_dataset: device ms of the encoder,
        # the decode loop and the ScoreNets (CUDA events; None on the CPU),
        # the decode loop's host ms and steps, host-stage ms, wall ms since
        # the previous batch was done
        self.batch_times: list[dict] = []

    def load_checkpoint(self) -> dict:
        payload = super().load_checkpoint()
        self.model.load_state_dict(payload["model"])
        return payload

    @torch.inference_mode()
    def forward(self, inputs: dict, events: list | None = None) -> tuple[tuple[torch.Tensor, torch.Tensor], dict]:
        """The device part (JAX :96-111): encode, greedy decode with the
        early exit, raw scores. Returns ((tokens (B, T), scores (B, V, V)),
        {"steps", "decode_host_ms"}); `events[0..3]`, when given, are
        recorded before the encoder, after it, after the decode loop and
        after the ScoreNets."""

        def mark(i: int) -> None:
            if events is not None:
                events[i].record()

        self.model.eval()
        mark(0)
        enc = self.model.encode(inputs)
        mark(1)
        t = time.perf_counter()
        tokens, feats, steps = greedy_decode(
            self.model, enc, self.tokenizer.BOS_code, self.generation_steps, eos_code=self.tokenizer.EOS_code
        )
        decode_host_ms = (time.perf_counter() - t) * 1e3
        mark(2)
        scores = self.model.raw_scores_from_feats(feats)
        mark(3)
        return (tokens, scores), {"steps": steps, "decode_host_ms": decode_host_ms}

    @torch.inference_mode()
    def _dispatch(self, inputs: dict):
        """Queue the forward and the copy of its outputs to the host.
        Returns (outputs, info, events): on the card the outputs are pinned
        host tensors that are valid once events[4] has completed, and
        events[:4] cut the forward into encoder, decode loop and ScoreNets."""
        if self.device.type != "cuda":
            return (*self.forward(inputs), None)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        outs, info = self.forward(inputs, events)
        host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True) for t in outs
        )
        ready = torch.cuda.Event()
        ready.record()
        return host, info, events + [ready]

    @staticmethod
    def _fetch(handles) -> tuple[np.ndarray, np.ndarray]:
        """Wait for one batch's copy alone; (tokens, float32 scores) as numpy
        (numpy has no bfloat16)."""
        (tokens, scores), _, events = handles
        if events is not None:
            events[4].synchronize()
        return tokens.numpy(), scores.float().numpy()

    def predict_batch(self, batch: dict) -> tuple[list, np.ndarray]:
        """(per-sample polygon lists, tokens) of one host batch, synchronously."""
        inputs = to_device(batch, self.device, INPUT_KEYS)
        return self.assemble(*self._fetch(self._dispatch(inputs)))

    def assemble(self, tokens: np.ndarray, scores: np.ndarray) -> tuple[list, np.ndarray]:
        """Host half (JAX :134-169): decode the tokens into vertices,
        Hungarian on the scores, successor-chain merge."""
        scores = np.array(scores, np.float32)
        B = tokens.shape[0]
        nmax = self.tokenizer.max_num_vertices
        vertices = np.zeros((B, nmax, 2), np.float32)
        counts = np.zeros((B,), int)
        for b in range(B):
            seq = np.concatenate([[self.tokenizer.BOS_code], tokens[b]])
            coords = self.tokenizer.decode(seq)  # (V, 2) in (y, x)
            n = min(len(coords), nmax)
            if n:
                vertices[b, :n] = coords[:n, ::-1]  # → (x, y)
            counts[b] = n
            # pin the assignment to the decoded block BEFORE Hungarian: the
            # decoder features past it are zeros (early exit) or junk
            # (fixed length), and must not steal valid columns
            scores[b, n:, :] = -1e9
            scores[b, :, n:] = -1e9
            scores[b, range(n, nmax), range(n, nmax)] = 1e9
        perm = scores_to_permutations(scores)
        for b in range(B):
            n = counts[b]
            # rows beyond the decoded vertices self-link
            perm[b, n:, :] = 0
            perm[b, :, n:] = 0
            perm[b, range(n, nmax), range(n, nmax)] = 1
        return permutations_to_polygons(perm, vertices), tokens

    def predict_dataset(self, split: str | None = None) -> str:
        split = split or self.cfg.evaluation.split
        self.load_checkpoint()
        # evaluation.batch_size may exceed the training batch (the decode is
        # latency-bound); per-tile outputs do not depend on it
        bs = self.cfg.evaluation.get("batch_size")
        loader = build_loader(
            self.cfg, split, tokenizer=self.tokenizer, eval_mode=True, batch_size=int(bs) if bs else None
        )

        predictions: list[dict] = []
        self.batch_times = []
        image_ids: list[int] = []
        t0 = time.time()
        t_done = time.perf_counter()

        def consume(handles, batch):
            nonlocal t_done
            tokens, scores = self._fetch(handles)
            t = time.perf_counter()
            polys, _ = self.assemble(tokens, scores)
            now = time.perf_counter()
            info, events = handles[1], handles[2]
            stage_ms = [None] * 3 if events is None else [events[i].elapsed_time(events[i + 1]) for i in range(3)]
            self.batch_times.append({
                "encoder_ms": stage_ms[0],
                "decode_ms": stage_ms[1],
                "scorenet_ms": stage_ms[2],
                "device_ms": None if events is None else events[0].elapsed_time(events[3]),
                "decode_host_ms": info["decode_host_ms"],
                "steps": info["steps"],
                "host_ms": (now - t) * 1e3,
                "wall_ms": (now - t_done) * 1e3,
            })
            t_done = now
            for b, image_polys in enumerate(polys):
                if batch["sample_valid"][b]:
                    predictions.extend(generate_coco_ann(image_polys, int(batch["image_id"][b])))
            image_ids.extend(valid_image_ids(batch))

        # one decode in flight: batch k's download and host assembly overlap
        # batch k+1's decode (JAX :203-211)
        for handles, batch in self._in_flight(loader, INPUT_KEYS):
            consume(handles, batch)
        return self._write_predictions(predictions, time.time() - t0, image_ids)

    def predict_file(self, image_file=None, lidar_file=None, out_file="prediction.png"):
        """Polygons of one tile's image and/or LiDAR file, drawn over the
        image (a blank canvas without one) into `out_file`."""
        self.load_checkpoint()
        batch, image = self.file_inputs(image_file, lidar_file)
        polys, _ = self.predict_batch(batch)
        self.plot_prediction(image, polys[0], out_file)
        return polys[0]
