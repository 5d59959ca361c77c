"""Vertex tokenizer: polygon corners <-> discrete token sequences — the
port's copy of pixelspointspolygons_tpu/models/pix2poly/tokenizer.py.

Behavioral spec (reference models/pix2poly/tokenizer.py:4-97, re-implemented):
- quantize coords in [0,1] to num_bins levels: round(x * (bins-1));
- vocab = bins + {BOS, EOS, PAD}; sequence = BOS, (y, x)*, EOS, PAD...;
- max_len = 2 * max_num_vertices + 2; generation_steps = max_len - 1;
- decode drops PAD, strips BOS/EOS, dequantizes by /(bins-1);
- derived sizes are written back into cfg (pad_idx/max_len/generation_steps)
  because the collate fn and predictor read them from there (tokenizer.py:25-27).

Host-side numpy (runs in the input pipeline); the device only ever sees
fixed-length token sequences.
"""

from __future__ import annotations

import numpy as np

TOKEN_MODE = 2  # (y, x) pairs


class Tokenizer:
    def __init__(self, cfg):
        self.cfg = cfg
        tk = cfg.experiment.model.tokenizer
        self.num_bins = int(tk.num_bins)
        self.width = int(cfg.experiment.encoder.in_width)
        self.height = int(cfg.experiment.encoder.in_height)
        self.max_num_vertices = int(tk.max_num_vertices)
        self.max_len = self.max_num_vertices * TOKEN_MODE + 2

        self.BOS_code = self.num_bins
        self.EOS_code = self.BOS_code + 1
        self.PAD_code = self.EOS_code + 1
        self.vocab_size = self.num_bins + 3

        tk.pad_idx = self.PAD_code
        tk.max_len = self.max_len
        tk.generation_steps = self.max_num_vertices * TOKEN_MODE + 1

    def quantize(self, x: np.ndarray) -> np.ndarray:
        return np.rint(x * (self.num_bins - 1)).astype(np.int64)

    def dequantize(self, x: np.ndarray) -> np.ndarray:
        return x.astype(np.float32) / (self.num_bins - 1)

    def __call__(self, coords: np.ndarray, shuffle: bool = True, rng: np.random.RandomState | None = None):
        """coords: (V, 2) in (y, x) pixel coords. Returns (token list, perm idxs)."""
        coords = np.asarray(coords, np.float64).copy()
        if len(coords) > 0:
            coords[:, 0] = coords[:, 0] / self.height
            coords[:, 1] = coords[:, 1] / self.width
        q = self.quantize(coords)[: self.max_num_vertices]

        idxs = np.arange(len(q))
        if shuffle:
            if self.cfg.run_type.name == "debug":
                idxs = idxs[::-1].copy()
            else:
                (rng or np.random).shuffle(idxs)
            q = q[idxs]

        tokens = [self.BOS_code]
        for yx in q:
            tokens.extend(int(t) for t in yx)
        tokens.append(self.EOS_code)
        return tokens, idxs

    def pad(self, tokens: list[int]) -> np.ndarray:
        out = np.full((self.max_len,), self.PAD_code, np.int32)
        out[: len(tokens)] = tokens[: self.max_len]
        return out

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (L,) int array → (V, 2) float (y, x) pixel coords."""
        tokens = np.asarray(tokens)
        tokens = tokens[tokens != self.PAD_code]
        # strip BOS and everything from EOS on
        if len(tokens) and tokens[0] == self.BOS_code:
            tokens = tokens[1:]
        eos = np.nonzero(tokens == self.EOS_code)[0]
        if len(eos):
            tokens = tokens[: eos[0]]
        n = (len(tokens) // TOKEN_MODE) * TOKEN_MODE
        coords = self.dequantize(tokens[:n].reshape(-1, TOKEN_MODE).astype(np.int64))
        if len(coords) > 0:
            coords[:, 0] = coords[:, 0] * self.height
            coords[:, 1] = coords[:, 1] * self.width
        return coords
