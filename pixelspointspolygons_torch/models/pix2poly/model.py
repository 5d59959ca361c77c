"""Pix2Poly: autoregressive vertex-token transformer + Sinkhorn permutation —
port of pixelspointspolygons_tpu/models/pix2poly/model.py (:35-357).

- `DecoderLayer`: post-norm (self-attention → LN, cross-attention → LN,
  ReLU FFN → LN), with the explicit attention of `layers.py`, so the same
  weights serve the teacher-forced pass and the KV-cached decode.
- `Decoder.decode_step` writes position `pos`, a device tensor, of
  preallocated (B, T, D) self-attention caches, one pair per layer, in
  place and attends over all T slots, the slots after `pos` masked at
  −1e9, as the JAX step does.
- `ScoreNet`: the 1x1-conv stack over vertex pairs as a per-pair MLP over a
  (B, V, V, 2D) tensor; its BatchNorm normalizes the channel-last axis.
- `greedy_decode` / `greedy_generate`: greedy decoding with the KV cache,
  in the fixed-length mode of `bench.py` or with an early exit at EOS; on
  the card each step after the first is a replay of the step captured in a
  CUDA graph, bitwise the step run as it is.
- encoders (JAX :200-232): `vit` (`models/vit.py::ViTEncoder`), the LiDAR
  `pointpillars_vit` (`models/pointpillars.py::PointPillarsViTEncoder`) and
  the early-fusion `early_fusion_vit` (`models/fusion.py`), each giving
  (B, N, dim) tokens.

Plain PyTorch: in the JAX package these are XLA fusions, not Pallas
kernels. Hopper kernels are planned for the decode step (K2; its first
step, the step replayed from a CUDA graph, is done), Sinkhorn (K3)
and the ScoreNet pair MLP (K4) (ROADMAP §2). Module names follow the flax
tree (`utils/bridge.py`): flax Dense_i in a ScoreNet is dense{i} here,
BatchNorm_i bn{i}.

`dtype` is the compute dtype of every layer (`layers.py`), as flax's
`dtype=` (JAX model.py): at bfloat16 the position embeddings are cast before
they are added, so the residual stream, the KV caches and the decode's
feats are bfloat16; the logits are bfloat16 and the losses widen them; the
ScoreNets' scores reach the Sinkhorn as float32. The decode casts the
decoder's parameters once per call (`layers.cast_once`), not once per step.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.sinkhorn import log_optimal_transport
from ..fusion import EarlyFusionViTEncoder
from ..layers import (
    BatchNorm,
    Dense,
    Embed,
    LayerNorm,
    MlpBlock,
    MultiHeadAttention,
    cast_to,
    cast_once,
    causal_bias,
    encode_modalities,
    padding_bias,
    widen,
)
from ..pointpillars import PointPillarsViTEncoder
from ..vit import ViTEncoder

ENCODERS = {"vit": ViTEncoder, "pointpillars_vit": PointPillarsViTEncoder, "early_fusion_vit": EarlyFusionViTEncoder}

# the early-exit decode tests "every row emitted EOS" on the host once in
# this many steps; the steps it runs past the last EOS change nothing
EXIT_CHECK_EVERY = 16


class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer (torch nn.TransformerDecoderLayer
    defaults: self-attn → LN, cross-attn → LN, ReLU FFN → LN)."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int = 2048, dtype=None, device=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype=dtype, device=device)
        self.cross_attn = MultiHeadAttention(dim, num_heads, dtype=dtype, device=device)
        self.ffn = MlpBlock(dim, ffn_dim, dim, activation="relu", dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.norm3 = LayerNorm(dim, dtype=dtype, device=device)

    def forward(self, x, memory, self_bias, mem_bias=None):
        x = self.norm1(x + self.self_attn(x, x, self_bias))
        x = self.norm2(x + self.cross_attn(x, memory, mem_bias))
        return self.norm3(x + self.ffn(x))

    def step(self, x, self_k, self_v, cross_k, cross_v, self_bias):
        """x: (B, 1, D) the current position; self_k/v: (B, T, D) caches
        holding it; cross_k/v: the memory's projections."""
        x = self.norm1(x + self.self_attn.attend(x, self_k, self_v, self_bias))
        x = self.norm2(x + self.cross_attn.attend(x, cross_k, cross_v))
        return self.norm3(x + self.ffn(x))


class Decoder(nn.Module):
    """Token decoder with learned decoder/encoder position embeddings.
    `max_len` counts BOS..EOS; the decoder runs on max_len − 1 positions."""

    def __init__(self, vocab_size: int, encoder_len: int, dim: int, num_heads: int, num_layers: int,
                 max_len: int, pad_idx: int, dtype=None, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.max_len = max_len
        self.pad_idx = pad_idx
        self.compute_dtype = dtype
        self.cached = None  # set by cast_once
        self.embedding = Embed(vocab_size, dim, dtype=dtype, device=device)
        self.decoder_pos_embed = nn.Parameter(torch.zeros(1, max_len - 1, dim, device=device))
        self.encoder_pos_embed = nn.Parameter(torch.zeros(1, encoder_len, dim, device=device))
        for i in range(num_layers):
            self.add_module(f"layer{i}", DecoderLayer(dim, num_heads, dtype=dtype, device=device))
        self.output = Dense(dim, vocab_size, dtype=dtype, device=device)

    def reset_flax_parameters(self, generator=None) -> None:
        with torch.no_grad():
            nn.init.normal_(self.decoder_pos_embed, 0.0, 0.02, generator=generator)
            nn.init.normal_(self.encoder_pos_embed, 0.0, 0.02, generator=generator)

    def layers(self) -> list[DecoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def cast_params(self) -> tuple:
        return (cast_to(self.decoder_pos_embed, self.compute_dtype),)

    def forward(self, encoder_out: torch.Tensor, tgt: torch.Tensor):
        """Teacher-forced pass. encoder_out: (B, N, D); tgt: (B, L) int.
        Returns (logits (B, L, V), features (B, L, D))."""
        L = tgt.shape[1]
        x = self.embedding(tgt)
        x = x + cast_to(self.decoder_pos_embed[:, :L], x.dtype)
        memory = encoder_out + cast_to(self.encoder_pos_embed, encoder_out.dtype)
        bias = causal_bias(L, x.dtype, x.device) + padding_bias(tgt == self.pad_idx, x.dtype)
        for layer in self.layers():
            x = layer(x, memory, bias)
        return self.output(x), x

    def init_memory_kv(self, encoder_out: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        memory = encoder_out + cast_to(self.encoder_pos_embed, encoder_out.dtype)
        return [layer.cross_attn.project_kv(memory) for layer in self.layers()]

    def decode_step(self, tok, pos: torch.Tensor, caches, memory_kv, slot_bias):
        """One greedy step at position `pos`, a (1,) int64 tensor read on the
        device (so that a CUDA graph can replay the step at every position).

        tok: (B,) input tokens; caches: per layer the (B, T, D) self-attention
        K and V, position `pos` written in place; slot_bias: (T, T)
        `causal_bias`, whose row `pos` masks the slots after `pos`. Returns
        (logits (B, V), feats (B, D))."""
        (pos_embed,) = self.cached or self.cast_params()
        x = self.embedding(tok)[:, None, :] + pos_embed.index_select(1, pos)
        bias = slot_bias.index_select(0, pos)[0]
        for layer, (cache_k, cache_v), kv in zip(self.layers(), caches, memory_kv):
            k_cur, v_cur = layer.self_attn.project_kv(x)  # (B, 1, D)
            cache_k.index_copy_(1, pos, k_cur)
            cache_v.index_copy_(1, pos, v_cur)
            x = layer.step(x, cache_k, cache_v, *kv, bias)
        feats = x[:, 0]
        return self.output(feats), feats


class ScoreNet(nn.Module):
    """Vertex-pair scores: (B, L, D) decoder feats → (B, V, V).

    Drop position 0, average the (y, x) token pairs into vertex features,
    concatenate every pair, then Dense 2D→256→128→64 with BatchNorm + ReLU
    and Dense →1 (reference model_pix2poly.py:69-112's 1x1 convs)."""

    def __init__(self, n_vertices: int, dim: int, dtype=None, device=None):
        super().__init__()
        self.n_vertices = n_vertices
        chans = (2 * dim, 256, 128, 64)
        for i in range(3):
            self.add_module(f"dense{i}", Dense(chans[i], chans[i + 1], dtype=dtype, device=device))
            self.add_module(f"bn{i}", BatchNorm(chans[i + 1], dtype=dtype, device=device))
        self.dense3 = Dense(64, 1, dtype=dtype, device=device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats[:, 1:]  # drop the BOS position
        B, L, D = x.shape
        x = x.reshape(B, L // 2, 2, D).mean(dim=2)  # (B, V, D)
        V = self.n_vertices
        x = torch.cat([x[:, :, None, :].expand(B, V, V, D), x[:, None, :, :].expand(B, V, V, D)], dim=-1)
        for i in range(3):
            x = getattr(self, f"dense{i}")(x)
            shape = x.shape
            x = F.relu(getattr(self, f"bn{i}")(x.reshape(-1, shape[-1])).reshape(shape))
        return self.dense3(x)[..., 0]


class Pix2Poly(nn.Module):
    """Encoder-decoder with twin ScoreNets and a Sinkhorn head."""

    def __init__(self, vocab_size: int, encoder_len: int, dim: int, num_heads: int, num_layers: int,
                 max_len: int, pad_idx: int, max_num_vertices: int, sinkhorn_iterations: int = 100,
                 encoder_cfg: dict | None = None, dtype=torch.float32, device=None):
        super().__init__()
        enc_cfg = dict(encoder_cfg or {})
        enc_name = enc_cfg.pop("name", "vit")
        if enc_name not in ENCODERS:
            raise ValueError(f"unknown encoder {enc_name!r} for pix2poly")
        self.vocab_size = vocab_size
        self.dim = dim
        self.num_layers = num_layers
        self.max_len = max_len
        self.pad_idx = pad_idx
        self.max_num_vertices = max_num_vertices
        self.sinkhorn_iterations = sinkhorn_iterations
        self.compute_dtype = dtype
        self.encoder = ENCODERS[enc_name](out_dim=dim, dtype=dtype, device=device, **enc_cfg)
        self.decoder = Decoder(vocab_size, encoder_len, dim, num_heads, num_layers, max_len, pad_idx, dtype=dtype,
                               device=device)
        self.scorenet1 = ScoreNet(max_num_vertices, dim, dtype=dtype, device=device)
        self.scorenet2 = ScoreNet(max_num_vertices, dim, dtype=dtype, device=device)
        self.bin_score = nn.Parameter(torch.tensor(1.0, device=device))

    def encode(self, batch: dict, generator: torch.Generator | None = None) -> torch.Tensor:
        """Tokens (B, N, D) of the batch's images, LiDAR or both (reference
        model_pix2poly.py:245-254); `generator` draws the fusion encoder's
        LiDAR dropout (JAX's "lidar_dropout" rng)."""
        kw = {"generator": generator} if "lidar" in batch and "images" in batch else {}
        return encode_modalities(self.encoder, batch, **kw)

    def raw_scores_from_feats(self, feats: torch.Tensor) -> torch.Tensor:
        """scorenet1 + scorenet2ᵀ: the raw matrix the predictor's Hungarian
        assignment takes (reference predictor_pix2poly.py:205-210)."""
        return self.scorenet1(feats) + self.scorenet2(feats).transpose(1, 2)

    def perm_from_feats(self, feats: torch.Tensor) -> torch.Tensor:
        scores = self.raw_scores_from_feats(feats)
        M, N = scores.shape[1:]
        Z = log_optimal_transport(scores.to(widen(scores.dtype)), self.bin_score, self.sinkhorn_iterations)[:, :M, :N]
        return torch.softmax(Z, dim=-1)

    def forward(self, batch: dict, y_input: torch.Tensor, generator: torch.Generator | None = None):
        """Teacher-forced forward. Returns (seq_logits (B, L, V), perm (B, V, V))."""
        logits, feats = self.decoder(self.encode(batch, generator), y_input)
        return logits, self.perm_from_feats(feats)


def greedy_decode(model: Pix2Poly, enc: torch.Tensor, bos_code: int, generation_steps: int,
                  eos_code: int | None = None) -> tuple[torch.Tensor, torch.Tensor, int]:
    """KV-cached greedy decode from encoder tokens `enc` (B, N, D).

    Returns (tokens (B, T), feats (B, T, D), steps run), T = max_len − 1;
    tokens[:, t] is the token generated at step t (BOS not included). The
    host issues every step without waiting for the device: the position is
    a tensor on the device and no step reads a device value.

    eos_code=None: the fixed-length mode (`bench.py`), `generation_steps`
    steps; feats past them are zero.

    eos_code set: the JAX `while_loop` stops once every row has emitted EOS.
    Here the host tests that only every EXIT_CHECK_EVERY steps, so the loop
    may run up to EXIT_CHECK_EVERY − 1 steps past that point. A row that is
    done emits PAD and zero feats, which is what those positions already
    hold, so the extra steps change neither tokens nor feats and the result
    is identical to the JAX loop's.

    Each step is one in-place function of the device position. On the CPU it
    runs as it is; on a card step 0 runs as it is and every later step is a
    replay of that function captured in a CUDA graph (`_capture`): the same
    kernels on the same values, so the same bits, without the host's cost
    of each of the step's ~300 operations (cuBLAS's configuration for
    ordered results, `device.set_deterministic`, costs each product on the
    host)."""
    return _greedy_decode(model, enc, bos_code, generation_steps, eos_code, capture=enc.is_cuda)


def _greedy_decode(model: Pix2Poly, enc: torch.Tensor, bos_code: int, generation_steps: int,
                   eos_code: int | None, capture: bool) -> tuple[torch.Tensor, torch.Tensor, int]:
    """`greedy_decode`, its steps after the first replayed from a CUDA
    graph with `capture`, else each run as it is (what the card's tests hold
    the graph against)."""
    dec = model.decoder
    B, dev, dt = enc.shape[0], enc.device, enc.dtype
    T = model.max_len - 1
    caches = [tuple(torch.zeros((B, T, model.dim), dtype=dt, device=dev) for _ in "kv") for _ in range(model.num_layers)]
    slot_bias = causal_bias(T, dt, dev)[0, 0]
    tokens = torch.full((B, T), model.pad_idx, dtype=torch.long, device=dev)
    feats = torch.zeros((B, T, model.dim), dtype=dt, device=dev)
    tok = torch.full((B,), bos_code, dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    at = torch.zeros((1,), dtype=torch.long, device=dev)
    with cast_once(dec):
        memory_kv = dec.init_memory_kv(enc)

        def step():
            logits, f = dec.decode_step(tok, at, caches, memory_kv, slot_bias)
            nxt = torch.argmax(logits, dim=-1)  # the first maximum, as jnp.argmax
            if eos_code is not None:
                nxt = nxt.masked_fill(done, model.pad_idx)
                f = f.masked_fill(done[:, None], 0.0)
                done.logical_or_(nxt == eos_code)
            tokens.index_copy_(1, at, nxt[:, None])
            feats.index_copy_(1, at, f[:, None])
            tok.copy_(nxt)

        run, pos = step, 0
        while pos < generation_steps:
            if eos_code is not None and pos and pos % EXIT_CHECK_EVERY == 0 and bool(done.all()):
                break
            at.fill_(pos)
            if capture and pos == 0:
                run = _capture(step)  # runs step 0 too
            else:
                run()
            pos += 1
    return tokens, feats, pos


def _capture(step) -> Callable[[], None]:
    """Run `step` once on a side stream (the warm-up that capture asks
    for), capture it in a CUDA graph, and return the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph.replay


def greedy_generate(model: Pix2Poly, batch: dict, bos_code: int, generation_steps: int,
                    raw_scores: bool = False, eos_code: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode, decode greedily (`greedy_decode`), then the raw scores
    (`raw_scores=True`, the predictor's) or the Sinkhorn permutation.
    Returns (tokens (B, T), scores or perm (B, V, V))."""
    tokens, feats, _ = greedy_decode(model, model.encode(batch), bos_code, generation_steps, eos_code)
    scores = model.raw_scores_from_feats(feats) if raw_scores else model.perm_from_feats(feats)
    return tokens, scores
