"""The floating-point operations a Pix2Poly forward needs, from the
configuration's sizes (`configs/<config>.json`, "sizes"). A product of an
(m, k) and a (k, n) matrix counts 2·m·k·n; attention counts the positions a
query may see (the causal half in the decoder); the ScoreNets count every
vertex pair; Sinkhorn counts 5 operations an element of its (V+1, V+1)
coupling per half-iteration (add, max, subtract, exp, sum); the pooling of
the PillarFeatureNet counts the valid points only, not the padding. Norms,
activations and the softmax are left out (a few operations an element, far
below the products). Training counts three times the forward (the backward
twice), no recompute."""

from __future__ import annotations


def matmul(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def vit(s: dict, tokens: int) -> int:
    """The ViT trunk over `tokens` patch tokens and the CLS token."""
    d, L = s["vit_dim"], tokens + 1
    per_block = (matmul(L, d, 3 * d) + 2 * matmul(L, d, L) + matmul(L, d, d)
                 + matmul(L, d, s["vit_mlp_ratio"] * d) + matmul(L, s["vit_mlp_ratio"] * d, d))
    return s["vit_depth"] * per_block


def patch_embed(s: dict) -> int:
    p = s["patch_size"]
    return matmul(s["num_patches"], 3 * p * p, s["vit_dim"])


def decoder_step(s: dict, position: int) -> int:
    """One cached greedy step at 0-based `position`: self-attention over
    position + 1 slots, cross-attention over the encoder tokens, the FFN and
    the output head."""
    d, n_mem = s["decoder_dim"], s["num_patches"]
    per_layer = (matmul(1, d, 4 * d) + 2 * matmul(1, d, position + 1)
                 + matmul(1, d, 2 * d) + 2 * matmul(1, d, n_mem)
                 + matmul(1, d, s["decoder_ffn"]) + matmul(1, s["decoder_ffn"], d))
    return s["decoder_layers"] * per_layer + matmul(1, d, s["vocab_size"])


def memory_kv(s: dict) -> int:
    """The cross-attention keys and values of the encoder tokens, once."""
    d = s["decoder_dim"]
    return s["decoder_layers"] * matmul(s["num_patches"], d, 2 * d)


def decoder_teacher(s: dict, length: int) -> int:
    """The teacher-forced pass over `length` positions (causal attention)."""
    d, n_mem, L = s["decoder_dim"], s["num_patches"], length
    seen = L * (L + 1) // 2
    per_layer = (matmul(L, d, 4 * d) + 4 * seen * d + matmul(L, d, 2 * d) + 2 * matmul(L, d, n_mem)
                 + matmul(L, d, s["decoder_ffn"]) + matmul(L, s["decoder_ffn"], d))
    return s["decoder_layers"] * per_layer + memory_kv(s) + matmul(L, d, s["vocab_size"])


def scorenets(s: dict) -> int:
    """Both ScoreNets over every vertex pair."""
    V, d = s["max_vertices"], s["decoder_dim"]
    per_pair = matmul(1, 2 * d, 256) + matmul(1, 256, 128) + matmul(1, 128, 64) + matmul(1, 64, 1)
    return 2 * V * V * per_pair


def sinkhorn(s: dict) -> int:
    V = s["max_vertices"] + 1
    return s["sinkhorn_iterations"] * 2 * 5 * V * V


def pfn(s: dict, points: int) -> int:
    """The PillarFeatureNet's layers over `points` valid points."""
    total, cin = 0, 8
    for c in s["pfn_channels"]:
        total += matmul(points, cin, c)
        cin = 2 * c
    return total


def fusion_conv(s: dict) -> int:
    d = s["vit_dim"]
    return matmul(s["num_patches"], 2 * d * 9, d)


def encoder(s: dict, points: int = 0) -> int:
    """The encoder of one tile (`points` valid LiDAR points under fusion)."""
    total = patch_embed(s) + vit(s, s["num_patches"])
    if s["encoder"] == "early_fusion_vit":
        total += pfn(s, points) + fusion_conv(s)
    return total


def predict_tile(s: dict, steps: int) -> int:
    """Encoder, `steps` cached decode steps and the ScoreNets of one tile."""
    return (encoder(s) + memory_kv(s) + sum(decoder_step(s, t) for t in range(steps)) + scorenets(s))


def train_tile(s: dict, points: int = 0) -> int:
    """Forward and backward of one tile's teacher-forced step."""
    forward = encoder(s, points) + decoder_teacher(s, s["max_len"] - 1) + scorenets(s) + sinkhorn(s)
    return 3 * forward
