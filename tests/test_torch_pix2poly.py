"""The port's Pix2Poly modules against the JAX package's, on the CPU, at
float32 with weights bridged from the flax tree (`utils/bridge.py`):
adaptive pooling, attention with causal and padding masks, the ViT encoder,
Sinkhorn, the teacher-forced forward, the greedy decode in both modes, the
tokenizer and the config-built model; and the port's own properties of the
KV-cached decode (equal to full re-forwards) and of its early exit (equal
to the fixed length).

Tolerances and why: both sides compute in float32 with the same operations
in the same order up to the summation order of matrix products, and
`logsumexp`'s, so outputs agree to a few ulps of their magnitude: 1e-5
absolute on values of order 1 (tokens, logits, the Sinkhorn log coupling
and its softmax, attention). The raw scores of the decode pass the 2D →
256 → 128 → 64 → 1 MLP twice and are compared at 1e-4, as the JAX
package's own early-exit test does. Generated tokens are argmaxes and must
be identical.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.models import layers as jax_layers
from pixelspointspolygons_tpu.models.pix2poly import Pix2Poly as JaxPix2Poly
from pixelspointspolygons_tpu.models.pix2poly import ScoreNet as JaxScoreNet
from pixelspointspolygons_tpu.models.pix2poly import build_pix2poly as jax_build_pix2poly
from pixelspointspolygons_tpu.models.pix2poly import factory as jax_factory
from pixelspointspolygons_tpu.models.pix2poly import Tokenizer as JaxTokenizer
from pixelspointspolygons_tpu.models.pix2poly import greedy_generate as jax_greedy_generate
from pixelspointspolygons_tpu.models.vit import ViTEncoder as JaxViTEncoder
from pixelspointspolygons_tpu.ops.sinkhorn import log_optimal_transport as jax_log_optimal_transport
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.models import layers
from pixelspointspolygons_torch.models.pix2poly import (
    Pix2Poly,
    Tokenizer,
    build_pix2poly,
    greedy_decode,
    greedy_generate,
)
from pixelspointspolygons_torch.models.pix2poly import factory
from pixelspointspolygons_torch.models.pix2poly import model as p2p_model
from pixelspointspolygons_torch.models.vit import ViTEncoder
from pixelspointspolygons_torch.ops.sinkhorn import log_optimal_transport
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_train_pix2poly import flax_init

# tests/test_pix2poly.py::tiny_model_and_vars
TINY = dict(vocab_size=19, encoder_len=16, dim=32, num_heads=4, num_layers=2, max_len=12, pad_idx=18,
            max_num_vertices=5, sinkhorn_iterations=10)
TINY_ENC = {"name": "vit", "img_size": 16, "patch_size": 4, "dim": 32, "depth": 1, "num_heads": 2}
BOS, EOS, PAD = 16, 17, 18
STEPS = TINY["max_len"] - 1


def _port(module, variables):
    sd = flax_to_state_dict(variables["params"], variables.get("batch_stats"))
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _vary(variables, eos_bias, seed=6):
    """Flax's init gives every position nearly the same decoder input, so
    the greedy decode repeats one token. Unit-scale embeddings, position
    embeddings, ScoreNet statistics and an EOS bias make the tokens vary and
    rows stop at different steps."""
    v = copy.deepcopy(jax.device_get(variables))
    r = np.random.RandomState(seed)
    dec = v["params"]["decoder"]
    for k in ("decoder_pos_embed", "encoder_pos_embed"):
        dec[k] = r.normal(size=dec[k].shape).astype(np.float32)
    dec["embedding"]["embedding"] = r.normal(size=dec["embedding"]["embedding"].shape).astype(np.float32)
    bias = np.zeros(TINY["vocab_size"], np.float32)
    bias[EOS] = eos_bias
    dec["output"]["bias"] = bias
    for sn in ("scorenet1", "scorenet2"):
        for name, st in v["batch_stats"][sn].items():
            st["mean"] = r.normal(0, 0.3, st["mean"].shape).astype(np.float32)
            st["var"] = r.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
            bn = v["params"][sn][name]
            bn["scale"] = r.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
            bn["bias"] = r.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def tiny():
    jm = JaxPix2Poly(**TINY, encoder_cfg=TINY_ENC)
    images = np.random.RandomState(0).normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = np.zeros((2, STEPS), np.int32)
    variables = _vary(jm.init(jax.random.PRNGKey(0), {"images": jnp.asarray(images[:2])}, jnp.asarray(y)), 1.5)
    pm = _port(Pix2Poly(**TINY, encoder_cfg=TINY_ENC), variables)
    return {"jm": jm, "pm": pm, "variables": variables, "images": images}


# --- layers ----------------------------------------------------------------


@pytest.mark.parametrize("in_size,out_size", [(384, 256), (7, 3), (10, 10), (5, 8)])
def test_adaptive_avg_pool1d_matches_jax(in_size, out_size):
    x = np.random.RandomState(in_size).normal(size=(2, 7, in_size)).astype(np.float32)
    want = np.asarray(jax_layers.adaptive_avg_pool1d(jnp.asarray(x), out_size))
    got = layers.adaptive_avg_pool1d(torch.from_numpy(x), out_size).numpy()
    assert got.shape == want.shape == (2, 7, out_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_multi_head_attention_matches_jax(kind):
    """Self-attention under a causal + padding bias (a padded row), and
    cross-attention over a longer memory without one."""
    rng = np.random.RandomState(1)
    B, L, D, H = 2, 7, 32, 4
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    if kind == "self":
        kv = x
        pad = np.zeros((B, L), bool)
        pad[1, 4:] = True
        jbias = jax_layers.causal_bias(L) + jax_layers.padding_bias(jnp.asarray(pad))
        pbias = layers.causal_bias(L) + layers.padding_bias(torch.from_numpy(pad))
        np.testing.assert_array_equal(pbias.numpy(), np.asarray(jbias))
    else:
        kv = rng.normal(size=(B, 9, D)).astype(np.float32)
        jbias = pbias = None
    jmha = jax_layers.MultiHeadAttention(D, H)
    params = jmha.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(kv), jbias)
    want = np.asarray(jmha.apply(params, jnp.asarray(x), jnp.asarray(kv), jbias))
    pmha = _port(layers.MultiHeadAttention(D, H), params)
    with torch.no_grad():
        got = pmha(torch.from_numpy(x), torch.from_numpy(kv), pbias).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layer_scale", [False, True])
def test_vit_encoder_matches_jax(layer_scale):
    """Patch order (NHWC conv flattened row-major vs NCHW), CLS, position
    embeddings, pre-norm blocks with LayerNorm eps 1e-6, exact GELU, the
    final norm, dropping CLS and the channel pool 32 → 24."""
    kw = dict(img_size=16, patch_size=4, dim=32, depth=2, num_heads=2, out_dim=24, layer_scale=layer_scale)
    images = np.random.RandomState(4).normal(size=(2, 16, 16, 3)).astype(np.float32)
    jenc = JaxViTEncoder(**kw)
    variables = jax.device_get(jenc.init(jax.random.PRNGKey(3), jnp.asarray(images)))
    r = np.random.RandomState(5)
    vit = variables["params"]["vit"]
    vit["pos_embed"] = r.normal(size=vit["pos_embed"].shape).astype(np.float32)
    for i in range(2):
        for k in ("ls1", "ls2"):
            if k in vit[f"block{i}"]:
                vit[f"block{i}"][k] = r.uniform(0.5, 1.5, vit[f"block{i}"][k].shape).astype(np.float32)
    want = np.asarray(jenc.apply(variables, jnp.asarray(images)))
    penc = _port(ViTEncoder(**kw), variables)
    with torch.no_grad():
        got = penc(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 16, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- Sinkhorn ----------------------------------------------------------------


@pytest.mark.parametrize("b,m,n,iters", [(2, 5, 5, 10), (3, 7, 6, 100)])
def test_log_optimal_transport_matches_jax(b, m, n, iters):
    rng = np.random.RandomState(m * n)
    scores = (rng.normal(size=(b, m, n)) * 3).astype(np.float32)
    want = np.asarray(jax_log_optimal_transport(jnp.asarray(scores), jnp.float32(0.7), iters))
    got = log_optimal_transport(torch.from_numpy(scores), torch.tensor(0.7), iters).numpy()
    assert got.shape == (b, m + 1, n + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- the model -------------------------------------------------------------


def test_bridged_tree_loads_exactly(tiny):
    """Every flax leaf has a port parameter or buffer of its shape, and the
    reverse (`load_state_dict(strict=True)` in the fixture)."""
    sd = flax_to_state_dict(tiny["variables"]["params"], tiny["variables"]["batch_stats"])
    assert {"bin_score", "decoder.embedding.weight", "decoder.layer1.ffn.dense1.weight",
            "encoder.vit.block0.attn.q.weight", "encoder.vit.block0.ln1.weight",
            "scorenet2.bn2.running_var", "scorenet1.dense3.bias"} <= set(sd)
    assert sd["bin_score"].shape == ()
    np.testing.assert_array_equal(
        sd["decoder.output.weight"].numpy(), np.asarray(tiny["variables"]["params"]["decoder"]["output"]["kernel"]).T
    )


def test_teacher_forced_matches_jax(tiny):
    """Logits and the Sinkhorn permutation of the teacher-forced forward on
    sequences with a PAD tail."""
    rng = np.random.RandomState(6)
    y = rng.randint(0, 16, (2, STEPS)).astype(np.int32)
    y[:, 0] = BOS
    y[1, 6] = EOS
    y[1, 7:] = PAD
    images = tiny["images"][:2]
    jl, jperm = tiny["jm"].apply(tiny["variables"], {"images": jnp.asarray(images)}, jnp.asarray(y))
    with torch.no_grad():
        pl, pperm = tiny["pm"]({"images": torch.from_numpy(images)}, torch.from_numpy(y).long())
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pperm.numpy(), np.asarray(jperm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pperm.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("raw_scores", [True, False])
@pytest.mark.parametrize("eos_code", [None, EOS])
def test_greedy_generate_matches_jax(tiny, eos_code, raw_scores):
    images = tiny["images"]
    jm = tiny["jm"]
    jt, js = jax.jit(
        lambda v, im: jax_greedy_generate(jm, v, {"images": im}, BOS, STEPS, raw_scores=raw_scores, eos_code=eos_code)
    )(tiny["variables"], jnp.asarray(images))
    with torch.no_grad():
        pt, ps = greedy_generate(tiny["pm"], {"images": torch.from_numpy(images)}, BOS, STEPS,
                                 raw_scores=raw_scores, eos_code=eos_code)
    jt = np.asarray(jt)
    np.testing.assert_array_equal(pt.numpy(), jt)
    assert len(np.unique(jt)) > 3  # the tokens vary
    first_eos = [int(np.nonzero(r == EOS)[0][0]) if (r == EOS).any() else STEPS for r in jt]
    assert len(set(first_eos)) > 1 and min(first_eos) < STEPS  # rows stop at different steps
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-4 if raw_scores else 1e-5)


def test_decode_takes_the_first_maximum():
    """Tied logits: torch.argmax and jnp.argmax both pick the lower index."""
    logits = np.array([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
    np.testing.assert_array_equal(torch.argmax(torch.from_numpy(logits), -1).numpy(), np.asarray(jnp.argmax(logits, -1)))


# --- the port's own decode properties ---------------------------------------


def _port_model(max_num_vertices, seed=0):
    """A port-only tiny Pix2Poly from flax's default init, with unit-scale
    position embeddings (see `_vary`)."""
    kw = {**TINY, "max_len": 2 * max_num_vertices + 2, "max_num_vertices": max_num_vertices}
    model = Pix2Poly(**kw, encoder_cfg=TINY_ENC)
    g = torch.Generator().manual_seed(seed)
    layers.init_flax_defaults(model, g)
    with torch.no_grad():
        for p in (model.decoder.decoder_pos_embed, model.decoder.encoder_pos_embed, model.decoder.embedding.weight):
            p.copy_(torch.randn(p.shape, generator=g))
    return model.eval()


def _raise_eos_bias(model, enc, by_step: int) -> None:
    """Raise the output bias of EOS just enough that every row emits EOS by
    `by_step`: a row stops where its gap between the top logit and EOS's
    first falls below the raise, so rows stop at different steps. The tokens
    before that step do not change."""
    with torch.no_grad():
        _, feats, _ = greedy_decode(model, enc, BOS, model.max_len - 1)
        logits = model.decoder.output(feats)
        gap = logits.max(dim=-1).values - logits[..., EOS]
        model.decoder.output.bias[EOS] += float(gap[:, :by_step].min(dim=1).values.max()) + 1e-3


def test_kv_cache_matches_full_forward():
    """The cached decode equals the argmax chain of teacher-forced full
    re-forwards (tests/test_pix2poly.py::test_kv_cache_matches_full_forward).
    PAD is never emitted here: a PAD input is a masked key in the full
    forward and an ordinary one in the cache."""
    model = _port_model(8, seed=1)
    with torch.no_grad():
        model.decoder.output.bias[PAD] = -30.0
        images = torch.from_numpy(np.random.RandomState(7).normal(size=(3, 16, 16, 3)).astype(np.float32))
        steps = model.max_len - 1
        tokens, _ = greedy_generate(model, {"images": images}, BOS, steps)
        enc = model.encode({"images": images})
        cur = torch.full((3, 1), BOS, dtype=torch.long)
        ref = []
        for _ in range(steps):
            tgt = torch.cat([cur, torch.full((3, steps - cur.shape[1]), PAD, dtype=torch.long)], dim=1)
            logits, _ = model.decoder(enc, tgt)
            nxt = torch.argmax(logits[:, cur.shape[1] - 1], dim=-1)
            ref.append(nxt)
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(tokens.numpy(), torch.stack(ref, 1).numpy())
    assert len(torch.unique(tokens)) > 3


def _stops(tokens: np.ndarray, steps: int) -> list[int]:
    return [int(np.nonzero(r == EOS)[0][0]) + 1 if (r == EOS).any() else steps for r in tokens]


@pytest.mark.parametrize("check_every", [1, 5, p2p_model.EXIT_CHECK_EVERY])
def test_early_exit_matches_fixed_length(check_every, monkeypatch):
    """Rows stop at different steps. Up to each row's first EOS the early
    exit gives the fixed-length decode's tokens and feats, then PAD and
    zeros; the raw scores over the vertices decoded before EOS agree to 1e-4
    (tests/test_pix2poly.py::test_early_exit_matches_scan). The loop exits
    at the first multiple of `check_every` past the last row's EOS, and the
    steps it runs past that EOS change nothing: every `check_every` gives
    the same tokens and feats."""
    model = _port_model(20, seed=2)
    steps = model.max_len - 1  # 41
    images = torch.from_numpy(np.random.RandomState(8).normal(size=(4, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        enc = model.encode({"images": images})
        _raise_eos_bias(model, enc, by_step=25)
        ref_tokens, ref_feats, ref_steps = greedy_decode(model, enc, BOS, steps)
        monkeypatch.setattr(p2p_model, "EXIT_CHECK_EVERY", 1)
        base_tokens, base_feats, _ = greedy_decode(model, enc, BOS, steps, eos_code=EOS)
        monkeypatch.setattr(p2p_model, "EXIT_CHECK_EVERY", check_every)
        tokens, feats, ran = greedy_decode(model, enc, BOS, steps, eos_code=EOS)
        ref_scores = model.raw_scores_from_feats(ref_feats).numpy()
        scores = model.raw_scores_from_feats(feats).numpy()
    stops = _stops(ref_tokens.numpy(), steps)
    assert ref_steps == steps and len(set(stops)) > 2 and max(stops) <= 25
    assert ran == -(-max(stops) // check_every) * check_every < steps
    torch.testing.assert_close(tokens, base_tokens, rtol=0, atol=0)
    torch.testing.assert_close(feats, base_feats, rtol=0, atol=0)
    for b, stop in enumerate(stops):
        np.testing.assert_array_equal(tokens[b, :stop].numpy(), ref_tokens[b, :stop].numpy())
        assert (tokens[b, stop:] == PAD).all() and (feats[b, stop:] == 0).all()
        np.testing.assert_allclose(feats[b, :stop].numpy(), ref_feats[b, :stop].numpy(), rtol=0, atol=1e-6)
        # vertex v is fed tokens 2v, 2v+1: feats 2v+1, 2v+2, the last of
        # the (stop - 1) // 2 vertices before EOS at the EOS step itself
        nv = (stop - 1) // 2
        np.testing.assert_allclose(scores[b, :nv, :nv], ref_scores[b, :nv, :nv], rtol=0, atol=1e-4)


# --- tokenizer and the config-built model ----------------------------------


@pytest.mark.parametrize("run_type", ["debug", "release"])
def test_tokenizer_matches_jax(run_type):
    """Tokens, shuffling (reversed in debug runs, drawn from the item's rng
    otherwise), padding, decoding and the config write-back."""
    jcfg = jax_compose(["experiment=p2p_image", f"run_type={run_type}"])
    cfg = compose(["experiment=p2p_image", f"run_type={run_type}"])
    jt, pt = JaxTokenizer(jcfg), Tokenizer(cfg)
    tk = cfg.experiment.model.tokenizer
    assert (tk.pad_idx, tk.max_len, tk.generation_steps) == (226, 386, 385)
    assert cfg.to_dict() == jcfg.to_dict()
    rng = np.random.RandomState(9)
    for n in (0, 1, 7, 200):
        coords = rng.uniform(0, 224, (n, 2))
        for shuffle in (False, True):
            want, widx = jt(coords.copy(), shuffle=shuffle, rng=np.random.RandomState(n))
            got, gidx = pt(coords.copy(), shuffle=shuffle, rng=np.random.RandomState(n))
            assert got == want
            np.testing.assert_array_equal(gidx, widx)
            np.testing.assert_array_equal(pt.pad(got), jt.pad(want))
            np.testing.assert_array_equal(pt.decode(pt.pad(got)), jt.decode(jt.pad(want)))
    # BOS stripped at the head only, PAD dropped everywhere, cut at the first EOS
    seq = np.array([pt.BOS_code, 5, pt.PAD_code, 6, pt.BOS_code, 7, pt.EOS_code, 9, 9])
    np.testing.assert_array_equal(pt.decode(seq), jt.decode(seq))
    assert pt.decode(seq).shape == (2, 2)  # (5, 6) and (BOS, 7)


def test_build_pix2poly_matches_the_flax_tree():
    """The full-width p2p_image model (ViT-S/8 at 224 px, 6-layer decoder,
    192 vertex slots) has exactly the shapes of the JAX model's variables
    once bridged, and flax's default init."""
    jcfg = jax_compose(["experiment=p2p_image", "run_type=debug"])
    cfg = compose(["experiment=p2p_image", "run_type=debug"])
    jm = jax_build_pix2poly(jcfg)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), {"images": jnp.zeros((1, 224, 224, 3))}, jnp.zeros((1, 385), jnp.int32)
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(zeros["params"], zeros["batch_stats"]).items()}
    model = build_pix2poly(cfg, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert (model.vocab_size, model.max_len, model.dim, model.max_num_vertices) == (227, 386, 256, 192)
    assert sd["decoder.encoder_pos_embed"].shape == (1, 784, 256)
    assert float(sd["bin_score"]) == 1.0
    assert 0.018 < float(sd["decoder.decoder_pos_embed"].std()) < 0.022
    w = sd["decoder.layer0.ffn.dense0.weight"]  # lecun_normal, fan_in 256, cut at 2σ
    sigma = (1 / 256) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * sigma + 1e-7 and abs(float(w.std()) - 256 ** -0.5) < 0.002
    assert float(sd["decoder.layer0.ffn.dense0.bias"].abs().max()) == 0.0
    assert float(sd["decoder.layer0.norm1.weight"].min()) == 1.0


@pytest.mark.parametrize("experiment", ["p2p_lidar", "p2p_fusion"])
def test_lidar_and_fusion_encoders_build_and_run(experiment):
    """`pointpillars_vit` and `early_fusion_vit` (the full-width trunk at a
    16 px input): the encoder config equals JAX's, and the teacher-forced
    forward runs on the modality's inputs."""
    args = [f"experiment={experiment}", "run_type=debug", "experiment.encoder.in_size=16",
            "experiment.encoder.max_num_points=64"]
    cfg = compose(args)
    assert factory.encoder_config(cfg) == jax_factory.encoder_config(jax_compose(args))
    model = build_pix2poly(cfg, generator=torch.Generator().manual_seed(0))
    assert type(model.encoder) is p2p_model.ENCODERS[cfg.experiment.encoder.name]
    r = np.random.RandomState(4)
    batch = {"lidar": torch.from_numpy(r.uniform(0, 16, (2, 64, 3)).astype(np.float32)),
             "lidar_mask": torch.from_numpy(r.rand(2, 64) < 0.9)}
    if experiment == "p2p_fusion":
        batch["images"] = torch.from_numpy(r.normal(size=(2, 16, 16, 3)).astype(np.float32))
    y = torch.full((2, model.max_len - 1), model.pad_idx, dtype=torch.long)
    with torch.no_grad():
        logits, perm = model.eval()(batch, y)
    assert logits.shape == (2, model.max_len - 1, model.vocab_size) and torch.isfinite(perm).all()


def test_lidar_batch_encodes_as_jax():
    """A LiDAR batch through `Pix2Poly.encode` (the `pointpillars_vit`
    tokens), against JAX's `encode` from the same bridged weights (float32
    sums in another order through the PFN and one ViT block: 2e-5)."""
    enc = {"name": "pointpillars_vit", "img_size": 16, "patch_size": 4, "dim": 32, "depth": 1, "num_heads": 2,
           "width": 16.0, "height": 16.0, "voxel_x": 4.0, "voxel_y": 4.0, "max_points_per_voxel": 8}
    r = np.random.RandomState(9)
    batch = {"lidar": r.uniform(0, 16, (2, 64, 3)).astype(np.float32), "lidar_mask": r.rand(2, 64) < 0.9}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxPix2Poly(**TINY, encoder_cfg=enc)
    variables = flax_init(jm, jbatch, jnp.zeros((2, STEPS), jnp.int32), seed=2)
    want = jax.jit(lambda v, b: jm.apply(v, b, method=jm.encode))(variables, jbatch)
    pm = _port(Pix2Poly(**TINY, encoder_cfg=enc), variables)
    with torch.no_grad():
        got = pm.encode({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_scorenet_batchnorm_trains_channel_last():
    """In training the ScoreNet's BatchNorm takes batch statistics over every
    axis but the channel axis and updates flax's running statistics."""
    rng = np.random.RandomState(10)
    D = 8
    feats = rng.normal(size=(2, 7, D)).astype(np.float32)
    jsn = JaxScoreNet(3)
    variables = jsn.init(jax.random.PRNGKey(11), jnp.asarray(feats))
    want, upd = jsn.apply(variables, jnp.asarray(feats), train=True, mutable=["batch_stats"])
    psn = _port(p2p_model.ScoreNet(3, D), jax.device_get(variables)).train()
    got = psn(torch.from_numpy(feats))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for i in range(3):
        st = jax.device_get(upd["batch_stats"])[f"BatchNorm_{i}"]
        bn = getattr(psn, f"bn{i}")
        np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), st["var"], rtol=0, atol=1e-6)
