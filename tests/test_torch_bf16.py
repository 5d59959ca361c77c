"""The port's Pix2Poly at bfloat16 against the JAX package's `dtype=bfloat16`
on the CPU, with weights bridged from the flax tree (the tiny model of
tests/test_torch_pix2poly.py): Dense, LayerNorm, attention and the MLP, the
ViT encoder, the teacher-forced logits and permutation, the greedy decode,
the raw scores and one train step; then that the decode casts no weight per
step, and `bench_torch.py` at a tiny size.

Both sides keep float32 parameters and round every layer's output to
bfloat16 (8 significant bits: one ulp is 2^-7 of a value's binade). They
round at slightly different places: torch adds a Dense's bias before it
rounds the product (XLA rounds the product, then the sum), and computes
GELU in float32 (XLA in bfloat16). Tolerances and why, in ulps of the
largest |value| compared (measured values in brackets):
- Dense and LayerNorm: 2 ulps [0.5, 0];
- attention and the MLP, two to four Dense layers in series: 4 ulps
  [self 1.25, cross 2.75, MLP 1.12];
- the encoder and the logits: 4 ulps [2, 2.5], through the patch embedding,
  two pre-norm blocks and the pool, or two decoder layers;
- the Sinkhorn permutation (float32, from bfloat16 scores): 3e-2 of its
  largest value [7.2e-3];
- raw scores from the same feats: 4 ulps [0.25];
- generated tokens: argmaxes of bfloat16 logits, which tie far more often
  than float32 ones. The port's tokens equal JAX's up to the first step
  where JAX's top-2 margin is under NEAR_TIE = 4 ulps of logits below 4
  (0.0625): the two sides' logits differ by up to 2.5 ulps, mostly in the
  same direction across a position's tokens (they share the features that
  feed the output layer), so the gap between the top two moves by less
  [48 of 88 tokens compared in the fixed-length mode, 79 of 88 with the
  early exit];
- one train step: the loss within 1e-2 relative [3.8e-3]. A bfloat16
  gradient is far from the float32 one [0.18 for the port's, 0.22 for
  JAX's, relative L2 over all parameters, most of it in the FFN's second
  Dense, whose input is a ReLU of 2048 rounded values], and the two are
  as far apart as two independent roundings [0.21]. So each must be within
  0.35 of the float32 gradient, the port's within 1.5 times JAX's
  distance, and the two within 0.35 of each other.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import bench_torch
from pixelspointspolygons_tpu.models import layers as jax_layers
from pixelspointspolygons_tpu.models.pix2poly import Pix2Poly as JaxPix2Poly
from pixelspointspolygons_tpu.models.pix2poly import greedy_generate as jax_greedy_generate
from pixelspointspolygons_tpu.models.vit import ViTEncoder as JaxViTEncoder
from pixelspointspolygons_tpu.train import pix2poly_step as jax_step
from pixelspointspolygons_torch.models import layers
from pixelspointspolygons_torch.models.pix2poly import Pix2Poly, greedy_decode, greedy_generate
from pixelspointspolygons_torch.models.vit import ViTEncoder
from pixelspointspolygons_torch.train.pix2poly_step import _losses
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_train_pix2poly import BOS, EOS, PAD, PW, TINY, TINY_ENC, VW, flax_init, make_batch, rel_l2, vary

BF = torch.bfloat16
STEPS = TINY["max_len"] - 1
NEAR_TIE = 0.0625


def port(module, variables):
    module.load_state_dict(flax_to_state_dict(variables["params"], variables.get("batch_stats")), strict=True)
    return module.eval()


def ulp(x: float) -> float:
    """One bfloat16 ulp at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def assert_ulps(got: torch.Tensor, want, n: int) -> None:
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= n * ulp(top), f"max abs err {err} > {n} ulps of {top}"


def perturb(variables, seed: int, scale: float):
    """Nonzero biases and LayerNorm affines (flax's init leaves them at 0 and 1)."""
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + scale * r.normal(size=a.shape).astype(np.float32),
                                  jax.device_get(variables))


# --- layers -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "layernorm", "self_attention", "cross_attention", "mlp"])
def test_layer_matches_jax_at_bfloat16(kind):
    r = np.random.RandomState(1)
    B, L, D = 2, 7, 32
    x = r.normal(size=(B, L, D)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(BF)
    if kind == "dense":
        jmod, args, pmod = fnn.Dense(48, dtype=jnp.bfloat16), (xb,), layers.Dense(D, 48, dtype=BF)
    elif kind == "layernorm":
        jmod, args, pmod = fnn.LayerNorm(dtype=jnp.bfloat16), (xb,), layers.LayerNorm(D, dtype=BF)
    elif kind == "mlp":
        jmod, args, pmod = jax_layers.MlpBlock(64, D, dtype=jnp.bfloat16), (xb,), layers.MlpBlock(D, 64, D, dtype=BF)
    else:
        kv = x if kind == "self_attention" else r.normal(size=(B, 9, D)).astype(np.float32)
        jbias = jax_layers.causal_bias(L, jnp.bfloat16) if kind == "self_attention" else None
        pbias = layers.causal_bias(L, BF) if kind == "self_attention" else None
        jmod = jax_layers.MultiHeadAttention(D, 4, dtype=jnp.bfloat16)
        args = (xb, jnp.asarray(kv, jnp.bfloat16), jbias)
        pmod = layers.MultiHeadAttention(D, 4, dtype=BF)
        tx = (tx, torch.from_numpy(kv).to(BF), pbias)
    variables = perturb(flax_init(jmod, *args, seed=2), 3, 0.1)
    want = jax.jit(jmod.apply)(variables, *args)
    if kind in ("dense", "layernorm"):  # flax's own leaf names
        p = variables["params"]
        w = p["kernel"].T if kind == "dense" else p["scale"]
        pmod.load_state_dict({"weight": torch.from_numpy(np.array(w)), "bias": torch.from_numpy(np.array(p["bias"]))})
    else:
        port(pmod, variables)
    with torch.no_grad():
        got = pmod(*tx) if isinstance(tx, tuple) else pmod(tx)
    assert got.dtype == BF and np.asarray(want).dtype == jnp.bfloat16
    assert_ulps(got, want, 2 if kind in ("dense", "layernorm") else 4)


def test_vit_encoder_matches_jax_at_bfloat16():
    """Patch embedding, CLS token and position embeddings cast before they
    are added (a bfloat16 residual stream), two blocks, the final norm and
    the channel pool as a product with a bfloat16 matrix."""
    kw = dict(img_size=16, patch_size=4, dim=32, depth=2, num_heads=2, out_dim=24)
    images = np.random.RandomState(4).normal(size=(2, 16, 16, 3)).astype(np.float32)
    jenc = JaxViTEncoder(**kw, dtype=jnp.bfloat16)
    variables = perturb(flax_init(jenc, jnp.asarray(images), seed=3), 5, 0.05)
    want = jax.jit(jenc.apply)(variables, jnp.asarray(images))
    with torch.no_grad():
        got = port(ViTEncoder(**kw, dtype=BF), variables)(torch.from_numpy(images))
    assert got.dtype == BF and got.shape == (2, 16, 24)
    assert_ulps(got, want, 4)


# --- the model ----------------------------------------------------------------


def _jax_decode_margins(jm, variables, images):
    """JAX's own KV-cached decode step by step (its `_decode_step`, as the
    fixed-length scan calls it): tokens and the top-2 margin of each step's
    logits."""
    memory_kv = jax.jit(lambda v, im: jm.apply(v, jm.apply(v, {"images": im}, method=JaxPix2Poly.encode),
                                               method=JaxPix2Poly._init_memory_kv))(variables, images)
    B = images.shape[0]
    ck = cv = jnp.zeros((TINY["num_layers"], B, STEPS, TINY["dim"]), jnp.bfloat16)
    step = jax.jit(lambda v, tok, pos, ck, cv: jm.apply(v, tok, pos, ck, cv, memory_kv,
                                                          method=JaxPix2Poly._decode_step))
    tok = jnp.full((B,), BOS, jnp.int32)
    tokens, margins = [], []
    for pos in range(STEPS):
        logits, _, ck, cv = step(variables, tok, jnp.int32(pos), ck, cv)
        top2 = np.sort(np.asarray(logits, np.float32), -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        tokens.append(np.asarray(tok))
    return np.stack(tokens, 1), np.stack(margins, 1)


@pytest.fixture(scope="module")
def tiny():
    images = np.random.RandomState(0).normal(size=(8, 16, 16, 3)).astype(np.float32)
    variables = vary(flax_init(JaxPix2Poly(**TINY, encoder_cfg=TINY_ENC), {"images": jnp.asarray(images[:2])},
                               jnp.zeros((2, STEPS), jnp.int32)))
    dec = variables["params"]["decoder"]
    dec["output"]["bias"] = np.zeros_like(dec["output"]["bias"])
    dec["output"]["bias"][EOS] = 1.5  # rows stop at different steps
    jm = JaxPix2Poly(**TINY, encoder_cfg=TINY_ENC, dtype=jnp.bfloat16)
    pm = port(Pix2Poly(**TINY, encoder_cfg=TINY_ENC, dtype=BF), variables)
    return {"jm": jm, "pm": pm, "variables": variables, "images": images,
            "decode": _jax_decode_margins(jm, variables, jnp.asarray(images))}


def _tokens_with_pad_tail():
    rng = np.random.RandomState(6)
    y = rng.randint(0, 16, (2, STEPS)).astype(np.int32)
    y[:, 0] = BOS
    y[1, 6] = EOS
    y[1, 7:] = PAD
    return y


def test_teacher_forced_matches_jax_at_bfloat16(tiny):
    y = _tokens_with_pad_tail()
    images = tiny["images"][:2]
    jl, jperm = jax.jit(tiny["jm"].apply)(tiny["variables"], {"images": jnp.asarray(images)}, jnp.asarray(y))
    with torch.no_grad():
        pl, pperm = tiny["pm"]({"images": torch.from_numpy(images)}, torch.from_numpy(y).long())
    assert pl.dtype == BF and pperm.dtype == torch.float32
    assert_ulps(pl, jl, 4)
    jperm = np.asarray(jperm)
    assert float(np.abs(pperm.numpy() - jperm).max()) <= 3e-2 * float(np.abs(jperm).max())
    np.testing.assert_allclose(pperm.sum(-1).numpy(), 1.0, atol=1e-5)


def test_raw_scores_match_jax_at_bfloat16(tiny):
    """The twin ScoreNets (eval BatchNorm) on the same bfloat16 feats."""
    y = _tokens_with_pad_tail()
    jm = tiny["jm"]
    _, feats = jax.jit(lambda v, im, t: jm.apply(v, im, t, method=lambda m, im, t: m.decoder(m.encode({"images": im}), t)))(
        tiny["variables"], jnp.asarray(tiny["images"][:2]), jnp.asarray(y))
    want = jax.jit(lambda v, f: jm.apply(v, f, method=JaxPix2Poly.raw_scores_from_feats))(tiny["variables"], feats)
    with torch.no_grad():
        got = tiny["pm"].raw_scores_from_feats(torch.from_numpy(np.asarray(feats, np.float32)).to(BF))
    assert got.dtype == BF
    assert_ulps(got, want, 4)


@pytest.mark.parametrize("eos_code", [None, EOS])
def test_greedy_tokens_match_jax_outside_near_ties(tiny, eos_code):
    """Identical tokens up to each row's first step where JAX's top-2
    margin is under NEAR_TIE; after the early exit's EOS both emit PAD."""
    images = jnp.asarray(tiny["images"])
    jt, _ = jax.jit(lambda v, im: jax_greedy_generate(tiny["jm"], v, {"images": im}, BOS, STEPS,
                                                      raw_scores=True, eos_code=eos_code))(tiny["variables"], images)
    jt = np.asarray(jt)
    steps_t, margins = tiny["decode"]
    with torch.no_grad():
        pt, _ = greedy_generate(tiny["pm"], {"images": torch.from_numpy(tiny["images"])}, BOS, STEPS,
                                raw_scores=True, eos_code=eos_code)
    pt = pt.numpy()
    compared = 0
    for b in range(len(jt)):
        tie = np.nonzero(margins[b] < NEAR_TIE)[0]
        first = int(tie[0]) if len(tie) else STEPS
        eos_at = np.nonzero(jt[b] == EOS)[0]
        done = int(eos_at[0]) + 1 if eos_code is not None and len(eos_at) else STEPS
        # the step-by-step decode is the scan's (the early exit's up to EOS)
        np.testing.assert_array_equal(steps_t[b, :min(first, done)], jt[b, :min(first, done)])
        n = STEPS if done <= first else first  # past EOS both emit PAD
        np.testing.assert_array_equal(pt[b, :n], jt[b, :n], err_msg=f"row {b}")
        compared += n
    assert compared >= len(jt) * STEPS // 3, compared  # not vacuous
    assert len(np.unique(jt)) > 3


def test_train_step_matches_jax_at_bfloat16(tiny):
    """One train step's loss and gradients (train-mode BatchNorm) against
    JAX's bfloat16 step from the same weights and batch."""
    batch = make_batch(0)
    jm, variables = tiny["jm"], tiny["variables"]

    def loss_fn(p):
        (logits, perm), _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                     {"images": batch["images"]}, batch["y"][:, :-1], train=True,
                                     mutable=["batch_stats"])
        return (VW * jax_step.token_ce_loss(logits, batch["y"][:, 1:], PAD)
                + PW * jax_step.perm_bce_loss(perm, batch["y_perm"]))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want_grads = flax_to_state_dict(jax.device_get(want_grads))
    model = port(Pix2Poly(**TINY, encoder_cfg=TINY_ENC, dtype=BF), variables).train()
    loss = _losses(model, {k: torch.from_numpy(v) for k, v in batch.items()}, VW, PW, PAD)["loss"]
    loss.backward()
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert loss.dtype == torch.float32 and all(g.dtype == torch.float32 for g in got_grads.values())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-2)
    assert set(got_grads) == set(want_grads)
    f32 = port(Pix2Poly(**TINY, encoder_cfg=TINY_ENC), variables).train()
    _losses(f32, {k: torch.from_numpy(v) for k, v in batch.items()}, VW, PW, PAD)["loss"].backward()
    exact = {n: p.grad for n, p in f32.named_parameters()}  # float32, 2e-6 from JAX's (test_torch_train_pix2poly.py)
    port_noise, jax_noise = rel_l2(got_grads, exact), rel_l2(want_grads, exact)
    assert port_noise <= 0.35 and jax_noise <= 0.35 and port_noise <= 1.5 * jax_noise
    assert rel_l2(got_grads, want_grads) <= 0.35


# --- the decode's calls, and the bench ---------------------------------------


def _calls_per_step(model, enc) -> float:
    """Top-level aten calls per decode step, from torch.profiler traces of
    decodes of 2 and 5 steps (as chip_smoke.py's p2p_decode_profile)."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for steps in (2, 5):
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
            greedy_decode(model, enc, BOS, steps)
        counts.append(len([e for e in prof.events() if e.name.startswith("aten::")
                           and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]))
    return (counts[1] - counts[0]) / 3


def test_decode_casts_no_weight_per_step(tiny):
    """A bfloat16 decode step issues as many top-level aten calls as a
    float32 one: the decoder's weights are cast once per decode, not per
    step."""
    f32 = port(Pix2Poly(**TINY, encoder_cfg=TINY_ENC), tiny["variables"])
    images = {"images": torch.from_numpy(tiny["images"][:2])}
    with torch.inference_mode():
        per_bf16 = _calls_per_step(tiny["pm"], tiny["pm"].encode(images))
        per_f32 = _calls_per_step(f32, f32.encode(images))
    assert per_bf16 == per_f32 and per_f32 > 0


def test_bench_torch_prints_one_json_line(capsys, monkeypatch):
    """bench_torch.py's entry at a tiny size on the CPU (one ViT block): one
    JSON line with bench.py's keys."""
    from pixelspointspolygons_torch.models.pix2poly import factory

    full = factory.encoder_config
    monkeypatch.setattr(factory, "encoder_config", lambda cfg: {**full(cfg), "depth": 1})
    overrides = [
        "experiment.encoder.in_size=32",
        "experiment.encoder.patch_feature_dim=48",
        "experiment.model.decoder.in_feature_dim=32",
        "experiment.model.decoder.num_layers=1",
        "experiment.model.decoder.num_heads=4",
        "experiment.model.tokenizer.max_num_vertices=4",
        "experiment.model.sinkhorn_iterations=5",
    ]
    out = bench_torch.main(["--batch", "2", "--iters", "1", "--repeats", "1", "--device", "cpu", *overrides])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert {"metric", "value", "unit", "vs_baseline", "spread_pct", "compute_dtype"} <= set(out)
    assert out["metric"] == "pix2poly_e2e_inference" and out["compute_dtype"] == "bfloat16"
    assert out["unit"] == "tiles/sec" and out["value"] > 0 and out["vs_baseline"] > 0 and out["device"] == "cpu"
