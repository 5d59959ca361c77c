"""The port's HiSup at bfloat16 against the JAX package's `dtype=bfloat16` on
the CPU, with weights bridged from the flax tree (the tiny HRNet of
tests/test_torch_hisup.py, head width 16, 64 px): the convolution and
BatchNorm layers, HRNet's blocks, the ECA, both resizes, the whole model,
one train step, and the predictor's remask and junctions.

Both sides keep float32 parameters and round every layer's output to
bfloat16 (8 significant bits: one ulp is 2^-7 of a value's binade). They
round at slightly different places: torch adds a convolution's bias before
it rounds the product (XLA rounds the product, then the sum), and sums a
mean or a softmax in float32 before one rounding (XLA rounds the exp and
the sum). Tolerances and why, in ulps of the largest |value| compared
(measured values in brackets):
- a convolution (3x3 with bias, 1x1 at stride 2, the ECA's 1-D one) and
  BatchNorm in eval and train mode: 2 ulps [1, 0, 0, 0, 0];
- BasicBlock (also at stride 2) and Bottleneck in train mode, the ECA:
  4 ulps [0.5, 0.5, 1.25, 1.0]; both resizes: 4 ulps [0 in all six
  cases]. The resizes are JAX's products with interpolation matrices in
  bfloat16, each product rounded (`F.interpolate` rounds once and differs
  from JAX by an ulp on 31-51 % of the elements); at float32 the port keeps
  `F.interpolate`, within 1e-5 of JAX's align-corners resize [5.5e-6] and
  1e-6 of `jax.image.resize`;
- the whole model in eval mode, each of its five outputs: 5e-2 in
  relative L2 [afm 2.5e-2, jloc 1.1e-2, joff 9.6e-3, mask 8.4e-3, remask
  2.3e-2], through about 40 rounded layers. In train mode a 2-sample
  batch normalizes the 2x2 deepest branch by its own statistics, which
  amplifies each side's roundings: the outputs take the gradient rule
  below [port 0.090 and JAX 0.076 from float32, 0.090 apart];
- one train step: the loss within 1e-2 relative of JAX's bfloat16 step
  [5.0e-4]; the gradient rule of tests/test_torch_bf16.py: each side
  within 0.35 of the float32 gradient in relative L2 over all parameters,
  the port's within 1.5 times JAX's distance, the two within 0.35 of each
  other [0.251, 0.253, 0.283]; the BatchNorm running statistics after the
  step float32 and within 1e-2 of JAX's in relative L2 over all of them
  [1.4e-3];
- the predictor: the float16 remask within 2 bfloat16 ulps of 1 (2^-7
  each) [2^-8]; junction candidates up to near-ties: bfloat16 softmaxes tie
  far more often than float32 ones, so a candidate counts when its score
  clears the threshold, its 8 neighbours and the top-k cut by twice the
  largest difference between the two sides' junction maps [2 x 7.8e-3],
  which no reordering can cross; every such candidate of either side is a
  candidate of the other, its offsets within 4 ulps of 0.5 [1 ulp; 14
  such candidates].
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pixelspointspolygons_tpu.models import hrnet as jax_hrnet
from pixelspointspolygons_tpu.models.hisup import model as jax_hisup
from pixelspointspolygons_torch.models import hrnet, layers
from pixelspointspolygons_torch.models.hisup.model import ECA, HiSup, extract_junctions, hisup_losses, resize_bilinear
from pixelspointspolygons_torch.models.hrnet import HRNetEncoder
from test_torch_bf16 import assert_ulps, ulp
from test_torch_hisup import TOPO, _bridge, _perturbed, _target_batch
from test_torch_train_pix2poly import flax_init, rel_l2

BF, JBF = torch.bfloat16, jnp.bfloat16
S, DIM = 64, 16
TOPK, TH = 300, 0.008
OFFSET_ULPS = 4


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _flax_layer(kind: str):
    """(flax module, its NHWC input, the port's module, the port's input)."""
    r = np.random.RandomState(11)
    x = r.normal(size=(2, 12, 12, 8)).astype(np.float32)
    if kind == "conv3x3":
        return (fnn.Conv(6, (3, 3), padding=((1, 1), (1, 1)), dtype=JBF), x,
                layers.Conv2d(8, 6, 3, padding=1, dtype=BF), _nchw(x))
    if kind == "conv1x1_stride2":
        return (fnn.Conv(6, (1, 1), (2, 2), padding="VALID", use_bias=False, dtype=JBF), x,
                layers.Conv2d(8, 6, 1, 2, bias=False, dtype=BF), _nchw(x))
    if kind == "conv1d":
        y = r.normal(size=(2, 16, 1)).astype(np.float32)
        return (fnn.Conv(1, (5,), padding="SAME", use_bias=False, dtype=JBF), y,
                layers.Conv1d(1, 1, 5, padding=2, bias=False, dtype=BF), torch.from_numpy(y).permute(0, 2, 1))
    train = kind == "batchnorm_train"
    return (fnn.BatchNorm(momentum=0.9, use_running_average=not train, dtype=JBF), x,
            layers.BatchNorm(8, dtype=BF).train(train), _nchw(x))


@pytest.mark.parametrize("kind", ["conv3x3", "conv1x1_stride2", "conv1d", "batchnorm_eval", "batchnorm_train"])
def test_layer_matches_flax_at_bfloat16(kind):
    jmod, x, pmod, px = _flax_layer(kind)
    xb = jnp.asarray(x, JBF)
    variables = _perturbed(flax_init(jmod, xb), seed=3)
    sd = _bridge(variables)
    pmod.load_state_dict({k.lstrip("."): v for k, v in sd.items()})
    want = jax.jit(lambda v, x: jmod.apply(v, x, mutable=["batch_stats"])[0])(variables, xb)
    with torch.no_grad():
        got = pmod(px.to(BF))
    assert got.dtype == BF and want.dtype == JBF
    got = got.permute(0, 2, 1) if kind == "conv1d" else got.permute(0, 2, 3, 1)
    assert_ulps(got, want, 2)


def _block(kind: str):
    """(flax module, its inputs, port module, its inputs, train)."""
    r = np.random.RandomState(12)
    x = r.normal(size=(2, 8, 8, 8)).astype(np.float32)
    if kind == "basic_block":
        return jax_hrnet.BasicBlock(8, dtype=JBF), (x,), hrnet.BasicBlock(8, 8, dtype=BF), True
    if kind == "basic_block_stride2":
        return jax_hrnet.BasicBlock(12, 2, dtype=JBF), (x,), hrnet.BasicBlock(8, 12, 2, dtype=BF), True
    if kind == "bottleneck":
        return jax_hrnet.Bottleneck(4, dtype=JBF), (x,), hrnet.Bottleneck(8, 4, dtype=BF), True
    x2 = r.normal(size=(2, 8, 8, 16)).astype(np.float32)
    x1 = r.normal(size=(2, 8, 8, 16)).astype(np.float32)
    return jax_hisup.ECA(16, dtype=JBF), (x1, x2), ECA(16, dtype=BF), True


@pytest.mark.parametrize("kind", ["basic_block", "basic_block_stride2", "bottleneck", "eca"])
def test_block_matches_flax_at_bfloat16(kind):
    jmod, xs, pmod, train = _block(kind)
    jx = [jnp.asarray(x, JBF) for x in xs]
    variables = _perturbed(flax_init(jmod, *jx, seed=1), seed=4)
    # the bridge names an ECA's layers under HiSup's `*_att` parents
    sd = _bridge({col: {"a2m_att": tree} for col, tree in variables.items()})
    pmod.load_state_dict({k.removeprefix("a2m_att."): x for k, x in sd.items()}, strict=True)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=True, mutable=["batch_stats"])[0])(variables, *jx)
    with torch.no_grad():
        got = pmod.train()(*[_nchw(x).to(BF) for x in xs])
    assert got.dtype == BF and want.dtype == JBF
    assert_ulps(got.permute(0, 2, 3, 1), want, 4)


@pytest.mark.parametrize("shape,out", [((2, 7, 7, 8), 56), ((2, 4, 4, 8), 16), ((2, 14, 14, 8), 56)])
def test_resize_align_corners_matches_jax_at_bfloat16(shape, out):
    """HRNet's fusion and head resize (JAX hrnet.py:55-66)."""
    x = np.random.RandomState(13).normal(size=shape).astype(np.float32)
    want = jax_hrnet.resize_align_corners(jnp.asarray(x, JBF), (out, out))
    got = hrnet.resize_align_corners(_nchw(x).to(BF), (out, out))
    assert got.dtype == BF
    assert_ulps(got.permute(0, 2, 3, 1), want, 4)


@pytest.mark.parametrize("shape,out", [((2, 7, 7, 8), 56), ((2, 4, 4, 8), 16), ((2, 14, 14, 8), 56)])
def test_resize_align_corners_matches_jax_at_float32(shape, out):
    """The same resize at float32, where the port keeps `F.interpolate`
    (one call instead of two products and their matrices, which cost the
    float32 train step 37-57 ms on the card, hisup_resize_bench.py): its
    interpolation weights differ from JAX's in the last bits: 1e-5 on
    values of N(0, 1) [5.5e-6]."""
    x = np.random.RandomState(13).normal(size=shape).astype(np.float32)
    want = jax_hrnet.resize_align_corners(jnp.asarray(x), (out, out))
    got = hrnet.resize_align_corners(_nchw(x), (out, out))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape,out", [((2, 16, 16, 8), 64), ((2, 56, 56, 4), 224), ((2, 16, 16, 8), 8)])
def test_resize_bilinear_matches_jax_image_resize(shape, out):
    """The decoder's resize to pred_size (JAX model.py:193-199,
    `jax.image.resize(..., "bilinear")`) at bfloat16, and at float32 when
    it enlarges (`F.interpolate`) and when it shrinks (antialiased)."""
    x = np.random.RandomState(14).normal(size=shape).astype(np.float32)
    B, _, _, C = shape
    for jdt, tdt in ((JBF, BF), (jnp.float32, torch.float32)):
        want = jax.image.resize(jnp.asarray(x, jdt), (B, out, out, C), "bilinear")
        got = resize_bilinear(_nchw(x).to(tdt), out)
        assert got.dtype == tdt and got.shape == (B, C, out, out)
        if tdt == BF:
            assert_ulps(got.permute(0, 2, 3, 1), want, 4)
        else:
            np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6)


# --- the model ----------------------------------------------------------------


def _images(seed=0, B=2):
    return np.random.RandomState(seed).normal(size=(B, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """The tiny HiSup at bfloat16 on both sides, perturbed flax weights
    (nonzero biases, BatchNorm affines and statistics), and a train batch."""
    images = _images()
    jm = jax_hisup.HiSup(encoder_cfg={"name": "hrnet", "in_size": S, **TOPO}, dim=DIM, pred_size=S, dtype=JBF)
    variables = jax.device_get(_perturbed(flax_init(jm, {"images": jnp.asarray(images)})))
    return {"jm": jm, "variables": variables, "images": images}


def _port(variables, dtype=BF):
    model = HiSup(HRNetEncoder(in_size=S, out_dim=DIM, dtype=dtype, **TOPO), dim=DIM, pred_size=S, dtype=dtype)
    model.load_state_dict(_bridge(variables), strict=True)
    return model


def _rel_l2(got: torch.Tensor, want) -> float:
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("train", [False, True])
def test_hisup_forward_matches_flax_at_bfloat16(tiny, train):
    """Eval mode: each output within 5e-2 of JAX's in relative L2. Train
    mode normalizes by the statistics of a 2-sample batch (the deepest
    HRNet branch is 2x2), which amplifies each side's roundings: both sides
    stray as far from the float32 output as from each other, so the
    outputs are held to the gradient rule (module docstring)."""
    jm, v, images = tiny["jm"], tiny["variables"], tiny["images"]
    if train:
        want, _ = jax.jit(lambda v, im: jm.apply(v, {"images": im}, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(images))
    else:
        want = jax.jit(lambda v, im: jm.apply(v, {"images": im}))(v, jnp.asarray(images))
    with torch.no_grad():
        got = _port(v).train(train)({"images": torch.from_numpy(images)})
        exact = _port(v, torch.float32).train(train)({"images": torch.from_numpy(images)})
    assert set(got) == set(want) == {"joff", "jloc", "mask", "afm", "remask"}
    for k in want:
        assert got[k].dtype == BF and want[k].dtype == JBF and got[k].shape == want[k].shape, k
    want = {k: torch.from_numpy(np.asarray(x, np.float32)) for k, x in want.items()}
    if not train:
        errs = {k: rel_l2({k: got[k]}, {k: want[k]}) for k in want}
        assert all(e <= 5e-2 for e in errs.values()), errs
        return
    port_noise, jax_noise = rel_l2(got, exact), rel_l2(want, exact)
    assert port_noise <= 0.35 and jax_noise <= 0.35 and port_noise <= 1.5 * jax_noise, (port_noise, jax_noise)
    assert rel_l2(got, want) <= 0.35


def test_train_step_matches_jax_at_bfloat16(tiny):
    """One train step's loss, gradients and BatchNorm statistics (train
    mode) against JAX's bfloat16 step from the same weights and batch, on
    JAX's targets (the AFM's own parity is tests/test_torch_afm.py)."""
    jm, v, images = tiny["jm"], tiny["variables"], _images(6, B=3)
    batch = _target_batch(size=S)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    targets = jax_hisup.encode_targets(jbatch, S)
    weights = {"loss_jloc": 8.0, "loss_joff": 0.25, "loss_mask": 1.0, "loss_afm": 0.1, "loss_remask": 1.0}

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, {"images": jnp.asarray(images)},
                            train=True, mutable=["batch_stats"])
        return sum(weights[k] * x for k, x in jax_hisup.hisup_losses(out, targets).items()), mut

    (want_loss, mut), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    want_grads = _bridge({"params": jax.device_get(want_grads)})
    tt = {k: torch.from_numpy(np.array(x)) for k, x in targets.items()}

    def port_step(dtype):
        model = _port(v, dtype).train()
        losses = hisup_losses(model({"images": torch.from_numpy(images)}), tt)
        loss = sum(weights[k] * x for k, x in losses.items())
        loss.backward()
        return model, loss, {n: p.grad for n, p in model.named_parameters()}

    model, loss, got_grads = port_step(BF)
    assert loss.dtype == torch.float32 and all(g.dtype == torch.float32 for g in got_grads.values())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-2)
    assert set(got_grads) == set(want_grads)
    _, _, exact = port_step(torch.float32)  # float32, held to JAX's in tests/test_torch_slice.py
    port_noise, jax_noise = rel_l2(got_grads, exact), rel_l2(want_grads, exact)
    assert port_noise <= 0.35 and jax_noise <= 0.35 and port_noise <= 1.5 * jax_noise, (port_noise, jax_noise)
    assert rel_l2(got_grads, want_grads) <= 0.35
    # running statistics, float32, against JAX's in relative L2 over all of them
    want_stats = _bridge({"params": {}, "batch_stats": jax.device_get(mut["batch_stats"])})
    got_stats = {k: x for k, x in model.state_dict().items() if k in want_stats}
    assert len(got_stats) == len(want_stats) > 0 and all(x.dtype == torch.float32 for x in got_stats.values())
    assert rel_l2(got_stats, want_stats) <= 1e-2


def _candidates(prob: np.ndarray, margin: float) -> tuple[dict, set]:
    """extract_junctions' candidates of one class map (H, W) as
    {(row, col): score}, and those that clear the threshold, their 8
    neighbours and the top-k cut by more than `margin`."""
    H, W = prob.shape
    pad = np.pad(prob, 1, constant_values=-np.inf)
    neigh = np.max([pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                    for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx], axis=0)
    flat = np.where(prob >= neigh, prob, 0.0).ravel()  # nms_2d: equal to its 3x3 max
    order = np.argsort(-flat, kind="stable")
    cut = flat[order[TOPK]] if flat.size > TOPK else 0.0
    cand = {divmod(int(i), W): float(flat[i]) for i in order[:TOPK] if flat[i] > TH}
    clear = {p for p, s in cand.items() if min(s - TH, s - neigh[p], s - cut) > margin}
    return cand, clear


def test_predictor_matches_jax_at_bfloat16(tiny, tmp_path):
    """The predictor's device part at bfloat16 (JAX predictor_hisup.py:39-48):
    the remask shipped as float16, and the junction candidates of the two
    sides' maps up to near-ties (extract_junctions itself is held to JAX's
    on identical maps in tests/test_torch_predict.py)."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.predict.predictor_hisup import HiSupPredictor
    from test_torch_predict import _overrides

    jm = tiny["jm"]
    images = np.concatenate([tiny["images"], _images(5, B=2)])
    # a remask head that calls about a third of the pixels buildings
    v = jax.tree_util.tree_map(np.array, tiny["variables"])
    bn = v["params"]["final_conv"]["BatchNorm_2"]
    bn["bias"] = bn["bias"] + np.array([-3.0, 0.07], np.float32)
    # junction logits twice as steep, so that more peaks stand clear of their neighbours
    jp = v["params"]["jloc_predictor"]["Conv_1"]
    jp["kernel"] = jp["kernel"] * 2.0

    @jax.jit
    def jax_forward(variables, ims):
        out = jm.apply(variables, {"images": ims})
        jloc = jax.nn.softmax(out["jloc"], axis=1)
        joff = jax.nn.sigmoid(out["joff"]) - 0.5
        remask = jax.nn.softmax(out["remask"], axis=1)[:, 1]
        return remask.astype(jnp.float16), jloc, joff

    j_remask, j_jloc, j_joff = (np.asarray(x, np.float32) for x in jax_forward(v, jnp.asarray(images)))
    cfg = compose(_overrides(tmp_path, ["host.compute_dtype=bfloat16"]))
    predictor = HiSupPredictor(cfg, device="cpu", model=_port(v))
    inputs = {"images": torch.from_numpy(images)}
    with torch.inference_mode():
        p_remask, p_juncs, p_scores = predictor.forward(inputs)
        out = predictor.model(inputs)
        p_jloc, p_joff = torch.softmax(out["jloc"], dim=1), torch.sigmoid(out["joff"]) - 0.5
        want = extract_junctions(p_jloc, p_joff, topk=predictor.junc_topk, th=predictor.junc_threshold)
    assert p_remask.dtype == torch.float16 and p_jloc.dtype == BF and p_scores.dtype == BF
    assert torch.equal(p_juncs, want[0]) and torch.equal(p_scores, want[1])
    remask_err = float(np.abs(p_remask.float().numpy() - j_remask).max())
    assert remask_err <= 2 * 2.0**-7 and 0.2 < (j_remask > 0.5).mean() < 0.6, remask_err
    p_jloc, p_joff = p_jloc.float().numpy(), p_joff.float().numpy()
    # no ordering the two maps disagree on can flip a margin of twice their largest difference
    margin = 2 * float(np.abs(p_jloc - j_jloc).max())
    assert margin <= 0.05, margin
    compared = 0
    for b in range(len(images)):
        for c in (1, 2):
            (p_cand, p_clear), (j_cand, j_clear) = _candidates(p_jloc[b, c], margin), _candidates(j_jloc[b, c], margin)
            assert j_clear <= set(p_cand) and p_clear <= set(j_cand), (b, c)
            for y, x in j_clear & p_clear:
                np.testing.assert_allclose(p_joff[b, :, y, x], j_joff[b, :, y, x], rtol=0,
                                           atol=OFFSET_ULPS * ulp(0.5))
                compared += 1
    assert compared >= 12, compared


# --- the entry points -----------------------------------------------------------


def test_cli_hisup_at_bfloat16_on_cpu(tmp_path, monkeypatch):
    """`host.compute_dtype=bfloat16` through cli/train.py, then predict,
    evaluate and predict_demo from its `latest` (a tiny HRNet): the model
    computes in bfloat16, its checkpoint holds float32 parameters, and the
    AFM targets stay float32."""
    import cv2

    from pixelspointspolygons_torch.cli import evaluate as cli_evaluate
    from pixelspointspolygons_torch.cli import predict as cli_predict
    from pixelspointspolygons_torch.cli import predict_demo as cli_predict_demo
    from pixelspointspolygons_torch.cli import train as cli_train
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.hisup import factory, model as port_model
    from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager
    from test_torch_predict import _overrides

    full = factory.encoder_config
    monkeypatch.setattr(factory, "encoder_config", lambda cfg: {**full(cfg), **TOPO})
    afm_dtypes = []
    afm = port_model.afm_auto

    def recorded(lines, valid, h, w):
        afm_dtypes.append((lines.dtype, valid.dtype))
        out = afm(lines, valid, h, w)
        afm_dtypes.append(out[0].dtype)
        return out

    monkeypatch.setattr(port_model, "afm_auto", recorded)
    monkeypatch.chdir(tmp_path)
    common = _overrides(tmp_path, ["host.compute_dtype=bfloat16", "experiment.model.num_epochs=1",
                                   "training.save_every=0", "device=cpu"])
    history = cli_train.main(common)
    assert np.isfinite(history["loss"]) and 0.0 <= history["val_iou"] <= 1.0
    assert afm_dtypes and all(d in ((torch.float32, torch.bool), torch.float32) for d in afm_dtypes), afm_dtypes
    cfg = compose(common)
    weights = CheckpointManager(cfg.output_dir).restore("latest")["model"]
    assert all(v.dtype == torch.float32 for v in weights.values())

    args = common + ["evaluation=test", "checkpoint=latest"]
    predictor = cli_predict.get_predictor(compose(args), "cpu")
    assert predictor.model.compute_dtype == BF
    results = cli_predict.main(args)
    assert results["num_images"] == 2 and 0.0 <= results["IoU"] <= 1.0
    again = cli_evaluate.main(args)
    assert again["IoU"] == results["IoU"]
    image_dir = os.path.join(cfg.experiment.dataset.in_path, "images", "test")
    image = os.path.join(image_dir, sorted(os.listdir(image_dir))[0])
    polys, out_file = cli_predict_demo.main(common + ["checkpoint=latest", f"+image_file={image}"])
    assert isinstance(polys, list) and cv2.imread(str(tmp_path / out_file)) is not None
