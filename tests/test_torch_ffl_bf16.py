"""The port's FFL at bfloat16 against the JAX package's `dtype=bfloat16` on
the CPU, with weights bridged from the flax tree (tests/test_ffl.py::tiny_ffl's
sizes: img 32, patch 8, dim 32, depth 1, 2 heads): the forward in eval and
train mode, one train step, the predictor's maps, and the entry points
(`cli.train`, `cli.predict`, `cli.predict_demo`) at
`host.compute_dtype=bfloat16`.

Both sides keep float32 parameters and round every layer's output to
bfloat16 (8 significant bits: one ulp is 2^-7 of a value's binade), at
slightly different places (tests/test_torch_hisup_bf16.py). Tolerances and
why, in ulps of the largest |value| compared (measured in brackets):
- the forward in eval mode: seg within 4 ulps [1.5], crossfield within 8
  [3.5] (through the ViT block, the resize, three convolutions and two
  BatchNorms); in train mode a 2-sample batch normalizes by its own
  statistics and amplifies each side's roundings, so the outputs are held
  in relative L2: each side within 5e-2 of the float32 output and of the
  other [port 1.0e-2, JAX 1.1e-2, 1.2e-2 apart on the crossfield];
- one train step: the losses within 1e-2 relative of JAX's bfloat16 step
  (the losses widen the outputs to float32 as JAX does; HiSup's bound)
  [total 2.8e-4, terms up to 2.8e-3]; the gradient rule of
  tests/test_torch_bf16.py: each side within 0.35 of the float32 gradient
  in relative L2 over all parameters, the port's within 1.5 times JAX's
  distance, the two within 0.35 of each other [port 0.030, JAX 0.054, 0.056
  apart]; the BatchNorm running statistics float32 and within 1e-2 of JAX's
  in relative L2 over all of them [1.2e-4];
- the predictor's maps: the bfloat16 outputs rounded to float16 (JAX
  predictor_ffl.py:35-43), within the eval-mode bounds above; the trainer's
  val IoU takes the bfloat16 values widened to float32, unrounded.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.models.ffl import FFL as JaxFFL
from pixelspointspolygons_tpu.models.ffl import losses as jax_losses
from pixelspointspolygons_torch.cli import predict as cli_predict
from pixelspointspolygons_torch.cli import predict_demo as cli_predict_demo
from pixelspointspolygons_torch.cli import train as cli_train
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.models.ffl import FFL
from pixelspointspolygons_torch.models.ffl import losses
from pixelspointspolygons_torch.models.vit import ViTCNNEncoder
from pixelspointspolygons_torch.predict.predictor_ffl import FFLPredictor
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager
from test_torch_bf16 import assert_ulps
from test_torch_ffl import VIT, _random_variables, one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_train_ffl import EPOCH, overrides, tiny_vit  # noqa: F401 (a fixture)
from test_torch_train_pix2poly import rel_l2

BF, JBF = torch.bfloat16, jnp.bfloat16
S, DIM = 32, 32


def _images(seed=0, B=2):
    return np.random.RandomState(seed).normal(size=(B, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    images = _images()
    jm = JaxFFL(encoder_cfg={"name": "vit_cnn", **VIT, "out_size": S}, dim=DIM, seg_channels=1, out_size=S, dtype=JBF)
    return {"jm": jm, "variables": _random_variables(jm, {"images": jnp.asarray(images)}, 2), "images": images}


def _port(variables, dtype=BF) -> FFL:
    model = FFL(ViTCNNEncoder(out_size=S, out_dim=DIM, dtype=dtype, **VIT), dim=DIM, seg_channels=1, out_size=S,
                dtype=dtype)
    model.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]), strict=True)
    return model


def _as_torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in tree.items()}


@pytest.mark.parametrize("train", [False, True])
def test_ffl_forward_matches_flax_at_bfloat16(tiny, train):
    jm, v, images = tiny["jm"], tiny["variables"], tiny["images"]
    if train:
        want, _ = jax.jit(lambda v, im: jm.apply(v, {"images": im}, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(images))
    else:
        want = jax.jit(lambda v, im: jm.apply(v, {"images": im}))(v, jnp.asarray(images))
    with torch.no_grad():
        got = _port(v).train(train)({"images": torch.from_numpy(images)})
        exact = _port(v, torch.float32).train(train)({"images": torch.from_numpy(images)})
    assert set(got) == set(want) == {"seg", "crossfield"}
    for k in want:
        assert got[k].dtype == BF and want[k].dtype == JBF and got[k].shape == want[k].shape, k
    if not train:
        assert_ulps(got["seg"], want["seg"], 4)
        assert_ulps(got["crossfield"], want["crossfield"], 8)
        return
    want = _as_torch(want)
    for k in want:
        assert rel_l2({k: got[k]}, {k: exact[k]}) <= 5e-2 and rel_l2({k: want[k]}, {k: exact[k]}) <= 5e-2, k
        assert rel_l2({k: got[k]}, {k: want[k]}) <= 5e-2, k


def test_train_step_matches_jax_at_bfloat16(tiny):
    """One train step's losses, gradients and BatchNorm statistics against
    JAX's bfloat16 step from the same weights on the same batch (random
    targets, float16-rounded as the loaders ship them)."""
    from test_torch_train_ffl import _loss_inputs

    jm, v = tiny["jm"], tiny["variables"]
    images = _images(6, B=2)
    _, batch = _loss_inputs(1, seed=3, B=2, size=S)
    args = ["experiment=ffl_image", "dataset=synthetic", f"experiment.encoder.in_size={S}"]
    jloss, jweights = jax_losses.make_ffl_loss(jax_compose(args))
    ploss, pweights = losses.make_ffl_loss(compose(args))
    jw = {k: jnp.float32(x) for k, x in jweights(EPOCH).items()}
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, {"images": jnp.asarray(images)},
                            train=True, mutable=["batch_stats"])
        total, terms = jloss(out, jbatch, jw)
        return total, (terms, mut)

    (want_loss, (want_terms, mut)), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    want_grads = flax_to_state_dict(jax.device_get(want_grads))
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}

    def port_step(dtype):
        model = _port(v, dtype).train()
        total, terms = ploss(model({"images": torch.from_numpy(images)}), tbatch, pweights(EPOCH))
        total.backward()
        return model, total, terms, {n: p.grad for n, p in model.named_parameters()}

    model, loss, terms, got_grads = port_step(BF)
    assert loss.dtype == torch.float32 and all(g.dtype == torch.float32 for g in got_grads.values())
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-2)
    assert set(terms) == set(want_terms) and len(terms) == 5
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(want_terms[k]), rtol=1e-2, err_msg=k)
    _, _, _, exact = port_step(torch.float32)  # float32, held to JAX's in tests/test_torch_train_ffl.py
    port_noise, jax_noise = rel_l2(got_grads, exact), rel_l2(want_grads, exact)
    assert port_noise <= 0.35 and jax_noise <= 0.35 and port_noise <= 1.5 * jax_noise, (port_noise, jax_noise)
    assert rel_l2(got_grads, want_grads) <= 0.35
    want_stats = flax_to_state_dict({}, jax.device_get(mut["batch_stats"]))
    got_stats = {k: x for k, x in model.state_dict().items() if k in want_stats}
    assert len(got_stats) == len(want_stats) == 6 and all(x.dtype == torch.float32 for x in got_stats.values())
    assert rel_l2(got_stats, want_stats) <= 1e-2


def test_predictor_maps_match_jax_at_bfloat16(tiny, tmp_path):
    """The predictor's forward at bfloat16: the maps rounded to float16 as
    JAX's predictor rounds them; with the trainer's `map_dtype` the
    bfloat16 values widened to float32."""
    jm, v, images = tiny["jm"], tiny["variables"], _images(4, B=3)
    want = jax.jit(lambda v, im: {k: x.astype(jnp.float16) for k, x in jm.apply(v, {"images": im}).items()})(
        v, jnp.asarray(images))
    cfg = compose(overrides(tmp_path, ["host.compute_dtype=bfloat16"]))
    predictor = FFLPredictor(cfg, device="cpu", model=_port(v))
    got = predictor.forward({"images": torch.from_numpy(images)})
    for k in want:
        assert got[k].dtype == torch.float16 and want[k].dtype == jnp.float16, k
    assert_ulps(got["seg"], want["seg"], 4)
    assert_ulps(got["crossfield"], want["crossfield"], 8)
    predictor.map_dtype = torch.float32
    wide = predictor.forward({"images": torch.from_numpy(images)})
    with torch.no_grad():
        raw = predictor.model({"images": torch.from_numpy(images)})
    for k in raw:
        assert wide[k].dtype == torch.float32 and torch.equal(wide[k], raw[k].float()), k


def test_cli_trains_and_predicts_ffl_at_bfloat16(tiny_vit, tmp_path):
    """`host.compute_dtype=bfloat16` through the command lines on the CPU:
    the trainer's model computes in bfloat16 with float32 parameters and
    writes float32 weights; from its `latest` the predict, evaluate and
    demo entry points run, with ASM beside ACM."""
    args = overrides(tmp_path, ["host.compute_dtype=bfloat16", "experiment.model.num_epochs=1"])
    history = cli_train.main(args + ["device=cpu"])
    assert history["epoch"] == 0 and np.isfinite(history["loss"]) and 0.0 <= history["val_iou"] <= 1.0
    cfg = compose(args)
    weights = CheckpointManager(cfg.output_dir).restore("latest")["model"]
    assert all(x.dtype == torch.float32 for x in weights.values() if x.is_floating_point())

    pargs = args + ["evaluation=test", "evaluation.modes=[iou]", "checkpoint=latest",
                    "experiment.polygonization.method=[acm,asm]", "experiment.polygonization.asm_method.loss_params.coefs.step_thresholds=[0,10,20,30]"]
    predictor, results = cli_predict.predict_and_evaluate(compose(pargs), "cpu")
    assert predictor.model.compute_dtype == BF and predictor.failed_batches == 0
    assert 0.0 <= results["IoU"] <= 1.0
    pred_file = compose(pargs + ["evaluation=test"]).evaluation.pred_file
    for key in ("acm.tol_1", "asm.tol_1"):
        assert os.path.isfile(pred_file.replace(".json", f"_{key}.json")), key
    test_dir = os.path.join(cfg.experiment.dataset.in_path, "images", "test")
    image = os.path.join(test_dir, sorted(os.listdir(test_dir))[0])
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        polys, out_file = cli_predict_demo.main(pargs + ["device=cpu", f"+image_file={image}"])
    finally:
        os.chdir(cwd)
    assert isinstance(polys, list) and os.path.isfile(tmp_path / out_file)
