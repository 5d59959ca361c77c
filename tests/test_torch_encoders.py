"""The port's last three encoders against the JAX package's on the CPU, with
weights drawn from a numpy seed in the shapes `jax.eval_shape` gives and
bridged into the port (`utils/bridge.py`): ConvNeXt-V2 (`GRN`,
`ConvNeXtBlock`, `ConvNeXtEncoder`), UNet-ResNet (`Bottleneck`,
`UNetResNetEncoder`), FFL over each of them built by `build_ffl` from the
config tree at a tiny depth, and Pix2Poly over the DINOv2 ViT
(`vit_dinov2`: the factory's config, teacher-forced logits, the graft of a
DINOv2 file, `load_pretrained_vit`).

Tolerances and why (float32 unless stated; measured in brackets):
- the modules in eval and train mode: float32 sums in another order through
  a few convolutions, LayerNorms and BatchNorms; outputs within 1e-5 of
  their largest |value| (`_rel`) [UNet 3.7e-7 in eval mode, 6.0e-6 in
  train mode], the running statistics after a train-mode forward within
  1e-5 relative (+1e-6). The UNet's train-mode cases take 4 tiles: on 2,
  its deepest map is 1×1, each BatchNorm there normalizes 2 values, and
  flax's variance E[x²] - E[x]² (ROADMAP 3.11) lies 1.3e-4 from the
  float64 forward where the port's lies 4.4e-5;
- the negative controls: ConvNeXt's block with the exact GELU parts from
  JAX by more than 10 times that bound [1.3e-4], the UNet with torch's
  symmetric padding by more than 100 times, so the parity tests fail if
  either detail is undone;
- FFL's train step on 4 tiles: each loss term within 1e-5 relative of
  JAX's [3.2e-6]; the gradients in relative L2 over all parameters
  against the port's own float64 step from the same weights: each side
  within 1e-4 and the port's within twice JAX's distance (+1e-6), as
  tests/test_torch_grad_conditioning.py holds Pix2Poly's [port 1.4e-6 and
  1.5e-5, JAX 2.2e-6 and 5.6e-5 for ConvNeXt and the UNet];
- FFL at bfloat16 in eval mode (both sides keep float32 parameters and
  round every layer's output to bfloat16): seg within 4 ulps and the
  crossfield within 8 ulps of the largest |value| (one ulp is 2^-7 of its
  binade), the bounds of tests/test_torch_ffl_bf16.py [seg 1, crossfield
  5.75 for ConvNeXt and 3.06 for the UNet];
- the DINOv2 graft and `load_pretrained_vit`: copies and the same float64
  numpy resampling on both sides, so equal bit for bit.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import timm_vit_state
from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.models.convnext import GRN as JaxGRN
from pixelspointspolygons_tpu.models.convnext import ConvNeXtBlock as JaxConvNeXtBlock
from pixelspointspolygons_tpu.models.convnext import ConvNeXtEncoder as JaxConvNeXt
from pixelspointspolygons_tpu.models.ffl import FFL as JaxFFL
from pixelspointspolygons_tpu.models.ffl import build_ffl as jax_build_ffl
from pixelspointspolygons_tpu.models.ffl import losses as jax_losses
from pixelspointspolygons_tpu.models.ffl.unetresnet import Bottleneck as JaxBottleneck
from pixelspointspolygons_tpu.models.ffl.unetresnet import UNetResNetEncoder as JaxUNet
from pixelspointspolygons_tpu.models.pix2poly import Pix2Poly as JaxPix2Poly
from pixelspointspolygons_tpu.models.pix2poly import factory as jax_p2p_factory
from pixelspointspolygons_tpu.utils.pretrained import apply_pretrained_encoder as jax_apply
from pixelspointspolygons_tpu.utils.torch_port import load_pretrained_vit as jax_load_pretrained_vit
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data.loader import F16_KEYS, build_loader
from pixelspointspolygons_torch.models import convnext, layers
from pixelspointspolygons_torch.models.convnext import GRN, ConvNeXtBlock, ConvNeXtEncoder
from pixelspointspolygons_torch.models.ffl import build_ffl
from pixelspointspolygons_torch.models.ffl import losses
from pixelspointspolygons_torch.models.ffl import model as ffl_model
from pixelspointspolygons_torch.models.ffl.unetresnet import Bottleneck, UNetResNetEncoder
from pixelspointspolygons_torch.models.pix2poly import Pix2Poly, build_pix2poly
from pixelspointspolygons_torch.models.pix2poly import factory as p2p_factory
from pixelspointspolygons_torch.train.ffl_step import model_inputs
from pixelspointspolygons_torch.train.trainer_ffl import FFL_BATCH_KEYS
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from pixelspointspolygons_torch.utils.pretrained import apply_pretrained_encoder
from pixelspointspolygons_torch.utils.torch_port import load_pretrained_vit
from test_torch_ffl import _bridged, _images, _random_variables, _rel, one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_ffl import EPOCH, datasets, overrides  # noqa: F401 (a module-scoped fixture)
from test_torch_train_pix2poly import TINY, TINY_ENC, rel_l2

TOL, STATS_TOL = 1e-5, 1e-5
CNX = dict(depths=(1, 1), dims=(16, 32))
UNET = dict(stage_blocks=(1, 1, 1, 1), base_width=8)
TINY_ENCODERS = {"convnext": CNX, "unetresnet101": UNET}
S, DIM = 32, 16


def _draw(module, seed: int, *args) -> dict:
    """`test_torch_ffl._random_variables` for a module that takes several
    positional inputs."""
    return _random_variables(types.SimpleNamespace(init=lambda key, a: module.init(key, *a)), args, seed)


def _apply(jm, variables, x, train: bool):
    """JAX's output and, in train mode, its updated batch_stats."""
    if not train:
        return jax.jit(lambda v, x: jm.apply(v, x))(variables, x), None
    out, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    return out, mut["batch_stats"]


def _assert_stats(port, batch_stats, prefix=""):
    want = flax_to_state_dict({}, jax.device_get(batch_stats))
    sd = port.state_dict()
    assert want
    for k, v in want.items():
        np.testing.assert_allclose(sd[prefix + k].numpy(), v.numpy(), rtol=STATS_TOL, atol=1e-6, err_msg=k)


# --- ConvNeXt-V2 ---------------------------------------------------------------


def test_grn_matches_jax():
    x = np.random.RandomState(0).normal(size=(2, 4, 4, 12)).astype(np.float32)
    jm = JaxGRN(12)
    variables = _random_variables(jm, jnp.asarray(x), 0)
    port = _bridged(GRN(12), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert _rel(got.numpy(), jm.apply(variables, jnp.asarray(x))) <= TOL


def _block_output(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def test_convnext_block_matches_jax_with_the_tanh_gelu(monkeypatch):
    """flax 0.12's `nn.gelu` is the tanh approximation: the block with
    torch's exact GELU parts from JAX far beyond the bound."""
    x = np.random.RandomState(1).normal(size=(2, 8, 8, 16)).astype(np.float32)
    jm = JaxConvNeXtBlock(16)
    variables = _random_variables(jm, jnp.asarray(x), 1)
    assert set(variables["params"]) == {"Conv_0", "LayerNorm_0", "Dense_0", "GRN_0", "Dense_1"}
    want = jm.apply(variables, jnp.asarray(x))
    port = _bridged(ConvNeXtBlock(16), variables)
    assert _rel(_block_output(port, x), want) <= TOL
    exact = types.SimpleNamespace(gelu=lambda h, approximate="none": torch.nn.functional.gelu(h))
    monkeypatch.setattr(convnext, "F", exact)
    assert _rel(_block_output(port, x), want) > 10 * TOL


@pytest.mark.parametrize("train", [False, True])
def test_convnext_encoder_matches_jax(train):
    x = _images(2, size=S)
    jm = JaxConvNeXt(in_size=S, out_dim=DIM, **CNX)
    variables = _random_variables(jm, jnp.asarray(x), 2)
    want, stats = _apply(jm, variables, jnp.asarray(x), train)
    port = _bridged(ConvNeXtEncoder(in_size=S, out_dim=DIM, **CNX), variables).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, S // 4, S // 4, DIM)
    assert _rel(got.numpy(), want) <= TOL
    if train:
        _assert_stats(port, stats)


def test_convnext_refuses_sizes_flax_would_pad():
    with pytest.raises(ValueError, match="divides by 8"):
        ConvNeXtEncoder(in_size=36, out_dim=DIM, **CNX)(torch.zeros(1, 36, 36, 3))


# --- UNet-ResNet -----------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_bottleneck_matches_jax(train):
    """The strided block with its projection shortcut, on an even size:
    flax pads the 3×3/2 convolution (0, 1)."""
    x = np.random.RandomState(3).normal(size=(2, 16, 16, 12)).astype(np.float32)
    jm = JaxBottleneck(8, 2)
    variables = _random_variables(jm, jnp.asarray(x), 3)
    want, stats = _apply(jm, variables, jnp.asarray(x), train)
    port = _bridged(Bottleneck(12, 8, 2), variables).train(train)
    got = _block_output(port, x)
    assert got.shape == (2, 8, 8, 32) and _rel(got, want) <= TOL
    if train:
        _assert_stats(port, stats)


def _symmetric_pads(sizes, kernel, stride):
    return [k // 2 for k in reversed(kernel) for _ in range(2)]


@pytest.mark.parametrize("size,train", [(32, False), (32, True), (30, False), (30, True)])
def test_unet_resnet_encoder_matches_jax(size, train, monkeypatch):
    """Even and odd sizes, both modes; with torch's symmetric padding the
    encoder parts from JAX far beyond the bound."""
    x = _images(4, B=4, size=size)
    jm = JaxUNet(in_size=size, out_dim=DIM, **UNET)
    variables = _random_variables(jm, jnp.asarray(x), 4)
    want, stats = _apply(jm, variables, jnp.asarray(x), train)
    port = _bridged(UNetResNetEncoder(in_size=size, out_dim=DIM, **UNET), variables)
    frozen = copy.deepcopy(port.state_dict())
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (4, size, size, DIM) and _rel(got.numpy(), want) <= TOL
    if train:
        _assert_stats(port, stats)
        return
    monkeypatch.setattr(layers, "same_pads", _symmetric_pads)
    port.load_state_dict(frozen)
    with torch.no_grad():
        assert _rel(port(torch.from_numpy(x)).numpy(), want) > 100 * TOL


# --- FFL over the two encoders -------------------------------------------------


@pytest.fixture()
def tiny_encoders(monkeypatch):
    """The config tree gives these encoders only `in_size`; shrink them."""
    full = ffl_model.encoder_config
    monkeypatch.setattr(ffl_model, "encoder_config", lambda cfg: {**full(cfg), **TINY_ENCODERS[cfg.experiment.encoder.name]})


def _ffl_args(encoder, extra=()):
    return ["experiment=ffl_image", "dataset=synthetic", f"encoder={encoder}", f"experiment.encoder.in_size={S}",
            f"experiment.model.decoder.in_feature_dim={DIM}", *extra]


@pytest.mark.parametrize("encoder", ["convnext", "unetresnet101"])
def test_build_ffl_encoder_config_matches_jax(encoder):
    """The full-depth encoders: `encoder_config` is JAX's (only `in_size`),
    and `build_ffl` builds them from the shipped configs."""
    args = _ffl_args(encoder)
    cfg = compose(args)
    assert ffl_model.encoder_config(cfg) == jax_build_ffl(jax_compose(args)).encoder_cfg == {"name": encoder, "in_size": S}
    enc = build_ffl(cfg).encoder
    assert type(enc) is ffl_model.ENCODERS[encoder]
    if encoder == "convnext":
        assert enc.depths == (3, 3, 9, 3) and enc.conv4.in_channels == 1440
    else:
        assert enc.n_blocks == 33 and enc.conv1.in_channels == 2048 + 1024


def _jax_ffl(encoder, dtype=jnp.float32):
    enc_cfg = {"name": encoder, "in_size": S, **TINY_ENCODERS[encoder]}
    return JaxFFL(encoder_cfg=enc_cfg, dim=DIM, seg_channels=1, out_size=S, dtype=dtype)


@pytest.fixture(scope="module")
def ffl_variables():
    x = jnp.asarray(_images(5, size=S))
    return {e: _random_variables(_jax_ffl(e), {"images": x}, 5 + i) for i, e in enumerate(TINY_ENCODERS)}


@pytest.mark.parametrize("encoder", ["convnext", "unetresnet101"])
def test_ffl_over_the_encoder_matches_jax(encoder, ffl_variables, tiny_encoders):
    x = _images(6, size=S)
    variables = ffl_variables[encoder]
    want = jax.jit(_jax_ffl(encoder).apply)(variables, {"images": jnp.asarray(x)})
    port = _bridged(build_ffl(compose(_ffl_args(encoder))), variables)
    with torch.no_grad():
        got = port({"images": torch.from_numpy(x)})
    for k in ("seg", "crossfield"):
        assert got[k].shape == (2, 1 if k == "seg" else 4, S, S)
        assert _rel(got[k].numpy(), want[k]) <= TOL, k


def _ulps(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got.float().numpy() - want).max() / ulp)


@pytest.mark.parametrize("encoder", ["convnext", "unetresnet101"])
def test_ffl_over_the_encoder_matches_flax_at_bfloat16(encoder, ffl_variables, tiny_encoders):
    x = _images(7, size=S)
    want = jax.jit(_jax_ffl(encoder, jnp.bfloat16).apply)(ffl_variables[encoder], {"images": jnp.asarray(x)})
    port = _bridged(build_ffl(compose(_ffl_args(encoder)), dtype=torch.bfloat16), ffl_variables[encoder])
    with torch.no_grad():
        got = port({"images": torch.from_numpy(x)})
    assert got["seg"].dtype == got["crossfield"].dtype == torch.bfloat16
    assert _ulps(got["seg"], want["seg"]) <= 4
    assert _ulps(got["crossfield"], want["crossfield"]) <= 8


@pytest.fixture(scope="module")
def ffl_batch(datasets):  # noqa: F811 (the imported fixture)
    """The port's loader's train split at S px as one batch of 4 tiles,
    float16-rounded where the loaders round."""
    cfg = copy.deepcopy(datasets[1])
    cfg.experiment.model.batch_size = 4
    batch = next(iter(build_loader(cfg, "train")))
    assert len(batch["images"]) == 4
    return {k: (v.astype(np.float16).astype(np.float32) if k in F16_KEYS else v) for k, v in batch.items()
            if k in FFL_BATCH_KEYS}


def _port_step(model, batch, loss_fn, weights):
    model.zero_grad(set_to_none=True)
    total, terms = loss_fn(model.train()(model_inputs(batch)), batch, weights)
    total.backward()
    return {"loss": float(total.detach()), **{k: float(v) for k, v in terms.items()}}, \
        {n: p.grad.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("encoder", ["convnext", "unetresnet101"])
def test_ffl_train_step_matches_jax(encoder, ffl_variables, ffl_batch, datasets, tiny_encoders):  # noqa: F811
    """One train step's losses and gradients from the same weights on the
    same batch; each side's float32 gradient against the port's float64."""
    jcfg, pcfg = datasets
    variables = ffl_variables[encoder]
    jm = _jax_ffl(encoder)
    jloss, jweights = jax_losses.make_ffl_loss(jcfg)
    ploss, pweights = losses.make_ffl_loss(pcfg)
    jbatch = {k: jnp.asarray(v) for k, v in ffl_batch.items()}
    jw = {k: jnp.float32(v) for k, v in jweights(EPOCH).items()}

    @jax.jit
    def jax_step(params):
        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, {"images": jbatch["images"]},
                              train=True, mutable=["batch_stats"])
            total, terms = jloss(out, jbatch, jw)
            return total, terms
        (total, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return {"loss": total, **terms}, grads

    want, jgrads = jax_step(variables["params"])
    cfg = compose(_ffl_args(encoder))
    model = _bridged(build_ffl(cfg), variables)
    batch = {k: torch.from_numpy(v) for k, v in ffl_batch.items()}
    got, grads = _port_step(model, batch, ploss, pweights(EPOCH))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    exact = _bridged(build_ffl(cfg, dtype=torch.float64), variables).double()
    _, exact_grads = _port_step(exact, {k: (v.double() if v.is_floating_point() else v) for k, v in batch.items()},
                                ploss, pweights(EPOCH))
    jax_err = rel_l2(flax_to_state_dict(jax.device_get(jgrads)), exact_grads)
    port_err = rel_l2(grads, exact_grads)
    assert jax_err <= 1e-4 and port_err <= 1e-4 and port_err <= 2 * jax_err + 1e-6, (port_err, jax_err)


# --- Pix2Poly over the DINOv2 ViT ----------------------------------------------

DINO_ENC = {**TINY_ENC, "layer_scale": True}


def test_vit_dinov2_encoder_config_matches_jax():
    """The factory's branch (the ViT with LayerScale, patch 14) equals JAX's
    and builds the full-width model, which runs on a 16 px input."""
    args = ["experiment=p2p_image", "run_type=debug", "encoder=vit_dinov2", "experiment.encoder.in_size=16"]
    cfg = compose(args)
    assert p2p_factory.encoder_config(cfg) == jax_p2p_factory.encoder_config(jax_compose(args))
    assert p2p_factory.encoder_config(cfg)["layer_scale"] and p2p_factory.encoder_config(cfg)["patch_size"] == 14
    model = build_pix2poly(cfg)
    assert model.encoder.vit.block0.layer_scale
    y = torch.zeros(2, model.max_len - 1, dtype=torch.int64)
    with torch.no_grad():
        logits, perm = model.eval()({"images": torch.from_numpy(_images(8, size=16))}, y)
    assert logits.shape[:2] == (2, model.max_len - 1) and torch.isfinite(logits).all() and torch.isfinite(perm).all()


def test_vit_dinov2_logits_match_jax():
    """Teacher-forced logits of a tiny Pix2Poly whose ViT carries LayerScale
    gammas away from their 1e-5 init."""
    x = _images(9, size=16)
    y = np.random.RandomState(9).randint(0, 16, (2, TINY["max_len"] - 1)).astype(np.int32)
    jm = JaxPix2Poly(**TINY, encoder_cfg=DINO_ENC)
    args = ({"images": jnp.asarray(x)}, jnp.asarray(y))
    variables = _draw(jm, 9, *args)
    assert "ls1" in variables["params"]["encoder"]["vit"]["block0"]
    want_logits, want_perm = jax.jit(jm.apply)(variables, *args)
    port = _bridged(Pix2Poly(**TINY, encoder_cfg=DINO_ENC), variables)
    with torch.no_grad():
        logits, perm = port({"images": torch.from_numpy(x)}, torch.from_numpy(y).long())
    assert _rel(logits.numpy(), want_logits) <= TOL
    assert _rel(perm.numpy(), want_perm) <= TOL


def test_dinov2_graft_and_load_pretrained_vit_equal_jax(tmp_path):
    """A DINOv2 file (nested under `model`) whose pos_embed grid is twice the
    trunk's is grafted by both packages' set-up into the same state; a
    timm file under `state_dict` loads into the same tensors through each
    package's `load_pretrained_vit`."""
    grid = TINY_ENC["img_size"] // TINY_ENC["patch_size"]
    dino = str(tmp_path / "dinov2.pth")
    torch.save({"model": timm_vit_state(TINY_ENC["dim"], 12, TINY_ENC["patch_size"], 2 * grid, seed=11, dinov2=True)},
               dino)
    over = ["experiment=p2p_image", "run_type=debug", "encoder=vit_dinov2", "experiment.encoder.pretrained=true",
            f"experiment.encoder.checkpoint_file={dino}"]
    jm = JaxPix2Poly(**TINY, encoder_cfg=DINO_ENC)
    images = jnp.zeros((2, 16, 16, 3), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), {"images": images},
                            jnp.zeros((2, TINY["max_len"] - 1), jnp.int32))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = jax_apply(jax_compose(over), variables)
    model = Pix2Poly(**TINY, encoder_cfg=DINO_ENC)
    model.load_state_dict(flax_to_state_dict(variables["params"], variables.get("batch_stats")))
    assert apply_pretrained_encoder(compose(over), model) == [("encoder.vit", 24, 0)]
    want_sd = flax_to_state_dict(jax.device_get(want["params"]), jax.device_get(want.get("batch_stats")))
    got_sd = model.state_dict()
    assert set(got_sd) == set(want_sd)
    assert not [k for k in want_sd if not torch.equal(got_sd[k], want_sd[k])]
    assert float(got_sd["encoder.vit.block0.ls1"].abs().min()) > 0

    timm = str(tmp_path / "timm.pth")
    torch.save({"state_dict": timm_vit_state(TINY_ENC["dim"], 2, TINY_ENC["patch_size"], grid, seed=12)}, timm)
    got = load_pretrained_vit(timm, depth=2)
    want_vit = flax_to_state_dict(jax_load_pretrained_vit(timm, depth=2))
    assert set(got) == set(want_vit)
    assert all(torch.equal(torch.from_numpy(np.ascontiguousarray(got[k])).float(), want_vit[k]) for k in want_vit)
