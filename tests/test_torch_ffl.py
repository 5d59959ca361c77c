"""The port's FFL model side against the JAX package on the CPU: the
crossfield ops, `bilinear_interpolate`, `ViTCNNEncoder`, HiSup with the
`vit_cnn` encoder and `FFL` (`vit_cnn` and `hrnet` encoders), with weights
bridged from the flax tree, and the refusals of what is not ported.

Tolerances and why (float32 throughout):
- crossfield ops: XLA's CPU backend computes a complex product's real part
  as fma(a, c, -b·d) and its imaginary part as fma(b, c, a·d), and its own
  sin/cos; torch rounds each product. So results agree to a few float32
  ulps of their magnitude: 1e-6 relative to the largest |value| (an ulp is
  6e-8 relative); the splits and the (int) closest-axis test are exact,
  the latter outside near-ties (|dot_u - dot_v| < 1e-5);
- `bilinear_interpolate`: the same float32 operations in the same order,
  1e-6 absolute on values in [-3, 3];
- the models in eval mode: float32 sums in another order through the ViT
  and 3-4 convolutions, 1e-5 absolute on ViTCNN features of magnitude ~1-3
  and on seg in [0, 1], 2e-5 on the crossfield in [-2, 2] and on HiSup's
  heads.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.models.ffl import FFL as JaxFFL
from pixelspointspolygons_tpu.models.ffl import build_ffl as jax_build_ffl
from pixelspointspolygons_tpu.models.hisup import factory as jax_hisup_factory
from pixelspointspolygons_tpu.models.hisup.model import HiSup as JaxHiSup
from pixelspointspolygons_tpu.models.vit import ViTCNNEncoder as JaxViTCNN
from pixelspointspolygons_tpu.ops import bilinear as jax_bilinear
from pixelspointspolygons_tpu.ops import crossfield as jax_cf
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.models.ffl import FFL, build_ffl
from pixelspointspolygons_torch.models.ffl import model as ffl_model
from pixelspointspolygons_torch.models.hisup import factory as hisup_factory
from pixelspointspolygons_torch.models.hisup.model import HiSup
from pixelspointspolygons_torch.models.hrnet import HRNetEncoder
from pixelspointspolygons_torch.models.vit import ViTCNNEncoder
from pixelspointspolygons_torch.ops import bilinear, crossfield
from pixelspointspolygons_torch.predict.ffl_polygonize import Polygonizer
from pixelspointspolygons_torch.train.state import compute_dtype
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict

VIT = dict(img_size=32, patch_size=8, dim=32, depth=1, num_heads=2)  # tests/test_ffl.py::tiny_ffl
TOPO = dict(width=4, stage1_planes=4, stage1_blocks=1, num_blocks=1, num_modules=(1, 1, 1), stem_ch=8)
S, DIM = 32, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread in these modules. The ACM's steps are a few
    hundred small operations each; when the suite's parallel workers load
    every core, an intra-op thread pool makes each operation wait for
    threads the other workers hold (a 30 s file took 1,014 s), and one
    thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- ops ----------------------------------------------------------------------


def test_crossfield_ops_match_jax():
    r = np.random.RandomState(0)
    cf = r.uniform(-2, 2, (2, 4, 16, 16)).astype(np.float32)
    angle = r.uniform(0, np.pi, (2, 16, 16)).astype(np.float32)
    c0, c2 = crossfield.crossfield_to_c0c2(torch.from_numpy(cf))
    j0, j2 = jax_cf.crossfield_to_c0c2(jnp.asarray(cf))
    assert c0.dtype == torch.complex64
    np.testing.assert_array_equal(c0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(j2))
    hwc0, _ = crossfield.crossfield_to_c0c2(torch.from_numpy(cf.transpose(0, 2, 3, 1)), channel_axis=-1)
    np.testing.assert_array_equal(hwc0.numpy(), c0.numpy())

    z, jz = crossfield.angle_to_z(torch.from_numpy(angle)), jax_cf.angle_to_z(jnp.asarray(angle))
    assert _rel(z.numpy(), jz) <= 1e-6
    jz_np = np.asarray(jz)
    z_same = torch.from_numpy(jz_np)  # the same directions on both sides from here
    assert _rel(crossfield.framefield_align_error(c0, c2, z_same), jax_cf.framefield_align_error(j0, j2, jz)) <= 1e-6

    u, v = crossfield.c0c2_to_uv(c0, c2)
    ju, jv = jax_cf.c0c2_to_uv(j0, j2)
    assert _rel(u.numpy(), ju) <= 1e-6 and _rel(v.numpy(), jv) <= 1e-6
    uu, uv = crossfield.uv_to_c0c2(u, v)
    juu, juv = jax_cf.uv_to_c0c2(ju, jv)
    assert _rel(uu.numpy(), juu) <= 1e-6 and _rel(uv.numpy(), juv) <= 1e-6

    # the closest axis, on the same (u, v) and directions, outside near-ties
    ju_t, jv_t = torch.from_numpy(np.asarray(ju)), torch.from_numpy(np.asarray(jv))
    got = crossfield.closest_in_uv(z_same, ju_t, jv_t).numpy()
    want = np.asarray(jax_cf.closest_in_uv(jz, ju, jv))
    gap = np.abs(np.abs(ju_t.real * z_same.real + ju_t.imag * z_same.imag)
                 - np.abs(jv_t.real * z_same.real + jv_t.imag * z_same.imag)).numpy()
    assert got.dtype == want.dtype == np.int32 and 0 < want.mean() < 1
    np.testing.assert_array_equal(got[gap >= 1e-5], want[gap >= 1e-5])

    x = r.normal(size=(2, 3, 9, 11)).astype(np.float32)
    assert _rel(crossfield.laplacian_penalty(torch.from_numpy(x)), jax_cf.laplacian_penalty(jnp.asarray(x))) <= 1e-6


def test_bilinear_interpolate_matches_jax():
    """Positions inside, on the border, outside (clamped corners) and on
    integers, from two maps."""
    r = np.random.RandomState(1)
    im = r.uniform(-3, 3, (2, 3, 12, 17)).astype(np.float32)
    pos = np.concatenate([
        r.uniform(-2, 14, (200, 2)),
        np.round(r.uniform(0, 11, (40, 2))),
        [[0, 0], [11, 16], [11.5, 16.5], [-0.5, 3.25]],
    ]).astype(np.float32)
    batch = r.randint(0, 2, len(pos)).astype(np.int32)
    got = bilinear.bilinear_interpolate(torch.from_numpy(im), torch.from_numpy(pos), torch.from_numpy(batch).long())
    want = jax_bilinear.bilinear_interpolate(jnp.asarray(im), jnp.asarray(pos), jnp.asarray(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    got0 = bilinear.bilinear_interpolate(torch.from_numpy(im), torch.from_numpy(pos))
    want0 = jax_bilinear.bilinear_interpolate(jnp.asarray(im), jnp.asarray(pos))
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), rtol=0, atol=1e-6)


# --- models -------------------------------------------------------------------


def _images(seed=0, B=2, size=S):
    return np.random.RandomState(seed).normal(size=(B, size, size, 3)).astype(np.float32)


def _random_variables(module, inputs, seed: int) -> dict:
    """Flax variables of `module` drawn from a numpy seed in the shapes its
    init gives (`jax.eval_shape`, no compile): kernels N(0, 1/fan_in),
    BatchNorm scales and variances in [0.5, 1.5], everything else
    N(0, 0.1), so that no leaf keeps a trivial value."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), inputs)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _leaf_count(tree) -> int:
    return len(jax.tree_util.tree_leaves(tree))


def _bridged(module, variables) -> torch.nn.Module:
    """Load the flax variables into `module`; every leaf is consumed and
    every tensor of the module is set."""
    sd = flax_to_state_dict(variables["params"], variables.get("batch_stats", {}))
    assert len(sd) == _leaf_count(variables["params"]) + _leaf_count(variables.get("batch_stats", {}))
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return module.eval()


def test_vit_cnn_encoder_matches_jax():
    x = _images()
    jm = JaxViTCNN(out_size=S, out_dim=DIM, **VIT)
    variables = _random_variables(jm, jnp.asarray(x), 0)
    assert set(variables["params"]) == {"vit", "Conv_0", "BatchNorm_0"}
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    port = _bridged(ViTCNNEncoder(out_size=S, out_dim=DIM, **VIT), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, S, S, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_hisup_vit_cnn_matches_jax():
    """HiSup's vit_cnn branch: the factory's encoder config equals JAX's, and
    the model with bridged weights gives JAX's heads."""
    cfg_args = ["experiment=hisup_image", "dataset=synthetic", "experiment.encoder.name=vit_cnn"]
    cfg, jcfg = compose(cfg_args), jax_compose(cfg_args)
    assert hisup_factory.encoder_config(cfg) == jax_hisup_factory.encoder_config(jcfg)
    assert type(hisup_factory.build_hisup(compose(cfg_args + ["experiment.encoder.in_size=16"])).encoder) is ViTCNNEncoder

    x = _images(2)
    jm = JaxHiSup(encoder_cfg={"name": "vit_cnn", **VIT, "out_size": S}, dim=16, pred_size=S)
    variables = _random_variables(jm, {"images": jnp.asarray(x)}, 1)
    want = jax.jit(jm.apply)(variables, {"images": jnp.asarray(x)})
    port = _bridged(HiSup(ViTCNNEncoder(out_size=S, out_dim=16, **VIT), dim=16, pred_size=S), variables)
    with torch.no_grad():
        got = port({"images": torch.from_numpy(x)})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("encoder", ["vit_cnn", "hrnet"])
def test_ffl_matches_jax(encoder):
    """FFL in eval mode, both outputs, with bridged weights; the HRNet map
    (S/4) is resized up to S as in JAX."""
    x = _images(3)
    if encoder == "vit_cnn":
        jenc, penc = {"name": "vit_cnn", **VIT, "out_size": S}, ViTCNNEncoder(out_size=S, out_dim=DIM, **VIT)
    else:
        jenc, penc = {"name": "hrnet", "in_size": S, **TOPO}, HRNetEncoder(in_size=S, out_dim=DIM, **TOPO)
    jm = JaxFFL(encoder_cfg=jenc, dim=DIM, seg_channels=1, out_size=S)
    variables = _random_variables(jm, {"images": jnp.asarray(x)}, 2)
    want = jax.jit(jm.apply)(variables, {"images": jnp.asarray(x)})
    port = _bridged(FFL(penc, dim=DIM, seg_channels=1, out_size=S), variables)
    with torch.no_grad():
        got = port({"images": torch.from_numpy(x)})
    assert got["seg"].shape == (2, 1, S, S) and got["crossfield"].shape == (2, 4, S, S)
    np.testing.assert_allclose(got["seg"].numpy(), np.asarray(want["seg"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["crossfield"].numpy(), np.asarray(want["crossfield"]), rtol=0, atol=2e-5)


def test_build_ffl_matches_jax_config():
    """`build_ffl` reads the config as JAX's does: encoder, width, seg
    channels, heads and size (the full-width ViT is built at a 16 px input
    to stay cheap)."""
    args = ["experiment=ffl_image", "dataset=synthetic", "experiment.encoder.in_size=16",
            "experiment.model.seg.compute_edge=true"]
    model, jm = build_ffl(compose(args)), jax_build_ffl(jax_compose(args))
    assert isinstance(model.encoder, ViTCNNEncoder)
    assert ffl_model.encoder_config(compose(args)) == jm.encoder_cfg
    assert model.seg_out.out_channels == jm.seg_channels == 2
    assert model.out_size == jm.out_size == 16 and model.seg_conv.out_channels == jm.dim
    assert (model.compute_seg, model.compute_crossfield) == (jm.compute_seg, jm.compute_crossfield)
    x = _images(4, size=16)
    with torch.no_grad():
        out = model.eval()({"images": torch.from_numpy(x)})
    assert out["seg"].shape == (2, 2, 16, 16) and out["crossfield"].shape == (2, 4, 16, 16)
    assert float(out["crossfield"].abs().max()) <= 2.0 and 0.0 <= float(out["seg"].min())


@pytest.mark.parametrize(
    "encoder,item",
    [
        ("early_fusion_vit_cnn", "LiDAR and fusion"),
        ("pointpillars_vit_cnn", "LiDAR and fusion"),
        ("pointpillars", "LiDAR and fusion"),
        ("unetresnet101", "Remaining encoders and CLI"),
        ("convnext", "Remaining encoders and CLI"),
    ],
)
def test_encoders_not_ported_raise(encoder, item):
    cfg = copy.deepcopy(compose(["experiment=ffl_image", "dataset=synthetic"]))
    cfg.experiment.encoder.name = encoder
    with pytest.raises(NotImplementedError, match=f"ROADMAP 'Port queue' item '{item}'"):
        build_ffl(cfg)


def test_options_not_ported_raise():
    """FFL at bfloat16 and the ASM polygonization, which once named item
    'FFL', are ported: the model builds computing in bfloat16 with float32
    parameters (held to flax's in tests/test_torch_ffl_bf16.py), the
    polygonizer takes `[acm,asm]` (tests/test_torch_ffl_asm.py); a method
    that does not exist still raises."""
    bf16 = compose(["experiment=ffl_image", "dataset=synthetic", "host.compute_dtype=bfloat16",
                    "experiment.encoder.in_size=16"])
    model = build_ffl(bf16, dtype=compute_dtype(bf16))
    assert model.compute_dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model.eval()({"images": torch.from_numpy(_images(5, size=16))})
    assert out["seg"].dtype == out["crossfield"].dtype == torch.bfloat16
    asm = compose(["experiment=ffl_image", "dataset=synthetic", "experiment.polygonization.method=[acm,asm]"])
    assert Polygonizer(asm.experiment.polygonization).methods == ["acm", "asm"]
    asm.experiment.polygonization.method = ["acm", "snake"]
    with pytest.raises(ValueError, match="snake"):
        Polygonizer(asm.experiment.polygonization)
