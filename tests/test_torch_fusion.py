"""The port's early-fusion encoders against the JAX package on the CPU, with
weights bridged from the flax tree: `EarlyFusionViTEncoder` (Pix2Poly's
`early_fusion_vit`), `EarlyFusionViTCNNEncoder` (HiSup's and FFL's
`early_fusion_vit_cnn`) and `FusionHRNetEncoder` (HiSup's `fusion_hrnet`);
the LiDAR dropout branch with its draw forced both ways; EarlyFusionViT at
bfloat16; the factories' encoder configs for the LiDAR and fusion
experiments; and the pretrained grafts into the LiDAR and fusion trunks.

Tolerances and why (float32 unless stated):
- eval mode: float32 sums in another order through the patch embedding, the
  pillar canvas, the fusion conv and one ViT block (and a tiny HRNet): 2e-5
  absolute on outputs of magnitude ~1-5;
- train mode: the fusion BatchNorm normalizes by the batch's statistics
  (flax with E[x²] − E[x]², ROADMAP 3.11), 1e-4 absolute;
- bfloat16 (8 significant bits; tests/test_torch_bf16.py's rule): the
  tokens within 8 ulps of their largest value, through the patch
  embedding, the PFN, the fusion conv and one ViT block, each rounded at
  slightly different places on the two sides;
- the grafts copy tensors: equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hrnet_reference_state, timm_vit_state
from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.models import fusion as jfusion
from pixelspointspolygons_tpu.models.ffl import build_ffl as jax_build_ffl
from pixelspointspolygons_tpu.models.hisup import factory as jax_hisup_factory
from pixelspointspolygons_tpu.models.hrnet import FusionHRNetEncoder as JaxFusionHRNet
from pixelspointspolygons_tpu.models.pix2poly import factory as jax_p2p_factory
from pixelspointspolygons_tpu.utils.pretrained import apply_pretrained_encoder as jax_apply
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.models import fusion
from pixelspointspolygons_torch.models.ffl import model as ffl_model
from pixelspointspolygons_torch.models.hisup import factory as hisup_factory
from pixelspointspolygons_torch.models.hisup.model import HiSup
from pixelspointspolygons_torch.models.hrnet import FusionHRNetEncoder
from pixelspointspolygons_torch.models.pix2poly import factory as p2p_factory
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from pixelspointspolygons_torch.utils.pretrained import apply_pretrained_encoder
from test_torch_bf16 import assert_ulps
from test_torch_ffl import _bridged, one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_hisup import TOPO
from test_torch_lidar import GRID, S, VIT, _apply, _canvas_variables, _t, cloud

FUSION = dict(max_points_per_voxel=4, **VIT, **GRID)
# FusionHRNet's pillar ViT keeps JAX's 6 heads and patch 8: a width of 48
HR = dict(in_size=S, out_dim=16, vit_dim=48, vit_depth=1, voxel_x=8.0, voxel_y=8.0, max_points_per_voxel=4,
          **{k: v for k, v in TOPO.items() if k != "stem_ch"})


def _images(seed=0, B=2):
    return np.random.RandomState(seed).normal(size=(B, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    pts, valid = cloud(7)
    return _images(7), pts, valid


def _j(images, pts, valid):
    return jnp.asarray(images), jnp.asarray(pts), jnp.asarray(valid)


@pytest.mark.parametrize("train", [False, True])
def test_early_fusion_vit_encoder_matches_jax(inputs, train):
    jm = jfusion.EarlyFusionViTEncoder(out_dim=24, **FUSION)
    variables = _canvas_variables(jm, *inputs[1:], seed=10, images=inputs[0])
    assert set(variables["params"]) == {"patch_embed", "pillar_canvas", "fusion_conv", "fusion_bn", "vit"}
    assert "patch_embed" not in variables["params"]["vit"]
    want = _apply(jm, variables, inputs, train)
    port = _bridged(fusion.EarlyFusionViTEncoder(out_dim=24, **FUSION), variables).train(train)
    with torch.no_grad():
        got = port(*map(_t, inputs))
    assert got.shape == (2, 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4 if train else 2e-5)


def test_early_fusion_vit_cnn_encoder_matches_jax(inputs):
    jm = jfusion.EarlyFusionViTCNNEncoder(out_size=S, out_dim=16, **FUSION)
    variables = _canvas_variables(jm, *inputs[1:], seed=11, images=inputs[0])
    assert set(variables["params"]) == {"fusion_vit", "Conv_0", "BatchNorm_0"}
    want = _apply(jm, variables, inputs)
    with torch.no_grad():
        got = _bridged(fusion.EarlyFusionViTCNNEncoder(out_size=S, out_dim=16, **FUSION), variables)(*map(_t, inputs))
    assert got.shape == (2, S, S, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_fusion_hrnet_encoder_matches_jax(inputs):
    """HRNet's 1/4 map ⊕ the pillar-ViT map resized align-corners 4² → 8²."""
    jm = JaxFusionHRNet(**HR)
    variables = _canvas_variables(jm, *inputs[1:], seed=12, images=inputs[0])
    assert set(variables["params"]) == {"hrnet", "pp_vit", "Conv_0", "BatchNorm_0"}
    want = _apply(jm, variables, inputs)
    with torch.no_grad():
        got = _bridged(FusionHRNetEncoder(**HR), variables)(*map(_t, inputs))
    assert got.shape == (2, S // 4, S // 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("rate,drops", [(1.0, True), (-1.0, False)])
def test_lidar_dropout_forced_both_ways(inputs, rate, drops):
    """In training the whole batch's LiDAR canvas is zeroed when the draw
    is at or below the rate: always at 1.0, never below 0. Each against
    JAX's train-mode forward with the same rate; the dropped output equals
    the output of clouds with no valid point."""
    jm = jfusion.EarlyFusionViTEncoder(out_dim=None, lidar_dropout=rate, **FUSION)
    variables = _canvas_variables(jm, *inputs[1:], seed=13, images=inputs[0])
    want = _apply(jm, variables, inputs, True, rngs={"lidar_dropout": jax.random.PRNGKey(0)})
    port = _bridged(fusion.EarlyFusionViTEncoder(out_dim=None, lidar_dropout=rate, **FUSION), variables).train()
    generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        got = port(*map(_t, inputs), generator=generator)
        no_lidar = _bridged(fusion.EarlyFusionViTEncoder(out_dim=None, **FUSION), variables).train()(
            _t(inputs[0]), _t(inputs[1]), torch.zeros(inputs[2].shape, dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert torch.equal(got, no_lidar) == drops
    # eval mode never drops
    port = _bridged(fusion.EarlyFusionViTEncoder(out_dim=None, lidar_dropout=rate, **FUSION), variables)
    with torch.no_grad():
        kept = port(*map(_t, inputs), generator=generator)
    np.testing.assert_allclose(kept.numpy(), np.asarray(_apply(jm, variables, inputs)), rtol=0, atol=2e-5)


def test_early_fusion_vit_matches_jax_at_bfloat16(inputs):
    jm = jfusion.EarlyFusionViTEncoder(out_dim=24, dtype=jnp.bfloat16, **FUSION)
    variables = _canvas_variables(jm, *inputs[1:], seed=14, images=inputs[0])
    want = _apply(jm, variables, inputs)
    port = _bridged(fusion.EarlyFusionViTEncoder(out_dim=24, dtype=torch.bfloat16, **FUSION), variables)
    with torch.no_grad():
        got = port(*map(_t, inputs))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_ulps(got, np.asarray(want, np.float32), 8)


# --- factories ---------------------------------------------------------------------

EXPERIMENTS = ["p2p_lidar", "p2p_fusion", "hisup_lidar", "hisup_fusion", "ffl_lidar", "ffl_fusion",
               "lidar_density_ablation4", "lidar_density_ablation512"]


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_encoder_config_matches_jax(experiment):
    """Each factory reads a LiDAR or fusion experiment's encoder config as
    JAX's does (fusion_hrnet without width and height, JAX factory.py:50-54;
    the density ablations' per-pillar cap)."""
    args = [f"experiment={experiment}", "dataset=synthetic"]
    cfg, jcfg = compose(args), jax_compose(args)
    name = cfg.experiment.model.name
    if name == "pix2poly":
        assert p2p_factory.encoder_config(cfg) == jax_p2p_factory.encoder_config(jcfg)
    elif name == "hisup":
        assert hisup_factory.encoder_config(cfg) == jax_hisup_factory.encoder_config(jcfg)
    else:
        assert ffl_model.encoder_config(cfg) == jax_build_ffl(jcfg).encoder_cfg
    if experiment.startswith("lidar_density"):
        assert ffl_model.encoder_config(cfg)["max_points_per_voxel"] == int(experiment[len("lidar_density_ablation"):])


# --- pretrained grafts -------------------------------------------------------------


def test_hrnet_graft_reaches_fusion_hrnet(inputs, tmp_path):
    """`encoder.hrnet.pretrained` grafts the HRNet trunk of `fusion_hrnet`
    at `encoder.hrnet` as JAX's does (pretrained.py:111-130); the pillar ViT
    and the fusion conv keep their weights."""
    enc = {"name": "fusion_hrnet", **{k: v for k, v in HR.items() if k != "out_dim"}}
    jm = jax_hisup_factory.HiSup(encoder_cfg=enc, dim=16, pred_size=S)
    batch = dict(zip(("images", "lidar", "lidar_mask"), _j(*inputs)))
    variables = jax.device_get(_canvas_variables_of_hisup(jm, batch))
    model = HiSup(FusionHRNetEncoder(**HR), dim=16, pred_size=S)
    model.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    sd = hrnet_reference_state(model.encoder.hrnet, seed=5)
    path = str(tmp_path / "hrnet.pth")
    torch.save({"state_dict": sd}, path)
    over = ["experiment=hisup_fusion", "run_type=debug", "experiment.encoder.hrnet.pretrained=true",
            f"experiment.encoder.hrnet.checkpoint_file={path}"]
    want = flax_to_state_dict(*(jax.device_get(jax_apply(jax_compose(over), variables))[k]
                                for k in ("params", "batch_stats")))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grafted = apply_pretrained_encoder(compose(over), model)
    got = model.state_dict()
    assert grafted == [("encoder.hrnet", len(sd), len(model.encoder.hrnet.state_dict()) - len(sd))]
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(got["encoder.conv0.weight"], before["encoder.conv0.weight"])
    assert not torch.equal(got["encoder.hrnet.conv1.weight"], before["encoder.hrnet.conv1.weight"])


def _canvas_variables_of_hisup(jm, batch):
    rng = np.random.RandomState(15)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("encoder", ["pointpillars_vit", "early_fusion_vit"])
def test_vit_graft_reaches_lidar_and_fusion_trunks(encoder, tmp_path):
    """`encoder.vit.pretrained` grafts every ViT trunk, the LiDAR and fusion
    encoders' too, as JAX's does; their trunks have no patch embedding and
    take none, the fusion encoder's own `patch_embed` keeps its weights."""
    from pixelspointspolygons_tpu.models.pix2poly import Pix2Poly as JaxPix2Poly
    from pixelspointspolygons_torch.models.pix2poly import Pix2Poly
    from test_torch_train_pix2poly import TINY, flax_init

    enc = {"name": encoder, "max_points_per_voxel": 4, **VIT, **GRID}
    images, pts, valid = _images(8), *cloud(8)
    batch = {"lidar": jnp.asarray(pts), "lidar_mask": jnp.asarray(valid)}
    if encoder == "early_fusion_vit":
        batch["images"] = jnp.asarray(images)
    jm = JaxPix2Poly(**TINY, encoder_cfg=enc)
    variables = flax_init(jm, batch, jnp.zeros((2, TINY["max_len"] - 1), jnp.int32))
    path = str(tmp_path / "vit.pth")
    torch.save(timm_vit_state(VIT["dim"], 12, VIT["patch_size"], S // VIT["patch_size"], seed=1), path)
    over = ["experiment=p2p_lidar", "run_type=debug", "experiment.encoder.vit.pretrained=true",
            f"experiment.encoder.vit.checkpoint_file={path}"]
    want = flax_to_state_dict(*(jax.device_get(jax_apply(jax_compose(over), variables)).get(k)
                                for k in ("params", "batch_stats")))
    model = Pix2Poly(**TINY, encoder_cfg=enc)
    model.load_state_dict(flax_to_state_dict(variables["params"], variables.get("batch_stats")))
    grafted = apply_pretrained_encoder(compose(over), model)
    got = model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    # block 0 (16 tensors), CLS, position embeddings, the norm: no patch embedding
    assert grafted == [("encoder.vit", 20, 0)]
    assert "encoder.vit.patch_embed.weight" not in got
