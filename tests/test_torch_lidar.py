"""The port's LiDAR modules against the JAX package on the CPU: the segment
ops, the pillar voxelizer (`assign_pillars`, `scatter_pillars`), the
PillarFeatureNet and PillarCanvas in train and eval mode (outputs, running
statistics, gradients), the two LiDAR-only ViT encoders and the dense
PointPillars encoder, with weights bridged from the flax tree; and
PillarCanvas at bfloat16 against flax's `dtype=bfloat16`.

Tolerances and why (float32 unless stated):
- segment sums, means and the centroids of `assign_pillars`: both sides add
  each segment's rows one by one in index order on the CPU, so they are
  equal; 1e-6 absolute is allowed for XLA's fusions. Maxima, sorts, ranks,
  kept masks and pillar ids are exact;
- PillarCanvas: its outputs lie in [0, ~10]; in train mode flax's
  BatchNorm takes the variance as E[x²] − E[x]² (ROADMAP 3.11), the port's
  `RowBatchNorm` from `torch.var_mean`, and most rows are padding zeros.
  Both lie within 3e-7 of the float64 result relative to the largest
  output at 300, 900 and 3,000 points, so the outputs are held to 2e-5
  absolute, the running statistics to 1e-6 relative (+1e-7), the gradient
  to 1e-5 relative to its largest element (the max's gradient is split
  over tied rows alike on both sides); in eval mode 2e-5;
- the encoders in eval mode: float32 sums in another order through one ViT
  block or a conv pyramid: 2e-5 absolute on outputs of magnitude ~1-5; in
  train mode the map head's BatchNorm normalizes 2,048 values a channel by
  batch statistics (flax's E[x²] − E[x]² again): 1e-4 (6.6e-5 read);
- bfloat16 (8 significant bits): the canvas within 2 ulps of its largest
  value (each side rounds the Dense, BatchNorm and max once per layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.models import pointpillars as jpp
from pixelspointspolygons_tpu.models.hisup.encoders import PointPillarsViTCNNEncoder as JaxPPViTCNN
from pixelspointspolygons_tpu.ops import segment as jseg
from pixelspointspolygons_tpu.ops import voxelize as jvox
from pixelspointspolygons_torch.models import pointpillars as ppp
from pixelspointspolygons_torch.models.hisup.encoders import PointPillarsViTCNNEncoder
from pixelspointspolygons_torch.ops import segment, voxelize
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_bf16 import assert_ulps
from test_torch_ffl import _bridged, _random_variables, one_torch_thread  # noqa: F401 (an autouse fixture)

S, VOXEL = 32, 8.0
GRID = dict(width=float(S), height=float(S), voxel_x=VOXEL, voxel_y=VOXEL)
VIT = dict(img_size=S, patch_size=8, dim=32, depth=1, num_heads=2)
CHANNELS = (8, 16)


def cloud(seed: int, B: int = 2, N: int = 300, valid_frac: float = 0.8):
    """Points over [-4, S + 4) (some outside the grid), a few on pillar
    borders and on the far edge, and a random validity mask."""
    r = np.random.RandomState(seed)
    pts = r.uniform(-4, S + 4, (B, N, 3)).astype(np.float32)
    pts[:, :8, :2] = np.array([[0, 0], [8, 8], [16, 7.999], [S, 3], [3, S], [S - 1e-3, S - 1e-3], [24, 0], [0, 24]])
    return pts, r.rand(B, N) < valid_frac


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# --- ops -------------------------------------------------------------------------


def test_segment_ops_match_jax():
    """Sums, maxima (empty segments at -inf), means, softmax weights over
    segments, and the run starts and ranks of sorted ids."""
    r = np.random.RandomState(0)
    data = r.normal(size=(60, 3)).astype(np.float32)
    ids = r.randint(0, 7, 60)  # segments 7 and 8 stay empty
    for name in ("segment_sum", "segment_max", "segment_mean"):
        got = getattr(segment, name)(_t(data), _t(ids), 9).numpy()
        want = np.asarray(getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids), 9))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
    assert np.isneginf(segment.segment_max(_t(data), _t(ids), 9).numpy()[7:]).all()
    score = r.normal(size=60).astype(np.float32)
    np.testing.assert_allclose(segment.segment_softmax_weights(_t(score), _t(ids), 9).numpy(),
                               np.asarray(jseg.segment_softmax_weights(jnp.asarray(score), jnp.asarray(ids), 9)),
                               rtol=0, atol=1e-6)
    sorted_ids = np.sort(r.randint(0, 5, 40))
    np.testing.assert_array_equal(segment.run_starts(_t(sorted_ids)).numpy(),
                                  np.asarray(jseg.run_starts(jnp.asarray(sorted_ids))))
    np.testing.assert_array_equal(segment.rank_in_run(_t(sorted_ids)).numpy(),
                                  np.asarray(jseg.rank_in_run(jnp.asarray(sorted_ids))))


def test_segment_max_gradient_splits_ties_as_jax():
    """The gradient of a segment max goes to the rows that reach it, split
    evenly where several tie, as jax.grad of jax.ops.segment_max."""
    data = np.array([[1.0, 0.0], [3.0, 0.0], [3.0, 0.0], [2.0, 5.0], [-1.0, 5.0], [0.5, 5.0]], np.float32)
    ids = np.array([0, 0, 0, 1, 1, 1])
    w = np.array([[2.0, -3.0], [0.5, 7.0]], np.float32)
    x = _t(data).requires_grad_()
    (segment.segment_max(x, _t(ids), 2) * _t(w)).sum().backward()
    want = jax.grad(lambda d: (jseg.segment_max(d, jnp.asarray(ids), 2) * w).sum())(jnp.asarray(data))
    # an ulp apart where a share is 7/3: JAX multiplies by the count's reciprocal
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=2e-7, atol=0)
    assert float(x.grad[1, 0]) == float(x.grad[2, 0]) == 1.0 and float(x.grad[0, 1]) == -1.0


@pytest.mark.parametrize("cap", [1, 4, 1000])  # 1000 covers every pillar
def test_assign_pillars_matches_jax(cap):
    pts, valid = cloud(1)
    got = voxelize.assign_pillars(_t(pts), _t(valid), max_points_per_voxel=cap, **GRID)
    want = jvox.voxelize_batch(jnp.asarray(pts), jnp.asarray(valid), max_points_per_voxel=cap, **GRID)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.pillar_id.numpy(), np.asarray(want.pillar_id))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), rtol=0, atol=1e-6)
    assert got.n_cells == 16
    kept = got.keep.numpy()
    counts = np.stack([np.bincount(got.pillar_id.numpy()[b][kept[b]], minlength=17) for b in range(2)])
    assert counts[:, :16].max() <= cap and counts[:, 16].sum() == 0
    # the points kept in each pillar are its first ones in input order
    ix, iy = np.floor(pts[..., 0] / VOXEL), np.floor(pts[..., 1] / VOXEL)
    inside = valid & (ix >= 0) & (ix < 4) & (iy >= 0) & (iy < 4)
    assert counts.sum() == sum(min(cap, int(((iy * 4 + ix)[b][inside[b]] == c).sum())) for b in range(2)
                               for c in range(16))


def test_scatter_pillars_matches_jax():
    pts, valid = cloud(2, B=1)
    a = voxelize.assign_pillars(_t(pts), _t(valid), max_points_per_voxel=3, **GRID)
    feats = np.random.RandomState(3).normal(size=(300, 5)).astype(np.float32)
    got = voxelize.scatter_pillars(_t(feats), a.pillar_id[0], a.keep[0], 16, 4, 4)
    want = jvox.scatter_pillars(jnp.asarray(feats), jnp.asarray(a.pillar_id[0].numpy()), jnp.asarray(a.keep[0].numpy()),
                                16, 4, 4)
    assert got.shape == (4, 4, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- PillarFeatureNet and PillarCanvas ----------------------------------------------


def _canvas_variables(jm, pts, valid, seed=0, images=None):
    """`_random_variables` of a module that takes (points, valid), or
    (images, points, valid)."""
    args = (jnp.asarray(pts), jnp.asarray(valid))
    args = args if images is None else (jnp.asarray(images),) + args
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(jm, variables, args, train=False, **kw):
    """JAX's forward, jitted: in train mode its output without the updated
    statistics."""
    args = tuple(jnp.asarray(a) for a in args)
    if not train:
        return jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(variables, *args)
    return jax.jit(lambda v, *a: jm.apply(v, *a, train=True, mutable=["batch_stats"], **kw)[0])(variables, *args)


def _padded(pts, valid, n):
    """The same clouds padded with zeros (mask False) to n points."""
    B, N, _ = pts.shape
    return (np.concatenate([pts, np.zeros((B, n - N, 3), np.float32)], 1),
            np.concatenate([valid, np.zeros((B, n - N), bool)], 1))


@pytest.fixture(scope="module")
def canvas():
    pts, valid = cloud(4)
    jm = jpp.PillarCanvas(max_points_per_voxel=4, feat_channels=CHANNELS, **GRID)
    variables = _canvas_variables(jm, pts, valid)
    assert set(variables["params"]) == {"PillarFeatureNet_0"}
    assert set(variables["params"]["PillarFeatureNet_0"]["Dense_0"]) == {"kernel"}
    return {"jm": jm, "variables": variables, "pts": pts, "valid": valid}


def _port_canvas(variables, dtype=None):
    return _bridged(ppp.PillarCanvas(max_points_per_voxel=4, feat_channels=CHANNELS, dtype=dtype, **GRID), variables)


@pytest.mark.parametrize("n_points", [300, 900])
def test_pillar_canvas_train_mode_matches_jax(canvas, n_points):
    """Train mode at two padding lengths of the same clouds: outputs, the
    updated running statistics and the gradient of every parameter agree
    with JAX's at each length; the padding rows enter the BatchNorm's
    statistics, so they differ between the lengths."""
    pts, valid = _padded(canvas["pts"], canvas["valid"], n_points)
    jm, variables = canvas["jm"], canvas["variables"]
    w = np.random.RandomState(5).normal(size=(2, 4, 4, CHANNELS[-1])).astype(np.float32)

    def loss(params):
        out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(pts),
                            jnp.asarray(valid), train=True, mutable=["batch_stats"])
        return (out * w).sum(), (out, upd)

    (_, (want, upd)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    port = _port_canvas(variables).train()
    got = port(_t(pts), _t(valid))
    (got * _t(w)).sum().backward()
    assert got.shape == (2, 4, 4, CHANNELS[-1])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    stats = flax_to_state_dict({}, jax.device_get(upd["batch_stats"]))
    sd = port.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    want_grads = flax_to_state_dict(jax.device_get(jgrads))
    for name, p in port.named_parameters():
        g = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=name)
    # the statistics see the padding: they are not those of the unpadded clouds
    base = _port_canvas(variables).train()
    base(_t(canvas["pts"]), _t(canvas["valid"]))
    assert (n_points == 300) == torch.equal(base.pfn.bn1.running_var, port.pfn.bn1.running_var)


def test_pillar_canvas_eval_mode_matches_jax(canvas):
    pts, valid, variables = canvas["pts"], canvas["valid"], canvas["variables"]
    want = jax.jit(canvas["jm"].apply)(variables, jnp.asarray(pts), jnp.asarray(valid))
    with torch.no_grad():
        got = _port_canvas(variables)(_t(pts), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    assert float((got == 0).all(dim=-1).float().mean()) < 1  # some pillars hold points


def test_pillar_canvas_matches_jax_at_bfloat16(canvas):
    pts, valid = canvas["pts"], canvas["valid"]
    jm = jpp.PillarCanvas(max_points_per_voxel=4, feat_channels=CHANNELS, dtype=jnp.bfloat16, **GRID)
    variables = canvas["variables"]
    for train in (False, True):
        want = _apply(jm, variables, (pts, valid), train)
        port = _port_canvas(variables, torch.bfloat16).train(train)
        with torch.no_grad():
            got = port(_t(pts), _t(valid))
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert_ulps(got, np.asarray(want, np.float32), 2)


# --- encoders --------------------------------------------------------------------


def test_pointpillars_vit_encoder_matches_jax(canvas):
    """Pix2Poly's `pointpillars_vit`: the canvas as tokens of a trunk
    without a patch embedding, the bottleneck to out_dim."""
    pts, valid = canvas["pts"], canvas["valid"]
    jm = jpp.PointPillarsViTEncoder(out_dim=24, max_points_per_voxel=4, **VIT, **GRID)
    variables = _canvas_variables(jm, pts, valid, 1)
    assert set(variables["params"]) == {"pillar_canvas", "vit"} and "patch_embed" not in variables["params"]["vit"]
    want = _apply(jm, variables, (pts, valid))
    port = _bridged(ppp.PointPillarsViTEncoder(out_dim=24, max_points_per_voxel=4, **VIT, **GRID), variables)
    assert port.vit.patch_embed is None
    with torch.no_grad():
        got = port(_t(pts), _t(valid))
    assert got.shape == (2, 16, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_pointpillars_vit_cnn_encoder_matches_jax(canvas):
    """HiSup's and FFL's `pointpillars_vit_cnn`, in eval and train mode."""
    pts, valid = canvas["pts"], canvas["valid"]
    jm = JaxPPViTCNN(out_size=S, out_dim=16, max_points_per_voxel=4, **VIT, **GRID)
    variables = _canvas_variables(jm, pts, valid, 2)
    assert set(variables["params"]) == {"pp_vit", "Conv_0", "BatchNorm_0"}
    port = _bridged(PointPillarsViTCNNEncoder(out_size=S, out_dim=16, max_points_per_voxel=4, **VIT, **GRID),
                    variables)
    for train in (False, True):
        want = _apply(jm, variables, (pts, valid), train)
        with torch.no_grad():
            got = port.train(train)(_t(pts), _t(valid))
        assert got.shape == (2, S, S, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4 if train else 2e-5,
                                   err_msg=f"train={train}")


def test_pointpillars_dense_encoder_matches_jax():
    """The dense encoder (no experiment selects it): 2 px pillars on a
    16 x 16 grid, three conv levels with flax's "SAME" padding at stride 2,
    the FPN resizes and the shrink to out_size."""
    pts, valid = cloud(6)
    kw = dict(width=float(S), height=float(S), voxel_x=2.0, voxel_y=2.0, max_points_per_voxel=4,
              out_channels=(8, 8, 8), out_size=12, out_dim=8)
    jm = jpp.PointPillarsDenseEncoder(**kw)
    variables = _canvas_variables(jm, pts, valid, 3)
    assert {f"Conv_{i}" for i in range(7)} | {"pillar_canvas"} <= set(variables["params"])
    want = _apply(jm, variables, (pts, valid))
    port = _bridged(ppp.PointPillarsDenseEncoder(**kw), variables)
    with torch.no_grad():
        got = port(_t(pts), _t(valid))
    assert got.shape == (2, 12, 12, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_same_conv_pads_as_flax():
    """Stride 2 on an even and an odd size, stride 1: flax's "SAME" grid."""
    import flax.linen as fnn

    for size, stride in ((8, 2), (7, 2), (6, 1)):
        x = np.random.RandomState(size).normal(size=(1, size, size, 3)).astype(np.float32)
        jm = fnn.Conv(4, (3, 3), (stride, stride), padding="SAME")
        variables = _random_variables(jm, jnp.asarray(x), size)
        port = _bridged(ppp.SameConv2d(3, 4, 3, stride), variables)
        got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(variables, jnp.asarray(x))), rtol=0, atol=1e-5)
