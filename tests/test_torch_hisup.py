"""The PyTorch port's HRNet encoder, HiSup model, targets and losses against
the JAX package, on the same numpy inputs and bridged weights (CPU, float32).

Tolerances and why:
- eval-mode forwards: atol 1e-4 on outputs of magnitude ~1-50 — float32
  convolutions summed in another order through ~40 layers;
- train-mode forwards: 1e-3 relative to each output's scale — batch
  statistics of a 2-sample batch (the deepest HRNet branch is 4x4) amplify
  those sums' rounding;
- batch_stats after a train-mode forward: 1e-4 relative (+1e-5 absolute);
- targets: jloc exact, joff 1e-6, afmap as tests/test_torch_afm.py;
- losses on identical inputs: 1e-5 relative (float32 means over ~6k
  elements summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.models.hisup import model as jax_hisup
from pixelspointspolygons_tpu.models.hrnet import HRNetEncoder as JaxHRNet
from pixelspointspolygons_torch.models.hisup.model import (
    ECA,
    HiSup,
    encode_targets,
    hisup_losses,
)
from pixelspointspolygons_torch.models.hrnet import HRNetEncoder
from pixelspointspolygons_torch.models.layers import BatchNorm, init_flax_defaults
from pixelspointspolygons_torch.utils.bridge import _module_name, flax_to_state_dict

TOPO = dict(width=4, stage1_planes=4, stage1_blocks=1, num_blocks=1, num_modules=(1, 1, 1), stem_ch=8)
S, DIM = 64, 16


def _images(seed=0, B=2, size=S):
    return np.random.RandomState(seed).normal(size=(B, size, size, 3)).astype(np.float32)


def _perturbed(variables, seed=1):
    """Init values with noise added everywhere (BN scale/bias and running
    stats included), so no leaf keeps a trivial value."""
    rng = np.random.RandomState(seed)

    def f(x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32)
        return jnp.asarray(np.abs(x + 0.1 * noise) if x.ndim == 1 and x.min() > 0 else x + 0.05 * noise)

    return jax.tree_util.tree_map(f, variables)


def _bridge(variables):
    return flax_to_state_dict(jax.device_get(variables["params"]), jax.device_get(variables.get("batch_stats", {})))


def _assert_stats_close(module, batch_stats):
    want = flax_to_state_dict({}, jax.device_get(batch_stats))
    got = module.state_dict()
    assert want, "no batch_stats to compare"
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def _assert_scaled_close(got, want, rel, name=""):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("train", [False, True])
def test_hrnet_encoder_matches_jax(train):
    img = _images()
    jm = JaxHRNet(in_size=S, out_dim=DIM, **TOPO)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(img)))
    tm = HRNetEncoder(in_size=S, out_dim=DIM, **TOPO)
    tm.load_state_dict(_bridge(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(img)).numpy()
    if train:
        want, mut = jm.apply(v, jnp.asarray(img), train=True, mutable=["batch_stats"])
        _assert_scaled_close(got, np.asarray(want), 1e-3)
        _assert_stats_close(tm, mut["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(img), train=False)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert got.shape == (2, S // 4, S // 4, DIM)


def _jax_hisup():
    return jax_hisup.HiSup(encoder_cfg={"name": "hrnet", "in_size": S, **TOPO}, dim=DIM, pred_size=S)


def _port_hisup():
    return HiSup(HRNetEncoder(in_size=S, out_dim=DIM, **TOPO), dim=DIM, pred_size=S)


@pytest.mark.parametrize("train", [False, True])
def test_hisup_forward_matches_jax(train):
    img = _images(3)
    jm = _jax_hisup()
    v = _perturbed(jm.init(jax.random.PRNGKey(0), {"images": jnp.asarray(img)}))
    tm = _port_hisup()
    tm.load_state_dict(_bridge(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm({"images": torch.from_numpy(img)})
    if train:
        want, mut = jm.apply(v, {"images": jnp.asarray(img)}, train=True, mutable=["batch_stats"])
        _assert_stats_close(tm, mut["batch_stats"])
    else:
        want = jm.apply(v, {"images": jnp.asarray(img)}, train=False)
    assert set(got) == set(want) == {"joff", "jloc", "mask", "afm", "remask"}
    for k in want:
        assert got[k].shape == want[k].shape, k
        if train:
            _assert_scaled_close(got[k].numpy(), np.asarray(want[k]), 1e-3, k)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)


def test_full_width_parameter_counts_match():
    """HRNetV2-W48 at 224 px with head width 256: the same leaves, shapes
    and count on both sides (JAX by eval_shape, the port on the meta device)."""
    jm = jax_hisup.HiSup(encoder_cfg={"name": "hrnet", "in_size": 224}, dim=256, pred_size=224)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), {"images": jnp.zeros((1, 224, 224, 3))})
    tm = HiSup(HRNetEncoder(in_size=224, out_dim=256, device="meta"), dim=256, pred_size=224, device="meta")
    port = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        keys = tuple(str(p.key) for p in path)
        shape = tuple(leaf.shape)
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[keys[-1]]
        if keys[-1] == "kernel":
            shape = (shape[3], shape[2], *shape[:2]) if len(shape) == 4 else shape[::-1]
        want[f"{_module_name(keys[:-1])}.{name}"] = shape
    assert port == want
    n_jax = sum(int(np.prod(s)) for s in want.values())
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert n_jax > 70e6  # HRNetV2-W48 trunk (~65M) + heads


def test_batchnorm_running_var_is_biased_like_flax():
    """A 2x4x4 batch: flax updates var with the biased batch variance."""
    import flax.linen as fnn

    x = np.random.RandomState(0).normal(size=(2, 4, 4, 3)).astype(np.float32)
    fb = fnn.BatchNorm(momentum=0.9, use_running_average=False)
    fv = fb.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_jax, mut = fb.apply(fv, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(3).train()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y_jax), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), rtol=1e-5)
    unbiased = torch.nn.BatchNorm2d(3, momentum=0.1).train()
    unbiased(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(unbiased.running_var.numpy(), bn.running_var.numpy(), rtol=1e-4)


def test_eca_kernel_size_and_flax_init_distribution():
    assert ECA(256).conv1d.kernel_size == (5,)
    assert ECA(16).conv1d.kernel_size == (3,)
    conv = torch.nn.Conv2d(64, 64, 3)
    init_flax_defaults(conv, torch.Generator().manual_seed(0))
    w = conv.weight.detach().numpy().ravel()
    std = np.sqrt(1.0 / (64 * 9)) / 0.87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-7  # truncated at ±2σ
    assert abs(w.std() - np.sqrt(1.0 / (64 * 9))) < 0.03 * np.sqrt(1.0 / (64 * 9))  # variance 1/fan_in
    assert conv.bias.abs().sum() == 0


def _target_batch(size=32, B=3, J=10, E=12, seed=0):
    rng = np.random.RandomState(seed)
    juncs = np.zeros((B, J, 2), np.float32)
    tags = np.zeros((B, J), np.int32)
    valid = np.zeros((B, J), bool)
    # sample 0: a real junction in pixel (0,0) next to padding that also lands
    # there; two touching buildings sharing a pixel with different offsets
    juncs[0, :5] = [[0.3, 0.6], [5.25, 7.75], [20.0, 20.5], [20.4, 20.1], [31.9, 31.99]]
    tags[0, :5] = [2, 1, 2, 1, 2]
    valid[0, :5] = True
    # sample 1: random junctions, the padding first and valid ones after
    juncs[1, 4:] = rng.uniform(0, size, (J - 4, 2))
    tags[1, 4:] = rng.randint(1, 3, J - 4)
    valid[1, 4:] = True
    # sample 2: nothing valid
    edges = rng.uniform(0, size, (B, E, 4)).astype(np.float32)
    evalid = rng.rand(B, E) < 0.6
    evalid[2] = False
    mask = (rng.rand(B, size, size) < 0.3).astype(np.float32)
    return {
        "junctions": juncs,
        "junc_tags": tags,
        "junc_valid": valid,
        "edges": edges,
        "edges_valid": evalid,
        "mask": mask,
    }


def test_encode_targets_matches_jax():
    batch = _target_batch()
    want = jax_hisup.encode_targets({k: jnp.asarray(v) for k, v in batch.items()}, 32)
    got = encode_targets({k: torch.from_numpy(v) for k, v in batch.items()}, 32)
    np.testing.assert_array_equal(got["jloc"].numpy(), np.asarray(want["jloc"]))
    np.testing.assert_allclose(got["joff"].numpy(), np.asarray(want["joff"]), atol=1e-6)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    a_got, a_want = got["afmap"].numpy(), np.asarray(want["afmap"])
    well = np.abs(np.sign(a_want) * 32 * (np.exp(-np.abs(a_want)) - 1e-6)) >= 0.01
    np.testing.assert_allclose(a_got[well], a_want[well], atol=3e-4)
    jloc = got["jloc"].numpy()
    assert jloc[0, 0, 0] == 2  # the real junction survives the padding at (0,0)
    assert jloc[2].sum() == 0 and np.abs(got["afmap"][2].numpy()).sum() == 0
    # the junction listed last wins the shared pixel, as JAX's .set on the CPU
    np.testing.assert_allclose(got["joff"][0, :, 20, 20].numpy(), [0.4 - 0.5, 0.1 - 0.5], atol=1e-6)
    assert got["joff"][0, :, 0, 0].abs().sum() == 0  # padding listed after it wins pixel (0,0)


def test_losses_match_jax():
    rng = np.random.RandomState(7)
    batch = _target_batch()
    B, size = 3, 32
    outputs = {
        "jloc": rng.normal(size=(B, 3, size, size)).astype(np.float32),
        "joff": rng.normal(size=(B, 2, size, size)).astype(np.float32),
        "mask": rng.normal(size=(B, 2, size, size)).astype(np.float32),
        "afm": rng.normal(size=(B, 2, size, size)).astype(np.float32),
        "remask": rng.normal(size=(B, 2, size, size)).astype(np.float32),
    }
    jt = jax_hisup.encode_targets({k: jnp.asarray(v) for k, v in batch.items()}, size)
    want = jax_hisup.hisup_losses({k: jnp.asarray(v) for k, v in outputs.items()}, jt)
    # the same targets on both sides: JAX's, as tensors
    tt = {k: torch.from_numpy(np.array(v)) for k, v in jt.items()}
    got = hisup_losses({k: torch.from_numpy(v) for k, v in outputs.items()}, tt)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
