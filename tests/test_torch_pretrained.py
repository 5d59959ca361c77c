"""The port's pretrained-encoder grafts and warm start against the JAX
package's, on the CPU.

Both packages read the same `.pth` files, written here from seeded numpy
with `torch.save` in the layouts of a timm ViT (fused or split qkv, under a
`module.` prefix with extra keys), a DINOv2 ViT and the reference's HRNetV2
(whole or partial). The port's grafted `state_dict` must equal
`flax_to_state_dict` of JAX's grafted variables bit for bit: the maps copy
tensors, and the one computation, `pos_embed`'s resampling, is the same
float64 numpy arithmetic on both sides. Then the warm start
(`init_weights_from`): the fuzzy matcher against JAX's on the same trees,
and a tiny port run's weights taken up with a fresh optimizer.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hrnet_reference_state, timm_vit_state
from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.models.hisup.model import HiSup as JaxHiSup
from pixelspointspolygons_tpu.models.pix2poly import Pix2Poly as JaxPix2Poly
from pixelspointspolygons_tpu.utils.checkpoint import smart_restore_params as jax_smart_restore
from pixelspointspolygons_tpu.utils.pretrained import apply_pretrained_encoder as jax_apply
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.models.hisup.model import HiSup
from pixelspointspolygons_torch.models.hrnet import HRNetEncoder
from pixelspointspolygons_torch.models.pix2poly import Pix2Poly
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from pixelspointspolygons_torch.utils.checkpoint import smart_restore_params
from pixelspointspolygons_torch.utils.pretrained import apply_pretrained_encoder
from test_torch_hisup import TOPO
from test_torch_train_pix2poly import TINY, TINY_ENC, flax_init

S, DIM = 64, 16
VIT_DIM, PATCH = TINY_ENC["dim"], TINY_ENC["patch_size"]


def _assert_equal_state(port_model, variables):
    want = flax_to_state_dict(jax.device_get(variables["params"]), jax.device_get(variables.get("batch_stats")))
    got = port_model.state_dict()
    assert set(got) == set(want)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:5]


def _write(tmp_path, name, sd) -> str:
    path = str(tmp_path / name)
    torch.save(sd, path)
    return path


@pytest.fixture(scope="module")
def p2p():
    images = np.zeros((2, 16, 16, 3), np.float32)
    jm = JaxPix2Poly(**TINY, encoder_cfg=TINY_ENC)
    return flax_init(jm, {"images": jnp.asarray(images)}, jnp.zeros((2, TINY["max_len"] - 1), jnp.int32))


def _vit_cfgs(path):
    over = ["experiment=p2p_image", "run_type=debug", "experiment.encoder.pretrained=true",
            f"experiment.encoder.checkpoint_file={path}"]
    return jax_compose(over), compose(over)


def _vit_file(kind: str) -> dict:
    """A 12-block file of the tiny trunk's width (the trunk takes block 0)."""
    grid = 16 // PATCH
    if kind == "timm_fused_prefixed":
        sd = timm_vit_state(VIT_DIM, 12, PATCH, grid, seed=1)
        sd = {f"module.{k}": v for k, v in sd.items()}
        sd.update({"module.head.weight": torch.zeros(10, VIT_DIM), "module.head.bias": torch.zeros(10),
                   "ema.module.cls_token": torch.zeros(1, 1, VIT_DIM)})
        return {"state_dict": sd}
    if kind == "timm_split_qkv":
        return timm_vit_state(VIT_DIM, 12, PATCH, grid, seed=2, split_qkv=True)
    if kind == "dinov2":
        return {"model": timm_vit_state(VIT_DIM, 12, PATCH, grid, seed=3, dinov2=True)}
    # a 224 px checkpoint's grid (8x8 here) resampled to the trunk's 4x4
    return timm_vit_state(VIT_DIM, 12, PATCH, 2 * grid, seed=4)


@pytest.mark.parametrize("kind", ["timm_fused_prefixed", "timm_split_qkv", "dinov2", "pos_embed_resampled"])
def test_vit_graft_equals_jax(p2p, kind, tmp_path):
    path = _write(tmp_path, "vit.pth", _vit_file(kind))
    jcfg, cfg = _vit_cfgs(path)
    want = jax_apply(jcfg, p2p)
    model = Pix2Poly(**TINY, encoder_cfg=TINY_ENC)
    model.load_state_dict(flax_to_state_dict(p2p["params"], p2p.get("batch_stats")))
    grafted = apply_pretrained_encoder(cfg, model)
    _assert_equal_state(model, want)
    # block 0 (16 tensors), the patch embedding, CLS, position embeddings, the norm;
    # DINOv2's gammas have no place in a trunk without LayerScale
    assert grafted == [("encoder.vit", 22, 0)]
    before = flax_to_state_dict(p2p["params"])
    assert not torch.equal(model.state_dict()["encoder.vit.pos_embed"], before["encoder.vit.pos_embed"])
    assert torch.equal(model.state_dict()["decoder.embedding.weight"], before["decoder.embedding.weight"])


@pytest.fixture(scope="module")
def hisup():
    images = np.random.RandomState(0).normal(size=(2, S, S, 3)).astype(np.float32)
    jm = JaxHiSup(encoder_cfg={"name": "hrnet", "in_size": S, **TOPO}, dim=DIM, pred_size=S)
    return flax_init(jm, {"images": jnp.asarray(images)})


def _hrnet_cfgs(path):
    over = ["experiment=hisup_image", "run_type=debug", "experiment.encoder.hrnet.pretrained=true",
            f"experiment.encoder.hrnet.checkpoint_file={path}"]
    return jax_compose(over), compose(over)


def _port_hisup(variables):
    model = HiSup(HRNetEncoder(in_size=S, out_dim=DIM, **TOPO), dim=DIM, pred_size=S)
    model.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    return model


@pytest.mark.parametrize("partial", [False, True])
def test_hrnet_graft_equals_jax(hisup, partial, tmp_path):
    """The whole reference layout under a `module.` prefix, and a partial
    file (no stage 4, no head): what the file lacks keeps its init."""
    model = _port_hisup(hisup)
    drop = ("stage4.", "last_layer.") if partial else ()
    sd = hrnet_reference_state(model.encoder, seed=5, drop=drop)
    path = _write(tmp_path, "hrnet.pth", {"state_dict": {f"module.{k}": v for k, v in sd.items()}})
    jcfg, cfg = _hrnet_cfgs(path)
    want = jax_apply(jcfg, hisup)
    grafted = apply_pretrained_encoder(cfg, model)
    _assert_equal_state(model, want)
    n_trunk = len(model.encoder.state_dict())
    assert grafted == [("encoder", len(sd), n_trunk - len(sd))] and (n_trunk > len(sd)) == partial
    init = flax_to_state_dict(hisup["params"], hisup["batch_stats"])
    now = model.state_dict()
    assert torch.equal(now["mask_head.conv0.weight"], init["mask_head.conv0.weight"])
    assert torch.equal(now["encoder.last_conv2.weight"], init["encoder.last_conv2.weight"]) == partial


def test_pretrained_without_a_file_keeps_init(hisup, p2p):
    """`pretrained: true` with `checkpoint_file: null` (config/encoder/hrnet.yaml)
    grafts nothing in either package: the model trains from its init."""
    for over, jvars, port in (
        (["experiment=hisup_image", "experiment.encoder.hrnet.pretrained=true"], hisup, _port_hisup(hisup)),
        (["experiment=p2p_image", "experiment.encoder.pretrained=true"], p2p, None),
    ):
        assert jax_apply(jax_compose(over), jvars) is jvars
        if port is None:
            port = Pix2Poly(**TINY, encoder_cfg=TINY_ENC)
            port.load_state_dict(flax_to_state_dict(p2p["params"], p2p.get("batch_stats")))
        before = copy.deepcopy(port.state_dict())
        assert apply_pretrained_encoder(compose(over), port) == []
        assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())


@pytest.mark.parametrize("experiment,key", [("hisup_image", "experiment.encoder.hrnet"), ("p2p_image", "experiment.encoder")])
def test_missing_pretrained_file_raises(hisup, p2p, experiment, key, tmp_path):
    over = [f"experiment={experiment}", f"{key}.pretrained=true", f"{key}.checkpoint_file={tmp_path}/absent.pth"]
    jvars = hisup if experiment == "hisup_image" else p2p
    with pytest.raises(FileNotFoundError):
        jax_apply(jax_compose(over), jvars)
    model = _port_hisup(hisup) if experiment == "hisup_image" else Pix2Poly(**TINY, encoder_cfg=TINY_ENC)
    with pytest.raises(FileNotFoundError, match="checkpoint not found"):
        apply_pretrained_encoder(compose(over), model)


def test_trainer_trains_from_init_with_pretrained_and_no_file(tmp_path, monkeypatch):
    """Fault 3.3: the HiSup trainer with `hrnet.pretrained=true` and no file
    sets up the init of its seed, as without the flag, and trains."""
    from pixelspointspolygons_torch.models.hisup import factory
    from pixelspointspolygons_torch.train.trainer_hisup import HiSupTrainer
    from test_torch_trainer import _overrides

    full = factory.encoder_config
    monkeypatch.setattr(factory, "encoder_config", lambda cfg: {**full(cfg), **TOPO})
    cfg = compose(_overrides(tmp_path, ["experiment.encoder.hrnet.pretrained=true"]))
    assert cfg.experiment.encoder.hrnet.pretrained and not cfg.experiment.encoder.hrnet.checkpoint_file
    trainer = HiSupTrainer(cfg, device="cpu")
    trainer.generator = torch.Generator().manual_seed(int(cfg.seed))
    trainer.setup()
    init = factory.build_hisup(cfg, generator=torch.Generator().manual_seed(int(cfg.seed))).state_dict()
    assert all(torch.equal(v, init[k]) for k, v in trainer.state.model.state_dict().items())
    history = HiSupTrainer(cfg, device="cpu").train()
    assert history["epoch"] == 0 and np.isfinite(history["loss"])


# --- warm start ------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("case", ["suffix", "shape_mismatch", "exact_and_suffix", "ambiguous", "unmatched"])
def test_smart_restore_params_matches_jax(case):
    """The cases of tests/test_infra.py (a renamed wrapper prefix; a shape
    that differs keeps init) and more: exact paths first, an ambiguous
    suffix, a leaf with no match."""
    z, o = np.zeros((4, 4), np.float32), np.ones((4, 4), np.float32)
    target, loaded = {
        "suffix": ({"encoder": {"vit": {"block0": {"kernel": z}}}}, {"model": {"vit": {"block0": {"kernel": o}}}}),
        "shape_mismatch": ({"a": {"kernel": z}}, {"a": {"kernel": np.ones((2, 2), np.float32)}}),
        "exact_and_suffix": ({"a": {"w": z, "b": z[0]}, "c": {"w": z}},
                             {"a": {"w": o, "b": o[0]}, "x": {"c": {"w": 2 * o}}}),
        "ambiguous": ({"enc": {"w": z}}, {"m1": {"w": o}, "m2": {"w": 2 * o}}),
        "unmatched": ({"a": {"w": z}, "b": {"v": z[0]}}, {"a": {"w": o}}),
    }[case]
    want = _flat(jax_smart_restore(target, loaded))
    got = smart_restore_params(_flat(target), _flat(loaded))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_init_weights_from_a_port_run(tmp_path, monkeypatch):
    """A tiny HiSup run's `latest` taken up by a new run: its weights and
    BatchNorm statistics, with the optimizer, the schedule and the epoch
    starting afresh. An absent file and a directory (an orbax checkpoint)
    raise."""
    from pixelspointspolygons_torch.models.hisup import factory
    from pixelspointspolygons_torch.train.trainer_hisup import HiSupTrainer
    from test_torch_trainer import _overrides

    full = factory.encoder_config
    monkeypatch.setattr(factory, "encoder_config", lambda cfg: {**full(cfg), **TOPO})
    first = HiSupTrainer(compose(_overrides(tmp_path / "a")), device="cpu")
    first.train()
    assert first.state.step == 2
    src = first.manager.path("latest")

    def setup(extra):
        trainer = HiSupTrainer(compose(_overrides(tmp_path / "b", extra)), device="cpu")
        trainer.generator = torch.Generator().manual_seed(7)  # another init than the first run's
        trainer.setup()
        return trainer

    warm = setup([f"init_weights_from={src}"])
    want = torch.load(src, weights_only=True)["model"]
    got = warm.state.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert warm.state.step == 0 and warm.start_epoch == 0 and warm.state.scheduler.last_epoch == 0
    assert not warm.state.optimizer.state
    assert warm.state.optimizer.param_groups[0]["lr"] == pytest.approx(float(warm.cfg.experiment.model.learning_rate))
    cold = setup([])
    assert not torch.equal(cold.state.model.state_dict()["encoder.conv1.weight"], want["encoder.conv1.weight"])
    with pytest.raises(FileNotFoundError, match="init_weights_from checkpoint not found"):
        setup([f"init_weights_from={tmp_path}/absent.pt"])
    os.makedirs(tmp_path / "orbax_latest")
    with pytest.raises(ValueError, match="only its own torch.save checkpoints"):
        setup([f"init_weights_from={tmp_path}/orbax_latest"])
