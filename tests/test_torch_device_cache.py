"""The device cache and activation recomputation, the port's against the JAX
package's on the CPU (`tests/test_device_cache.py` builds JAX's cache on a
one-device CPU mesh; the port's runs on `device="cpu"`), at 64 px tiles:

- the packs of the three families and the three modalities, key by key;
- the batches of epochs 0 and 1 (and the val split) with GaussNoise off:
  order, D4 elements and jitter replayed from the same numpy streams, every
  leaf that comes from uint8 or from the junctions equal, the LiDAR point
  sets equal after sorting (the two caches shuffle with different
  generators), the images within a bound;
- the Gaussian noise by its statistics; the port's cache against the port's
  own host loader; the fit check, the single-process refusal and the
  trainers' fallbacks; `cli/prebuild_caches.py`;
- one train step from each package's cache batch (tiny FFL-image and tiny
  HiSup-fusion, bridged weights); the HiSup step with `remat` against the
  step without it and against JAX's `remat` step;
- ROADMAP 3.13: the PillarFeatureNet's train-mode output at the host
  loader's pad and at the cache's trimmed pad.

Tolerances and why:
- packs, tokens, permutations, masks, rasters, angle values, junctions,
  edges, tags, ids: equal. The angle values follow what XLA compiles JAX's
  `u8 · π / 255 + π / 2` to (one fused multiply-add), so they are equal too;
- images: 1e-5 absolute on normalized pixels of magnitude up to ~3 (read
  ≤ 2.7e-6): each image's jitter mean is a float32 sum in another order
  than XLA's, and XLA contracts the normalization into fused multiply-adds;
- against the host loader, as `tests/test_device_cache.py` holds JAX's:
  images 1e-5 (the host loader divides where the cache multiplies),
  junctions and edges 1e-4, angle values 1e-5, float16 weight maps 1e-3;
- the noise: the mean within 5 standard errors of 0, the standard deviation
  within 3 % of each sample's sigma (over ≥ 3,000 pixels a sample);
- a train step's losses: 1e-5 relative (float32 sums in another order;
  ROADMAP 3.11); BatchNorm statistics 5e-4 relative (+1e-5,
  tests/test_torch_slice_lidar.py);
- the HiSup-fusion gradient, relative L2 over all parameters (ROADMAP
  3.16): the port's float32 gradient within 2e-3 of JAX's (reads 1.2e-3);
  the step itself with the model, its weights and the batch in float64
  (JAX under x64; both packages take the loss terms in float32), the
  port's gradient within 1e-5 of JAX's (reads 3.4e-6); and each package's
  float32 gradient within 2e-3 of its own float64 one (reads 1.5e-3 for
  the port on one thread, where torch's CPU convolution sums each weight
  gradient over B·H·W in one float32 chain, and 8.6e-4 for JAX): HiSup's
  float32 gradient is ill-conditioned, and the 2e-3 between the packages
  measures each one's float32 rounding, not a difference of their steps;
- remat against no remat (the port): equal losses, gradients and BatchNorm
  buffers (the recompute runs the same CPU kernels on the same inputs);
- the PillarFeatureNet at each pad: 2e-5 absolute (tests/test_torch_lidar.py);
  the two pads apart by more than 1e-3.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.data import device_cache as jdc
from pixelspointspolygons_tpu.data.synthetic import ensure_synthetic_dataset as jax_ensure
from pixelspointspolygons_tpu.models import pointpillars as jpp
from pixelspointspolygons_tpu.models.ffl import FFL as JaxFFL
from pixelspointspolygons_tpu.models.ffl import losses as jax_losses
from pixelspointspolygons_tpu.models.hisup.model import HiSup as JaxHiSup
from pixelspointspolygons_tpu.models.pix2poly import Tokenizer as JaxTokenizer
from pixelspointspolygons_tpu.parallel import make_mesh
from pixelspointspolygons_tpu.train import ffl_step as jax_ffl_step
from pixelspointspolygons_tpu.train import state as jax_state
from pixelspointspolygons_torch.cli import prebuild_caches
from pixelspointspolygons_torch.cli import train as cli_train
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data import augment, device_cache
from pixelspointspolygons_torch.data.loader import build_loader
from pixelspointspolygons_torch.data.synthetic import ensure_synthetic_dataset
from pixelspointspolygons_torch.models import pointpillars as ppp
from pixelspointspolygons_torch.models.ffl import FFL
from pixelspointspolygons_torch.models.ffl import model as ffl_model
from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss
from pixelspointspolygons_torch.models.fusion import EarlyFusionViTCNNEncoder
from pixelspointspolygons_torch.models.hisup import factory as hisup_factory
from pixelspointspolygons_torch.models.hisup.model import HiSup
from pixelspointspolygons_torch.models.hrnet import FusionHRNetEncoder
from pixelspointspolygons_torch.models.layers import BatchNorm
from pixelspointspolygons_torch.models.pix2poly import Tokenizer
from pixelspointspolygons_torch.models.pix2poly import factory as p2p_factory
from pixelspointspolygons_torch.models.vit import ViTCNNEncoder
from pixelspointspolygons_torch.train import ffl_step, hisup_step
from pixelspointspolygons_torch.train.state import TrainState, cosine_with_warmup, make_optimizer, make_scheduler
from pixelspointspolygons_torch.train.trainer import Trainer
from pixelspointspolygons_torch.train.trainer_ffl import FFL_BATCH_KEYS, FFLTrainer
from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS as HISUP_KEYS
from pixelspointspolygons_torch.train.trainer_hisup import HiSupTrainer
from pixelspointspolygons_torch.train.trainer_pix2poly import Pix2PolyTrainer
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_ffl import _random_variables, one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_hisup import TOPO
from test_torch_lidar import _canvas_variables

S, DIM, LR, WD = 64, 16, 1e-4, 1e-4
GRAD64_TOL, GRAD32_TOL = 1e-5, 2e-3
CPU = torch.device("cpu")
IMAGE_TOL = 1e-5
AUGS = "[D4,ColorJitter,Normalize]"
VIT = dict(img_size=S, patch_size=8, dim=32, depth=1, num_heads=2)
# FusionHRNet's pillar ViT keeps JAX's 6 heads and patch 8; the per-pillar
# cap covers every pillar, so the two caches' shuffles keep the same points
HR = dict(in_size=S, vit_dim=48, vit_depth=1, voxel_x=8.0, voxel_y=8.0, max_points_per_voxel=4096,
          **{k: v for k, v in TOPO.items() if k != "stem_ch"})

# (experiment, extra overrides): the families and modalities packed
CASES = {
    "p2p_image": ("p2p_image", ()),
    "p2p_lidar": ("p2p_lidar", ()),
    "hisup_image": ("hisup_image", ("experiment.model.decoder.in_feature_size=32",)),
    "hisup_fusion": ("hisup_fusion", ()),
    "ffl_image": ("ffl_image", ("experiment.model.loss.seg.use_dist=true", "experiment.model.loss.seg.use_size=true")),
    "ffl_lidar": ("ffl_lidar", ()),
}


def overrides(root, experiment, extra=(), augs=AUGS):
    return [
        f"experiment={experiment}",
        "dataset=synthetic",
        "run_type=release",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.country=CH",
        "experiment.dataset.num_train=6",
        "experiment.dataset.num_val=3",
        "experiment.dataset.num_test=2",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "run_type.num_workers=0",
        "experiment.model.batch_size=3",
        f"experiment.encoder.in_size={S}",
        f"experiment.model.decoder.in_feature_size={S}",
        f"experiment.model.decoder.in_feature_dim={DIM}",
        "experiment.encoder.patch_feature_dim=96",
        "experiment.encoder.max_num_points=256",
        "experiment.model.tokenizer.max_num_vertices=48",
        f"experiment.encoder.augmentations={augs}",
        *extra,
    ]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One synthetic tile set per package, each written by its own package."""
    root = tmp_path_factory.mktemp("torch_device_cache")
    jax_ensure(jax_compose(overrides(root / "jax", "hisup_fusion")))
    ensure_synthetic_dataset(compose(overrides(root / "port", "hisup_fusion")))
    return root


def _cfgs(roots, case, augs=AUGS):
    experiment, extra = CASES[case]
    return jax_compose(overrides(roots / "jax", experiment, extra, augs)), compose(
        overrides(roots / "port", experiment, extra, augs))


def _caches(roots, case, split, augs=AUGS):
    jcfg, pcfg = _cfgs(roots, case, augs)
    mesh = make_mesh(n_devices=1)
    family = pcfg.experiment.model.name
    if family == "pix2poly":
        return (jdc.P2PDeviceCache(jcfg, split, JaxTokenizer(jcfg), mesh),
                device_cache.P2PDeviceCache(pcfg, split, Tokenizer(pcfg), CPU))
    if family == "hisup":
        return jdc.HiSupDeviceCache(jcfg, split, mesh), device_cache.HiSupDeviceCache(pcfg, split, CPU)
    return jdc.FFLDeviceCache(jcfg, split, mesh), device_cache.FFLDeviceCache(pcfg, split, CPU)


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _assert_same_points(want_pts, want_mask, got_pts, got_mask):
    """Each cloud's valid points equal as sets (sorted rows)."""
    want_pts, want_mask, got_pts, got_mask = map(_np, (want_pts, want_mask, got_pts, got_mask))
    np.testing.assert_array_equal(got_mask.sum(1), want_mask.sum(1))
    for b in range(len(want_pts)):
        w, g = want_pts[b][want_mask[b]], got_pts[b][got_mask[b]]
        np.testing.assert_array_equal(g[np.lexsort(g.T[::-1])], w[np.lexsort(w.T[::-1])])
    assert not got_pts[~got_mask].any()


def _assert_batches_equal(want: dict, got: dict):
    assert set(got) == set(want)
    for k in want:
        w, g = _np(want[k]), _np(got[k])
        if k in ("lidar", "lidar_mask"):
            continue
        assert g.shape == w.shape, k
        if k == "images":
            np.testing.assert_allclose(g, w, rtol=0, atol=IMAGE_TOL, err_msg=k)
        else:
            assert g.dtype == w.dtype or (k == "y" and g.dtype == np.int64), (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
    if "lidar" in want:
        _assert_same_points(want["lidar"], want["lidar_mask"], got["lidar"], got["lidar_mask"])


# --- packs and batches against JAX's -------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_packs_match_jax(roots, case):
    """Each family's pack on each modality it is tested on, key by key, and
    under the port's own name beside JAX's."""
    jcfg, pcfg = _cfgs(roots, case)
    family = pcfg.experiment.model.name
    for split in ("train", "val"):
        if family == "pix2poly":
            want = jdc.build_p2p_cache_arrays(jcfg, split, JaxTokenizer(jcfg))
            got = device_cache.build_p2p_cache_arrays(pcfg, split, Tokenizer(pcfg))
            path = device_cache._cache_path(pcfg, split)
        elif family == "hisup":
            want = jdc.build_hisup_cache_arrays(jcfg, split)
            got = device_cache.build_hisup_cache_arrays(pcfg, split)
            path = device_cache._hisup_cache_path(pcfg, split)
        else:
            want, want_cf = jdc.build_ffl_cache_arrays(jcfg, split)
            got, got_cf = device_cache.build_ffl_cache_arrays(pcfg, split)
            np.testing.assert_array_equal(got_cf, want_cf)
            path = device_cache._ffl_cache_path(pcfg, split)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert os.path.isfile(path) and "_torch_" in os.path.basename(path)
    if pcfg.experiment.encoder.use_lidar:
        assert got["lidar"].shape[1] == 256 and got["lidar_n"].max() == 256  # the tiles' first 256 points


@pytest.mark.parametrize("case", ["p2p_image", "p2p_lidar", "hisup_image", "hisup_fusion", "ffl_image"])
def test_batches_match_jax(roots, case):
    """Epochs 0 and 1 of the train split and epoch 0 of the val split (its
    last batch repeat-padded), colour jitter on, GaussNoise off."""
    for split, epochs in (("train", (0, 1)), ("val", (0,))):
        jcache, pcache = _caches(roots, case, split)
        assert len(pcache) == len(jcache) == (2 if split == "train" else 1)
        for epoch in epochs:
            want, got = list(jcache.epoch_batches(epoch)), list(pcache.epoch_batches(epoch))
            assert len(got) == len(want)
            for w, g in zip(want, got):
                _assert_batches_equal(w, g)
    assert pcache.augmentations == [] and list(got[0]["sample_valid"]) == [True, True, True]


def test_d4_on_the_device_matches_augment():
    """Every D4 element on a non-symmetric map, on keypoints and on angle
    values, batched, against augment.py's numpy (the host loader's)."""
    r = np.random.RandomState(0)
    maps = device_cache._d4_index_maps(5, CPU)
    tables = device_cache._d4_tables(CPU)
    d4 = torch.arange(8)
    img = r.randint(0, 255, (8, 5, 5, 3)).astype(np.uint8)
    pts = r.uniform(0, 4, (8, 7, 3)).astype(np.float32)
    ang = r.uniform(0, np.pi, (8, 3, 4)).astype(np.float32)
    ang[:, 0, :3] = [0.0, np.float32(np.pi / 2), np.float32(np.pi) - 1e-6]
    got_img = device_cache._d4_image(torch.from_numpy(img), d4, maps).numpy()
    got_pts = device_cache._d4_xy(torch.from_numpy(pts), d4, 5, 5, tables).numpy()
    got_ang = device_cache._d4_angle_value(torch.from_numpy(ang), d4, tables).numpy()
    for i, g in enumerate(augment.D4_ELEMENTS):
        np.testing.assert_array_equal(got_img[i], augment.apply_d4_image(img[i], g))
        np.testing.assert_array_equal(got_pts[i], augment.apply_d4_lidar(pts[i], g, 5, 5))
        np.testing.assert_allclose(got_ang[i], augment.apply_d4_crossfield_angle(ang[i], g), rtol=0, atol=1e-6)


def test_noise_field_statistics(roots):
    """With GaussNoise on, the noise added to each image (unit scale, where
    the clean pixel is far from the clip) has mean 0 and standard deviation
    the sample's sigma; the draw is the same for the same (seed, epoch)."""
    _, clean = _caches(roots, "ffl_image", "train", "[D4,Normalize]")
    _, noisy = _caches(roots, "ffl_image", "train", "[D4,GaussNoise,Normalize]")
    scale = noisy.std / 255.0 * noisy.max_pix
    for epoch in (0, 1):
        for b, (c, n) in enumerate(zip(clean.epoch_batches(epoch), noisy.epoch_batches(epoch))):
            unit_c = c["images"] * scale + noisy.mean / 255.0 * noisy.max_pix
            noise = ((n["images"] - c["images"]) * scale).numpy()
            order = np.random.RandomState(noisy.seed + epoch).permutation(noisy.n)
            for k, i in enumerate(order[b * 3 : (b + 1) * 3]):
                rng = np.random.RandomState((noisy.seed * 1_000_003 + epoch * 10_007 + int(i)) % (2**31))
                sigma = augment.sample_params(rng, noisy.augmentations)["noise_sigma"]
                far = ((unit_c[k] > 0.2) & (unit_c[k] < 0.8)).numpy()
                x = noise[k][far]
                assert x.size >= 3000
                assert abs(x.mean()) <= 5 * sigma / np.sqrt(x.size)
                assert abs(x.std() / sigma - 1) <= 0.03
    again = next(iter(noisy.epoch_batches(1)))["images"]
    assert torch.equal(again, next(iter(noisy.epoch_batches(1)))["images"])


@pytest.mark.parametrize("case", ["p2p_image", "hisup_image", "ffl_image"])
def test_cache_matches_host_loader(roots, case):
    """The port's cache against the port's host loader on epochs 0 and 1 (D4
    and Normalize), as tests/test_device_cache.py holds JAX's. HiSup's
    decoder-resolution mask (here 32² of 64² tiles) is ROADMAP 3.14: the
    cache moves the resized mask, the host loader resizes the moved one,
    and a nearest-neighbour resize does not commute with the flips, so a
    few pixels along the edges of the buildings differ (as in JAX)."""
    _, pcfg = _cfgs(roots, case, "[D4,Normalize]")
    family = pcfg.experiment.model.name
    tokenizer = Tokenizer(pcfg) if family == "pix2poly" else None
    loader = build_loader(pcfg, "train", tokenizer=tokenizer)
    cls = {"pix2poly": device_cache.P2PDeviceCache, "hisup": device_cache.HiSupDeviceCache,
           "ffl": device_cache.FFLDeviceCache}[family]
    cache = cls(pcfg, "train", tokenizer, CPU) if tokenizer else cls(pcfg, "train", CPU)
    exact = {"pix2poly": ("y", "y_perm"), "hisup": ("mask_ori", "junc_tags", "junc_valid", "edges_valid"),
             "ffl": ("gt_polygons_image",)}[family]
    close = {"pix2poly": {}, "hisup": {"junctions": 1e-4, "edges": 1e-4},
             "ffl": {"gt_crossfield_angle": 1e-5, "distances": 1e-3, "sizes": 1e-3, "class_freq": 1e-6}}[family]
    mask_differs = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        host = list(loader)
        dev = list(cache.epoch_batches(epoch))
        assert len(dev) == len(host) == 2
        for hb, db in zip(host, dev):
            if family == "hisup":
                differs = db["mask"].numpy() != hb["mask"]
                assert differs.mean() < 0.05
                mask_differs.append(differs.any())
            np.testing.assert_array_equal(db["image_id"], hb["image_id"])
            np.testing.assert_allclose(db["images"].numpy(), hb["images"], rtol=0, atol=IMAGE_TOL)
            for k in exact:
                np.testing.assert_array_equal(db[k].numpy(), hb[k], err_msg=k)
            for k, tol in close.items():
                np.testing.assert_allclose(db[k].numpy(), hb[k].astype(np.float32), rtol=0, atol=tol, err_msg=k)
    assert any(mask_differs) == (family == "hisup")


def test_perm_factorization_round_trip(roots):
    _, pcfg = _cfgs(roots, "p2p_image")
    arrays = device_cache.build_p2p_cache_arrays(pcfg, "train", Tokenizer(pcfg))
    from pixelspointspolygons_torch.data.dataset import P3Dataset, build_perm_targets

    ds = P3Dataset(pcfg, "train")
    perms = [build_perm_targets(ds._polygons(ds.coco.imgs[t]), 48)[1] for t in ds.tile_ids]
    got = device_cache.perm_rebuild(torch.from_numpy(arrays["succ"]), torch.from_numpy(arrays["extra"]), 48)
    np.testing.assert_array_equal(got.numpy(), np.stack(perms))
    assert any(p.trace() < 48 for p in perms)


# --- the fit check, the fallbacks, prebuilding ------------------------------------


def test_fit_check_raises_before_any_upload(roots, monkeypatch):
    _, pcfg = _cfgs(roots, "ffl_image")
    monkeypatch.setattr(device_cache, "_device_memory_budget", lambda device: 100_000)

    def no_upload(*a):
        raise AssertionError("uploaded before the fit check")

    monkeypatch.setattr(device_cache, "_upload", no_upload)
    with pytest.raises(device_cache.CacheFitError, match="more than half"):
        device_cache.FFLDeviceCache(pcfg, "train", CPU)


def test_cache_refuses_more_than_one_process(roots, monkeypatch):
    _, pcfg = _cfgs(roots, "hisup_image")
    monkeypatch.setattr(device_cache, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="one process"):
        device_cache.HiSupDeviceCache(pcfg, "train", CPU)


@pytest.mark.parametrize("mode,error,falls_back", [
    ("auto", device_cache.CacheFitError, True),
    ("true", device_cache.CacheFitError, True),
    ("auto", NotImplementedError, True),
    ("true", NotImplementedError, False),
    ("auto", ValueError, True),
    ("true", ValueError, False),
    ("false", None, True),
])
def test_fallback_semantics(roots, mode, error, falls_back, monkeypatch):
    """JAX's: `auto` takes the host loader on NotImplementedError or
    ValueError, `true` only on CacheFitError (with a warning), and raises on
    anything else; `false` builds no cache."""
    _, pcfg = _cfgs(roots, "hisup_image")
    pcfg.training.device_cache = mode
    trainer = Trainer(pcfg, device="cpu")
    warnings = []
    monkeypatch.setattr(trainer.logger, "warning", warnings.append)

    def build(split):
        if error is None:
            raise AssertionError("no cache is built when the option is off")
        raise error("refused")

    if not falls_back:
        with pytest.raises(error, match="refused"):
            trainer.make_device_caches(build)
        return
    assert trainer.make_device_caches(build) is None
    assert (error is not None) == any("device cache unavailable" in w for w in warnings)


@pytest.fixture()
def tiny_trunks(monkeypatch):
    """The config tree fixes the trunks' widths and depths; shrink them."""
    for module, small in ((hisup_factory, TOPO), (ffl_model, {"depth": 1, "num_heads": 2}),
                          (p2p_factory, {"depth": 1, "num_heads": 2})):
        full = module.encoder_config
        monkeypatch.setattr(module, "encoder_config", lambda cfg, full=full, small=small: {**full(cfg), **small})


@pytest.mark.parametrize("trainer_cls,case", [(HiSupTrainer, "hisup_image"), (Pix2PolyTrainer, "p2p_image"),
                                              (FFLTrainer, "ffl_image")])
def test_each_trainer_takes_the_cache_or_falls_back(roots, tiny_trunks, monkeypatch, trainer_cls, case):
    """Each trainer's set-up: with `device_cache=true` the cache serves both
    splits and sets the schedule's steps (it drops the last partial batch;
    the host loader pads it); when the split would not fit, the host loader;
    with `auto` on a Pix2Poly config that shuffles tokens, the host loader."""
    _, pcfg = _cfgs(roots, case)
    pcfg.experiment.model.batch_size = 4  # 6 tiles: 1 cached batch, 2 host ones
    pcfg.training.device_cache = "true"
    trainer = trainer_cls(pcfg, device="cpu")
    trainer.generator = torch.Generator().manual_seed(0)
    trainer.setup()
    assert trainer.cache is not None and set(trainer.cache) == {"train", "val"}
    assert trainer.steps_per_epoch() == len(trainer.cache["train"]) == 1 and len(trainer.train_loader) == 2
    batch = next(iter(trainer.epoch_batches("train", 0, ("images", "y", "mask", "gt_polygons_image"))))
    assert all(v.device == CPU for v in batch.values()) and batch["images"].shape == (4, S, S, 3)

    monkeypatch.setattr(device_cache, "_device_memory_budget", lambda device: 1000)
    fallback = trainer_cls(pcfg, device="cpu")
    fallback.generator = torch.Generator().manual_seed(0)
    fallback.setup()
    assert fallback.cache is None and fallback.steps_per_epoch() == 2
    if case == "p2p_image":
        shuffled = copy.deepcopy(pcfg)
        shuffled.training.device_cache = "auto"
        shuffled.experiment.model.tokenizer.shuffle_tokens = True
        with pytest.raises(NotImplementedError, match="ROADMAP 'Port queue' item 'Device cache'"):
            device_cache.build_p2p_cache_arrays(shuffled, "train", Tokenizer(shuffled))
        auto = trainer_cls(shuffled, device="cpu")
        auto.generator = torch.Generator().manual_seed(0)
        auto.setup()
        assert auto.cache is None


def test_prebuild_then_train_from_the_cache(tiny_trunks, tmp_path, monkeypatch):
    """`cli/prebuild_caches.py` writes both splits' packs under the port's
    names; `cli/train.py` with `training.device_cache=true` then trains
    from them without packing anew; a pack whose row count is not the
    split's is rebuilt."""
    args = overrides(tmp_path, "ffl_image", ("experiment.model.num_epochs=1", "experiment.polygonization.acm_method.steps=20"))
    rows = prebuild_caches.main(["ffl_image", "train", "val", *args[1:]])
    assert rows == {"train": 6, "val": 3}
    cfg = compose(args)
    packs = sorted(f for f in os.listdir(cfg.experiment.dataset.in_path) if f.startswith("ffl_devcache_torch_"))
    assert packs == ["ffl_devcache_torch_train_i.npz", "ffl_devcache_torch_val_i.npz"]

    def no_packing(path, arrays):
        raise AssertionError(f"packed {path} anew")

    monkeypatch.setattr(device_cache, "_atomic_savez", no_packing)
    history = cli_train.main(args + ["training.device_cache=true", "device=cpu"])
    assert history["epoch"] == 0 and np.isfinite(history["loss"]) and 0.0 <= history["val_iou"] <= 1.0

    monkeypatch.undo()
    fewer = compose(args + ["experiment.dataset.train_subset=4"])
    assert device_cache.build_ffl_cache_arrays(fewer, "train")[0]["image_id"].shape == (4,)


def test_hisup_trains_from_the_cache_with_remat(tiny_trunks, tmp_path):
    """`cli/train.py` on HiSup-image with the cache and remat: one epoch, its
    val step and val IoU."""
    history = cli_train.main(overrides(tmp_path, "hisup_image", ("experiment.model.num_epochs=1",))
                             + ["training.device_cache=true", "training.remat=true", "device=cpu"])
    assert history["epoch"] == 0 and np.isfinite(history["loss"]) and np.isfinite(history["val_loss"])


# --- train steps from the cache --------------------------------------------------------


def _first_batches(roots, case, keys):
    jcache, pcache = _caches(roots, case, "train")
    jb, pb = next(iter(jcache.epoch_batches(0))), next(iter(pcache.epoch_batches(0)))
    return {k: jb[k] for k in keys if k in jb}, {k: pb[k] for k in keys if k in pb}


def test_ffl_train_step_from_the_cache_matches_jax(roots):
    """A tiny FFL-image (ViT-S/8 shape at 64 px, depth 1) from bridged
    weights: one train step on each package's cache batch."""
    jb, pb = _first_batches(roots, "ffl_image", FFL_BATCH_KEYS)
    assert set(pb) == {"images", "gt_polygons_image", "distances", "sizes", "gt_crossfield_angle", "class_freq"}
    jcfg, pcfg = _cfgs(roots, "ffl_image")
    jm = JaxFFL(encoder_cfg={"name": "vit_cnn", **VIT, "out_size": S}, dim=DIM, seg_channels=1, out_size=S)
    variables = _random_variables(jm, {"images": jb["images"]}, 3)
    tx = jax_state.make_optimizer("adam", jax_state.cosine_with_warmup(LR, 10))
    jstate = jax_state.create_train_state(jm, variables, tx)
    jloss, jweights = jax_losses.make_ffl_loss(jcfg)
    _, want = jax_ffl_step.make_train_step(jm, jloss)(jstate, jb, {k: jnp.float32(v) for k, v in jweights(0).items()})

    model = FFL(ViTCNNEncoder(out_size=S, out_dim=DIM, **VIT), dim=DIM, seg_channels=1, out_size=S)
    model.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    opt = make_optimizer("adam", model.parameters(), LR)
    ploss, pweights = make_ffl_loss(pcfg)
    got = ffl_step.make_train_step(ploss)(TrainState(model, opt, make_scheduler(opt, cosine_with_warmup(LR, 10), LR)),
                                          pb, pweights(0))
    assert set(got) == set(want) and len(want) >= 5
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def hisup_fusion(roots):
    """A tiny HiSup-fusion (FusionHRNet: HRNet width 4 ⊕ a one-block pillar
    ViT) with flax-init weights, each package's first cache batch, and JAX's
    remat step's loss function (`train/hisup_step.py`: the forward under
    `jax.checkpoint`), jitted once, giving the losses, the updated BatchNorm
    statistics and the gradient."""
    from pixelspointspolygons_tpu.models.hisup.model import encode_targets, hisup_losses
    from test_torch_train_pix2poly import flax_init

    jb, pb = _first_batches(roots, "hisup_fusion", HISUP_KEYS)
    jcfg, _ = _cfgs(roots, "hisup_fusion")
    weights = {k: float(v) for k, v in jcfg.experiment.model.loss_weights.items()}
    jm = JaxHiSup(encoder_cfg={"name": "fusion_hrnet", **HR}, dim=DIM, pred_size=S)
    variables = flax_init(jm, {k: jb[k] for k in ("images", "lidar", "lidar_mask")})

    def make_step(model):
        fwd = jax.checkpoint(lambda params, batch_stats, inputs: model.apply(
            {"params": params, "batch_stats": batch_stats}, inputs, train=True, mutable=["batch_stats"]))

        @jax.jit
        def step(params, batch_stats, batch):
            def loss_fn(p):
                outputs, mut = fwd(p, batch_stats, {k: batch[k] for k in ("images", "lidar", "lidar_mask")})
                losses = hisup_losses(outputs, encode_targets(batch, S))
                return sum(weights[k] * v for k, v in losses.items()), (losses, mut["batch_stats"])

            (total, (losses, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return {"loss": total, **losses}, stats, grads

        return step

    step = make_step(jm)

    def run(batch):
        metrics, stats, grads = jax.device_get(step(variables["params"], variables["batch_stats"],
                                                    {k: jnp.asarray(_np(v)) for k, v in batch.items()}))
        return metrics, flax_to_state_dict({}, stats), flax_to_state_dict(grads)

    def grads64(batch):
        """JAX's gradient of the same step with the model, its weights and
        the batch's floats in float64 (x64 on; both packages' loss terms
        stay float32)."""
        with jax.enable_x64(True):
            wide = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)  # noqa: E731
            b = {k: jnp.asarray(_np(v), jnp.float64 if np.issubdtype(_np(v).dtype, np.floating) else None)
                 for k, v in batch.items()}
            _, _, grads = jax.device_get(make_step(jm.clone(dtype=jnp.float64))(
                wide(variables["params"]), wide(variables["batch_stats"]), b))
        return flax_to_state_dict(grads)

    return {"jb": jb, "pb": pb, "variables": variables, "weights": weights, "run": run, "grads64": grads64}


def _port_hisup_state(variables, dtype: torch.dtype = torch.float32):
    model = HiSup(FusionHRNetEncoder(out_dim=DIM, **HR, dtype=dtype), dim=DIM, pred_size=S, dtype=dtype).to(dtype)
    model.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
    opt = make_optimizer("adamw", model.parameters(), LR, weight_decay=WD)
    return TrainState(model, opt, make_scheduler(opt, cosine_with_warmup(LR, 10), LR))


def _rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


def test_hisup_fusion_train_step_from_the_cache_matches_jax(hisup_fusion):
    """The port's remat step on the port's cache batch against JAX's on
    JAX's: the losses (the two batches' images differ at the jitter's
    rounding, their clouds in order)."""
    s = hisup_fusion
    want, _, _ = s["run"](s["jb"])
    got = hisup_step.make_train_step(s["weights"], S, remat=True)(_port_hisup_state(s["variables"]), s["pb"])
    assert set(got) == set(want) == {"loss", "loss_jloc", "loss_joff", "loss_mask", "loss_afm", "loss_remask"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_hisup_remat_step_matches_the_plain_step_and_jax(hisup_fusion):
    """One step with remat and one without, from the same weights on the
    port's cache batch: equal losses, gradients, updated weights and
    BatchNorm buffers (a recompute that updated the running statistics a
    second time would show here); the remat step against JAX's checkpointed
    step on the same batch: losses, gradient, BatchNorm statistics; the
    same two steps in float64, their gradients against each other, and each
    package's float32 gradient against its own float64 one (ROADMAP
    3.16)."""
    s = hisup_fusion
    assert set(s["pb"]) == set(HISUP_KEYS)
    want, want_stats, want_grads = s["run"](s["pb"])
    results = []
    for remat in (False, True):
        state = _port_hisup_state(s["variables"])
        before = {n: b.clone() for n, b in state.model.named_buffers()}
        metrics = hisup_step.make_train_step(s["weights"], S, remat=remat)(state, s["pb"])
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        results.append((metrics, grads, state.model.state_dict()))
    (m0, g0, w0), (m1, g1, w1) = results
    n_norms = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    assert n_norms >= 10 and len(before) == 2 * n_norms
    assert all(not torch.equal(before[k], w1[k]) for k in before)  # one update happened
    for k in m0:
        assert float(m0[k]) == float(m1[k]), k
        np.testing.assert_allclose(float(m1[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert set(g1) == set(want_grads) and _rel_l2(g1, want_grads) <= 2e-3
    # ROADMAP 3.16: the step itself held in float64, each package's float32 gradient against its own
    state64 = _port_hisup_state(s["variables"], torch.float64)
    hisup_step.make_train_step(s["weights"], S, remat=True)(
        state64, {k: v.double() if v.is_floating_point() else v for k, v in s["pb"].items()})
    port64 = {n: p.grad for n, p in state64.model.named_parameters()}
    jax64 = s["grads64"](s["pb"])
    assert set(port64) == set(jax64) == set(g1)
    assert _rel_l2(port64, jax64) <= GRAD64_TOL
    assert _rel_l2(g1, port64) <= GRAD32_TOL and _rel_l2(want_grads, jax64) <= GRAD32_TOL
    assert set(want_stats) == set(before)
    for k, v in want_stats.items():
        np.testing.assert_allclose(w1[k].numpy(), v.numpy(), rtol=5e-4, atol=1e-5, err_msg=k)


def test_remat_replays_a_draw_from_torch_generators():
    """An early-fusion HiSup whose LiDAR dropout is on draws from torch's
    global generator in its forward (HiSup passes no explicit generator):
    the recomputed forward replays the draw, so the remat step equals the
    plain one, and the generator advances once in each."""
    r = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(r.normal(size=(2, 32, 32, 3)).astype(np.float32)),
             "lidar": torch.from_numpy(r.uniform(1, 31, (2, 64, 3)).astype(np.float32)),
             "lidar_mask": torch.from_numpy(r.rand(2, 64) < 0.9)}
    batch.update(_tiny_targets(r))
    out = []
    for remat in (False, True):
        torch.manual_seed(0)
        enc = EarlyFusionViTCNNEncoder(out_size=32, out_dim=8, img_size=32, patch_size=8, dim=16, depth=1,
                                       num_heads=2, width=32.0, height=32.0, voxel_x=8.0, voxel_y=8.0,
                                       max_points_per_voxel=8, lidar_dropout=0.5)
        model = HiSup(enc, dim=8, pred_size=32)
        opt = make_optimizer("adamw", model.parameters(), LR)
        state = TrainState(model, opt, make_scheduler(opt, lambda n: LR, LR))
        torch.manual_seed(1)
        metrics = hisup_step.make_train_step({k: 1.0 for k in ("loss_jloc", "loss_joff", "loss_mask", "loss_afm",
                                                                "loss_remask")}, 32, remat=remat)(state, batch)
        out.append((float(metrics["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()},
                    torch.get_rng_state()))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])
    assert torch.equal(out[0][2], out[1][2])


def _tiny_targets(r, size=32, B=2, J=8):
    juncs = r.uniform(2, size - 2, (B, J, 2)).astype(np.float32)
    edges = np.concatenate([juncs, np.roll(juncs, 1, axis=1)], -1)
    return {"junctions": torch.from_numpy(juncs), "junc_tags": torch.from_numpy(r.randint(1, 3, (B, J)).astype(np.int32)),
            "junc_valid": torch.ones(B, J, dtype=torch.bool), "edges": torch.from_numpy(edges),
            "edges_valid": torch.ones(B, J, dtype=torch.bool),
            "mask": torch.from_numpy((r.rand(B, size, size) > 0.5).astype(np.float32))}


# --- ROADMAP 3.13 ------------------------------------------------------------------------


def test_trimmed_pad_changes_the_pillar_feature_net(tmp_path):
    """ROADMAP 3.13, a fault on the JAX side that the port keeps: the same
    val clouds at the host loader's pad (`max_num_points`) and at the
    cache's (the split's largest count rounded up to 1024) give JAX's
    train-mode PillarCanvas other outputs, since its BatchNorm counts the
    padding rows; the port equals JAX at each pad. (Its own dataset: a
    pack's name does not carry `max_num_points`.)"""
    # the host pad; the tiles hold 30,000-60,000 points
    pcfg = compose(overrides(tmp_path, "p2p_lidar", ("experiment.encoder.max_num_points=65536",)))
    host = next(iter(build_loader(pcfg, "val", tokenizer=Tokenizer(pcfg))))
    cache = next(iter(device_cache.P2PDeviceCache(pcfg, "val", Tokenizer(pcfg), CPU).epoch_batches(0)))
    cap = cache["lidar"].shape[1]
    assert cap % 1024 == 0 and cap < host["lidar"].shape[1] == 65536
    _assert_same_points(host["lidar"], host["lidar_mask"], cache["lidar"], cache["lidar_mask"])
    # same order too (the val split is not shuffled): only the pad differs
    np.testing.assert_array_equal(cache["lidar"].numpy(), host["lidar"][:, :cap])

    grid = dict(width=float(S), height=float(S), voxel_x=8.0, voxel_y=8.0, max_points_per_voxel=64)
    pts, valid = host["lidar"][:2], host["lidar_mask"][:2]
    jm = jpp.PillarCanvas(feat_channels=(8, 16), **grid)
    variables = _canvas_variables(jm, pts[:, :cap], valid[:, :cap], seed=4)
    outs = {}
    for n in (65536, cap):
        want = np.asarray(jax.jit(lambda v, p, m: jm.apply(v, p, m, train=True, mutable=["batch_stats"])[0])(
            variables, jnp.asarray(pts[:, :n]), jnp.asarray(valid[:, :n])))
        port = ppp.PillarCanvas(feat_channels=(8, 16), **grid)
        port.load_state_dict(flax_to_state_dict(variables["params"], variables["batch_stats"]))
        with torch.no_grad():
            got = port.train()(torch.from_numpy(pts[:, :n]), torch.from_numpy(valid[:, :n])).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        outs[n] = want
    assert np.abs(outs[65536] - outs[cap]).max() > 1e-3
