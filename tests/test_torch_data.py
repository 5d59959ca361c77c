"""The PyTorch port's own copies of the JAX package's host code (config
engine, synthetic tile generator, HiSup and Pix2Poly dataset items, the
Pix2Poly permutation targets, loader) against the originals, on the same
inputs. All comparisons are exact: the copies run the
same numpy, cv2 and PyYAML calls in the same order, so any difference is a
fault in the copy.
"""

import json
import os

import numpy as np
import pytest

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.data import Loader as JaxLoader
from pixelspointspolygons_tpu.data import P3Dataset as JaxDataset
from pixelspointspolygons_tpu.data import ensure_synthetic_dataset as jax_ensure
from pixelspointspolygons_tpu.data.dataset import build_perm_targets as jax_build_perm_targets
from pixelspointspolygons_tpu.models.pix2poly import Tokenizer as JaxTokenizer
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data import Loader, P3Dataset, build_loader, build_perm_targets, ensure_synthetic_dataset
from pixelspointspolygons_torch.models.pix2poly import Tokenizer


def _tiny(root, extra=()):
    return [
        "experiment=hisup_image",
        "dataset=synthetic",
        "run_type=debug",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.num_train=5",
        "experiment.dataset.num_val=2",
        "experiment.dataset.num_test=2",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        *extra,
    ]


@pytest.mark.parametrize(
    "overrides",
    [
        ["experiment=hisup_image", "dataset=synthetic"],
        [
            "experiment=hisup_image",
            "dataset=synthetic",
            "run_type=debug",
            "experiment.model.batch_size=4",
            "experiment.encoder.in_size=64",
            "+extra.key=[1, 2]",
            "~experiment.polygonization",
        ],
        ["experiment=p2p_fusion", "run_type=debug"],
        ["experiment=ffl_lidar", "evaluation=test", "training.device_cache=auto"],
    ],
)
def test_compose_matches_jax(overrides):
    got = compose(overrides).to_dict()
    want = jax_compose(overrides).to_dict()
    assert got == want


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same synthetic tile set written by each package into its own root."""
    root = tmp_path_factory.mktemp("torch_data")
    jcfg = jax_compose(_tiny(root / "jax"))
    pcfg = compose(_tiny(root / "port"))
    jax_ensure(jcfg)
    ensure_synthetic_dataset(pcfg)
    return jcfg, pcfg, root


def test_synthetic_tiles_identical(datasets):
    """Same bytes for the images and annotations, same arrays in the
    compressed LiDAR archives (whose zip headers carry a write time): the two
    packages may share one cached tile set."""
    jcfg, pcfg, _ = datasets
    jdir, pdir = jcfg.experiment.dataset.in_path, pcfg.experiment.dataset.in_path
    assert jdir != pdir
    files = sorted(os.path.relpath(os.path.join(d, f), jdir) for d, _, fs in os.walk(jdir) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), pdir) for d, _, fs in os.walk(pdir) for f in fs)
    assert sum(f.endswith(".png") for f in files) == 9
    for rel in files:
        a, b = os.path.join(jdir, rel), os.path.join(pdir, rel)
        if rel.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files), rel
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    with open(pcfg.experiment.dataset.annotations["train"]) as f:
        assert len(json.load(f)["images"]) == 5


def _assert_items_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize(
    "augs,split",
    [
        ("[D4,Normalize]", "train"),
        ("[D4,ColorJitter,GaussNoise,Normalize]", "train"),
        ("[D4,ColorJitter,GaussNoise,Normalize]", "val"),
    ],
)
def test_hisup_item_matches_jax(datasets, augs, split):
    """Junctions, tags, edges, masks and the augmented image, for every tile
    of the split and several seeds (so the D4 draws cover most of the group)."""
    root = datasets[2]
    ov = [f"experiment.encoder.augmentations={augs}"]
    jds = JaxDataset(jax_compose(_tiny(root / "jax", ov)), split)
    pds = P3Dataset(compose(_tiny(root / "port", ov)), split)
    assert len(pds) == len(jds) > 0
    for idx in range(len(jds)):
        for seed in range(3):
            want = jds.get_item(idx, np.random.RandomState(seed))
            got = pds.get_item(idx, np.random.RandomState(seed))
            _assert_items_equal(got, want)
            assert got["junc_valid"].sum() > 0
            assert got["edges_valid"].sum() == got["junc_valid"].sum()


def test_other_model_items_raise(datasets):
    """FFL training items, which once named ROADMAP item 'FFL', are built as
    JAX builds them from the same tiles (with no stats file, the default
    class frequencies; their parity at FFL's own config is in
    tests/test_torch_train_ffl.py); a model the dataset does not know
    raises."""
    jcfg, pcfg, _ = datasets
    pds, jds = P3Dataset(pcfg, "train"), JaxDataset(jcfg, "train")
    pds.model_type = jds.model_type = "ffl"
    for seed in range(2):
        _assert_items_equal(pds.get_item(0, np.random.RandomState(seed)), jds.get_item(0, np.random.RandomState(seed)))
    pds.model_type = "unknown"
    with pytest.raises(ValueError, match="unknown model"):
        pds.get_item(0, np.random.RandomState(0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_perm_targets_matches_jax(seed):
    """Random rings, including more corners than slots (the cut-off ring
    and the open-contour fix) and none at all."""
    rng = np.random.RandomState(seed)
    polys = [rng.uniform(0, 224, (rng.randint(3, 9), 2)) for _ in range(rng.randint(0, 6))]
    for nmax in (4, 16, 192):
        got, got_perm = build_perm_targets(polys, nmax)
        want, want_perm = jax_build_perm_targets(polys, nmax)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_perm, want_perm)
        assert got.shape == want.shape and got_perm.dtype == np.float32


@pytest.mark.parametrize(
    "augs,split,eval_mode",
    [
        ("[D4,Normalize]", "train", False),
        ("[D4,ColorJitter,GaussNoise,Normalize]", "train", False),
        ("[D4,ColorJitter,GaussNoise,Normalize]", "val", False),
        ("[D4,ColorJitter,GaussNoise,Normalize]", "train", True),
    ],
)
def test_pix2poly_item_matches_jax(datasets, augs, split, eval_mode):
    """Token sequences, ground-truth permutations and the augmented image,
    for every tile of the split and three seeds (D4 moves the corners)."""
    root = datasets[2]
    ov = ["experiment=p2p_image", "experiment.model.tokenizer.max_num_vertices=24",
          f"experiment.encoder.augmentations={augs}"]
    jcfg, pcfg = jax_compose(_tiny(root / "jax", ov)), compose(_tiny(root / "port", ov))
    jds = JaxDataset(jcfg, split, tokenizer=JaxTokenizer(jcfg), eval_mode=eval_mode)
    pds = P3Dataset(pcfg, split, tokenizer=Tokenizer(pcfg), eval_mode=eval_mode)
    assert len(pds) == len(jds) > 0
    for idx in range(len(jds)):
        for seed in range(3):
            want = jds.get_item(idx, np.random.RandomState(seed))
            got = pds.get_item(idx, np.random.RandomState(seed))
            _assert_items_equal(got, want)
            assert got["y"][0] == pds.tokenizer.BOS_code and got["y_perm"].shape == (24, 24)
    with pytest.raises(ValueError, match="tokenizer"):
        P3Dataset(pcfg, split).get_item(0, np.random.RandomState(0))


def test_pix2poly_loader_batches(datasets):
    """The eval loader of a Pix2Poly config takes the tokenizer and a batch
    size of its own, and pads the last batch."""
    root = datasets[2]
    pcfg = compose(_tiny(root / "port", ["experiment=p2p_image"]))
    loader = build_loader(pcfg, "train", tokenizer=Tokenizer(pcfg), eval_mode=True, batch_size=3)
    batches = list(loader)
    assert [len(b["y"]) for b in batches] == [3, 3] and batches[-1]["sample_valid"].tolist() == [True, True, False]
    assert batches[0]["y"].shape == (3, 386) and batches[0]["y_perm"].shape == (3, 192, 192)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_matches_jax(datasets, num_workers):
    """Epoch-seeded shuffle, per-item augmentation seeds and the padded last
    batch with its `sample_valid` mask."""
    jcfg, pcfg, _ = datasets
    jl = JaxLoader(JaxDataset(jcfg, "train"), 2, shuffle=True, seed=7, num_workers=num_workers,
                   process_index=0, process_count=1)
    pl = Loader(P3Dataset(pcfg, "train"), 2, shuffle=True, seed=7, num_workers=num_workers)
    assert (pl.process_index, pl.process_count) == (0, 1)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == len(pl) == 3
        for got, want in zip(pb, jb):
            _assert_items_equal(got, want)
        assert pb[-1]["sample_valid"].tolist() == [True, False]
