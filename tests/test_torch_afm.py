"""The PyTorch port's attraction-field map (pixelspointspolygons_torch/ops/afm.py)
against the JAX package's XLA `afm` and its Pallas kernel in interpret mode.

Tolerances:
- labels exact: at these shapes the port's arithmetic (with the three fused
  multiply-adds that XLA's CPU backend makes, see ops/afm.py) gives the same
  distances as the JAX package, so the first minimum is the same segment;
- map atol 3e-4 (as tests/test_ops.py::TestAFMPallas) where the offset to the
  nearest segment is at least 0.01 px. The encoding -sign(a)·log(|a|/size+1e-6)
  has slope size/(|a|+size·1e-6) and jumps by 13.8 between a = 0 and the
  smallest nonzero `a`: near a = 0 the last bit of `a` decides the map, and
  the JAX package's own two versions disagree there. There the test compares
  the decoded offset `a` itself, to atol 1e-4 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.ops.afm import afm as jax_afm
from pixelspointspolygons_tpu.ops.afm_pallas import afm_pallas
from pixelspointspolygons_torch.ops.afm import afm, afm_auto, afm_cuda


def _inputs(seed, B, L, H, W, p_valid=0.7):
    rng = np.random.RandomState(seed)
    lines = rng.uniform(0, max(H, W), (B, L, 4)).astype(np.float32)
    # some endpoints on the pixel grid, some degenerate (zero-length) segments
    lines[:, ::3] = np.round(lines[:, ::3])
    lines[:, 1::5, 2:] = lines[:, 1::5, :2]
    valid = rng.rand(B, L) < p_valid
    valid[-1] = False  # a sample with no valid segment
    return lines, valid


def _decode(enc, size):
    return np.sign(enc) * size * (np.exp(-np.abs(enc)) - 1e-6)


def _assert_map_close(got, want, H, W):
    sizes = np.array([W, H], np.float32)[None, :, None, None]
    a_want = _decode(want.astype(np.float64), sizes)
    a_got = _decode(got.astype(np.float64), sizes)
    np.testing.assert_allclose(a_got, a_want, atol=1e-4)
    well = np.abs(a_want) >= 0.01
    np.testing.assert_allclose(got[well], want[well], atol=3e-4)


@pytest.mark.parametrize("seed,B,L,H,W", [(0, 3, 9, 16, 16), (1, 2, 33, 24, 40), (2, 4, 64, 32, 32)])
def test_plain_matches_jax_and_pallas(seed, B, L, H, W):
    lines, valid = _inputs(seed, B, L, H, W)
    got_map, got_lab = afm(torch.from_numpy(lines), torch.from_numpy(valid), H, W)
    got_map, got_lab = got_map.numpy(), got_lab.numpy()
    for want_map, want_lab in (
        jax_afm(jnp.asarray(lines), jnp.asarray(valid), H, W, row_block=8),
        afm_pallas(jnp.asarray(lines), jnp.asarray(valid), H, W, interpret=True),
    ):
        np.testing.assert_array_equal(got_lab, np.asarray(want_lab))
        _assert_map_close(got_map, np.asarray(want_map), H, W)
    assert got_map.dtype == np.float32 and got_lab.dtype == np.int32
    assert np.abs(got_map[-1]).sum() == 0 and np.abs(got_lab[-1]).sum() == 0


def test_ragged_rows_and_row_block():
    """H not a multiple of the row block (the kernel masks the ragged edge;
    the plain version slices it) and H != W."""
    lines, valid = _inputs(3, 2, 12, 21, 13)
    want_map, want_lab = (np.asarray(x) for x in jax_afm(jnp.asarray(lines), jnp.asarray(valid), 21, 13, row_block=1))
    for rb in (4, 16, 64):
        got_map, got_lab = afm(torch.from_numpy(lines), torch.from_numpy(valid), 21, 13, row_block=rb)
        np.testing.assert_array_equal(got_lab.numpy(), want_lab)
        _assert_map_close(got_map.numpy(), want_map, 21, 13)


def test_no_valid_lines_zero():
    m, lab = afm(torch.zeros(1, 3, 4), torch.zeros(1, 3, dtype=torch.bool), 8, 8)
    assert m.abs().sum() == 0 and lab.abs().sum() == 0
    assert m.shape == (1, 2, 8, 8) and lab.shape == (1, 8, 8)


def test_auto_takes_plain_version_on_cpu_and_kernel_refuses_cpu():
    lines, valid = _inputs(4, 2, 5, 8, 8)
    before = afm_cuda.launches
    m1, l1 = afm_auto(torch.from_numpy(lines), torch.from_numpy(valid), 8, 8)
    m2, l2 = afm(torch.from_numpy(lines), torch.from_numpy(valid), 8, 8)
    assert torch.equal(m1, m2) and torch.equal(l1, l2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        afm_cuda(torch.from_numpy(lines), torch.from_numpy(valid), 8, 8)
    assert afm_cuda.launches == before


def test_kernel_library_name_tracks_source_and_flags():
    from pixelspointspolygons_torch.ops import build

    path = build.library_path("afm")
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
    assert path == build.library_path("afm")
    assert "--fmad=false" in build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
