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
from pixelspointspolygons_torch.ops.afm import afm, afm_auto, afm_cuda, division_operands


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


AFM_SHAPES = [(0, 3, 9, 16, 16), (1, 2, 33, 24, 40), (2, 4, 64, 32, 32)]


@pytest.mark.parametrize(
    "seed,B,L,H,W",
    AFM_SHAPES + [(5, 2, 4096, 8, 8)],  # more segments than a chunk of the kernel stages at once
)
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


def _fma32(a, b, c):
    """a·b + c on float32 arrays with one rounding to float32, as a fused
    multiply-add rounds: the product is exact in float64, TwoSum keeps the
    float64 sum's error, and that error breaks a float32 tie that the
    float64 sum lands on."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bp = s - c64
    err = (c64 - (s - bp)) + (p - bp)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    nb = np.nextafter(r, np.where(d > 0, np.inf, -np.inf).astype(np.float32))
    tie = (d != 0) & (2 * d == nb.astype(np.float64) - r.astype(np.float64)) & (err != 0)
    return np.where(tie & (np.sign(err) == np.sign(d)), nb, r)


def _afm_like_pairs(n, seed):
    """n (numerator, denominator) pairs as the AFM forms them at 224 px:
    random pixels against random segments, some endpoints on the grid,
    some of zero length, some numerators -0."""
    rng = np.random.RandomState(seed)
    seg = rng.uniform(0, 224, (n, 4)).astype(np.float32)
    seg[::3] = np.round(seg[::3])
    seg[1::7, 2:] = seg[1::7, :2]
    pix = rng.randint(0, 224, (n, 2)).astype(np.float32)
    pix[::11] = seg[::11, :2]  # the pixel is the start point: num = ±0
    dx, dy = seg[:, 2] - seg[:, 0], seg[:, 3] - seg[:, 1]
    num = (pix[:, 0] - seg[:, 0]) * dx + (pix[:, 1] - seg[:, 1]) * dy
    den = _fma32(dx, dx, dy * dy) + np.float32(1e-6)
    return num, den


@pytest.mark.parametrize("operands", ["inputs0", "inputs1", "inputs2", "random"])
def test_reciprocal_quotient_is_ieee_division(operands):
    """The kernel's quotient, q0 = num·rcp with rcp = RN(1/den), then
    q = fma(fma(-q0, den, num), rcp, q0), equals float32 num / den bit for
    bit, over every operand that `afm` divides at the shapes above and over
    10^6 AFM-like pairs. The one difference is the sign of a zero quotient
    (num = -0 gives +0), which the clamp of t to [0, 1] removes."""
    if operands == "random":
        num, den = _afm_like_pairs(1_000_000, 7)
    else:
        seed, B, L, H, W = AFM_SHAPES[int(operands[-1])]
        lines, valid = _inputs(seed, B, L, H, W)
        num, den = (x.numpy() for x in division_operands(torch.from_numpy(lines), torch.from_numpy(valid), H, W))
    assert num.dtype == den.dtype == np.float32 and num.size > 1000
    rcp = np.float32(1) / den
    q0 = num * rcp
    got = _fma32(_fma32(-q0, den, num), rcp, q0)
    want = num / den
    same_bits = got.view(np.int32) == want.view(np.int32)
    signed_zero = ~same_bits & (got == 0) & (want == 0)
    assert np.array_equal(same_bits | signed_zero, np.ones_like(same_bits)), np.flatnonzero(~same_bits & ~signed_zero)[:5]
    assert np.array_equal(np.clip(got, 0, 1), np.clip(want, 0, 1))
    if operands == "random":
        assert signed_zero.any()  # the edge case is exercised


def test_fma32_rounds_once():
    """The emulation above against exact rational arithmetic. Half of the
    cases are built so that the float64 sum lands on a float32 tie while
    the exact sum lies just below it: c = 2^30 + 128·odd (an odd float32
    mantissa) plus a·b = 64 - k²·2^-40, where rounding twice gives c + 128
    and rounding once gives c."""
    from fractions import Fraction

    rng = np.random.RandomState(11)
    k = rng.randint(1, 300, 2000).astype(np.float64)
    a = (8 * (1 + k * 2.0**-23)).astype(np.float32)
    b = (8 * (1 - k * 2.0**-23)).astype(np.float32)
    c = (2.0**30 + 128 * (2 * rng.randint(0, 2**15, 2000) + 1)).astype(np.float32)
    a[1::2] = rng.uniform(1, 2, 1000).astype(np.float32)
    b[1::2] = rng.uniform(-2, 2, 1000).astype(np.float32)
    c[1::2] = rng.uniform(-4, 4, 1000).astype(np.float32)
    got = _fma32(a, b, c)
    twice = (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)
    assert np.all(got[::2] != twice[::2])
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        f = np.float32(float(exact))
        near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        want = min(near, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.array(v).view(np.int32)) & 1))
        assert g == want
