"""The port's FFL polygonizer against the JAX package's on the CPU: the
native contours, the packing, the ACM optimization, the `simple` and `acm`
methods end to end, and the host helpers (faces, corners, patched
inference), on the fixtures of tests/test_native.py and tests/test_ffl.py
and on one synthetic tile's ground truth.

Tolerances and why:
- contours, packing, faces, corners, patched inference: the same C++ or
  numpy code on the same inputs, so equal (exact);
- ACM positions after the full 500 steps: 1e-4 px. The port's gradient is
  torch autograd's, JAX's is `jax.grad` fused by XLA (which also contracts
  complex products into FMAs), so each step differs in the last bits; on
  these fixtures, whose crossfield is one frame everywhere, the difference
  stays at 2.1e-5 px (square) and 7.6e-6 px (border) after 500 steps.
  Where the crossfield varies, a vertex whose rounded edge midpoint crosses
  a pixel boundary a step earlier in one run takes another path, and the
  runs part by up to about a pixel (ROADMAP 3.9);
- the polygons of both methods at each tolerance: the same rings with the
  same vertex counts, coordinates within 1e-4 px (the ACM's);
- a synthetic tile's ground truth: see
  `test_polygonizer_on_a_synthetic_tile_matches_jax` and
  `test_acm_amplifies_last_bit_differences`.
"""

import json
import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu import native as jax_native
from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.predict import ffl_asm as jax_asm
from pixelspointspolygons_tpu.predict import ffl_inference as jax_inf
from pixelspointspolygons_tpu.predict import ffl_polygonize as jax_fp
from pixelspointspolygons_torch import native
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data.synthetic import generate_tile
from pixelspointspolygons_torch.ops.crossfield import uv_to_c0c2
from pixelspointspolygons_torch.predict import ffl_asm, ffl_inference
from pixelspointspolygons_torch.predict import ffl_polygonize as fp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import ffl_oracle_maps  # noqa: E402
from test_torch_ffl import one_torch_thread  # noqa: E402,F401 (an autouse fixture)

ACM_TOL = 1e-4  # px


def axis_aligned_crossfield(H, W):
    """tests/test_ffl.py::axis_aligned_crossfield (u along i, v along j)."""
    u = torch.full((H, W), 1.0 + 0j, dtype=torch.complex64)
    c0, c2 = uv_to_c0c2(u, 1j * u)
    return torch.stack([c0.real, c0.imag, c2.real, c2.imag]).numpy()


def _blurred(seg):
    return cv2.GaussianBlur(seg, (7, 7), 2.0)


def _map(name):
    """The (H, W) maps of tests/test_native.py and tests/test_ffl.py."""
    if name == "square_ring":
        img = np.zeros((32, 32), np.float32)
        img[10:20, 12:22] = 1.0
    elif name == "ramp":
        img = np.zeros((8, 24), np.float32)
        img[:, 11:] = 1.0
    elif name == "two_blobs":
        img = np.zeros((40, 40), np.float32)
        img[5:15, 5:15] = 1.0
        img[25:35, 25:35] = 1.0
    elif name == "open_border":
        img = np.zeros((10, 10), np.float32)
        img[:, :5] = 1.0
    elif name == "circle":
        yy, xx = np.mgrid[0:64, 0:64]
        img = ((yy - 32.0) ** 2 + (xx - 32.0) ** 2 < 15**2).astype(np.float32)
    elif name == "blurred_square":  # test_ffl.py::test_recovers_square
        img = np.zeros((64, 64), np.float32)
        img[16:48, 16:48] = 1.0
        img = _blurred(img)
    elif name == "border_building":  # test_ffl.py::test_acm_building_crossing_tile_edge
        img = np.zeros((64, 64), np.float32)
        img[20:44, 40:64] = 1.0
        img = _blurred(img)
        img[:, -1] = img[:, -2]
    elif name == "rect":  # test_ffl.py::test_simple_method
        img = np.zeros((64, 64), np.float32)
        img[10:30, 20:50] = 1.0
    elif name == "blobs":
        rng = np.random.RandomState(3)
        img = cv2.GaussianBlur((rng.rand(64, 64) > 0.7).astype(np.float32), (9, 9), 3.0)
        img = (img / img.max()).astype(np.float32)
    return img


MAPS = ["square_ring", "ramp", "two_blobs", "open_border", "circle", "blurred_square", "border_building", "rect",
        "blobs"]


# --- native contours --------------------------------------------------------


@pytest.mark.parametrize("name", MAPS)
@pytest.mark.parametrize("level", [0.5, 0.25])
def test_find_contours_matches_jax(name, level):
    img = _map(name)
    got, want = native.find_contours(img, level), jax_native.find_contours(img, level)
    assert len(got) == len(want) > 0
    for (g, gc), (w, wc) in zip(got, want):
        assert gc == wc
        np.testing.assert_array_equal(g, w)
    flagged = fp.extract_contours_flagged(img, level)
    for (g, gc), (w, wc) in zip(flagged, jax_fp.extract_contours_flagged(img, level)):
        assert gc == wc
        np.testing.assert_array_equal(g, w)


def test_douglas_peucker_native_matches_jax():
    pts = np.cumsum(np.random.RandomState(0).randn(200, 2), axis=0)
    np.testing.assert_array_equal(native.douglas_peucker_native(pts, 1.5), jax_native.douglas_peucker_native(pts, 1.5))
    np.testing.assert_array_equal(native.douglas_peucker_native(pts, 1.5), fp.douglas_peucker(pts, 1.5))


def test_native_library_is_built_under_build_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = native.library_path()
    assert path.startswith(os.path.join(ROOT, "build") + os.sep) and os.path.isfile(native.build())
    assert native.SOURCE == os.path.join(ROOT, "native", "geometry.cpp")

    broken = tmp_path / "geometry.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        native.build()
    assert not os.listdir(tmp_path / "build")

    # a library that cannot be loaded is not replaced by cv2's contours
    def unavailable():
        raise RuntimeError("no native library")

    monkeypatch.setattr(native, "load", unavailable)
    with pytest.raises(RuntimeError, match="no native library"):
        fp.extract_contours_flagged(_map("square_ring"))


def test_contour_overflow_falls_back_to_cv2_as_jax(monkeypatch):
    """Past the marching squares' buffers both packages trace with cv2."""
    def overflow(image, level):
        raise native.ContourOverflow("marching squares output overflow")

    def jax_overflow(image, level):
        raise RuntimeError("marching squares output overflow")

    img = _map("two_blobs")
    monkeypatch.setattr(fp, "find_contours", overflow)
    monkeypatch.setattr(jax_native, "find_contours", jax_overflow)
    got, want = fp.extract_contours_flagged(img), jax_fp.extract_contours_flagged(img)
    assert len(got) == len(want) == 2
    for (g, gc), (w, wc) in zip(got, want):
        assert gc and wc
        np.testing.assert_array_equal(g, w)


# --- packing ------------------------------------------------------------------


def _long_ring(n, seed):
    t = np.sort(np.random.RandomState(seed).uniform(0, 2 * np.pi, n))
    return np.stack([100 + 80 * np.sin(t), 100 + 80 * np.cos(t)], 1)


@pytest.mark.parametrize("case", ["maps", "over_capacity"])
def test_pack_contours_matches_jax(case):
    if case == "maps":
        contours = [jax_fp.extract_contours_flagged(_map(n)) for n in ("blobs", "border_building", "open_border")]
    else:  # decimated rings (> V_MAX), and rings dropped past MAX_TOTAL_VERTS
        contours = [[(_long_ring(5000 + 97 * k, k), True) for k in range(14)],
                    [(_long_ring(3000, 11), True), (_long_ring(40, 12)[:, ::-1].copy(), False)] * 6]
    got, want = fp.pack_contours(contours), jax_fp.pack_contours(contours)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[5] == want[5] and got[6] == want[6]
    if case == "over_capacity":
        assert got[6] > 0 and len(got[0]) == fp.MAX_TOTAL_VERTS


# --- ACM ----------------------------------------------------------------------


def _packed(name):
    seg = _map(name)[None, None]
    cf = axis_aligned_crossfield(*seg.shape[2:])[None]
    return seg, cf, fp.pack_contours([fp.extract_contours_flagged(seg[0, 0], 0.5)])


@pytest.mark.parametrize("name", ["blurred_square", "border_building"])
def test_acm_optimize_matches_jax(name):
    """The full 500 steps of config/polygonization/asm_acm.yaml."""
    seg, cf, (pos, vmask, next_idx, point_batch, pinned, rings, _) = _packed(name)
    mc = jax_compose(["experiment=ffl_image", "run_type=debug"]).experiment.polygonization.acm_method
    kw = dict(steps=int(mc.steps), poly_lr=float(mc.poly_lr), warmup_iters=int(mc.warmup_iters),
              warmup_factor=float(mc.warmup_factor), data_level=float(mc.data_level),
              data_coef=float(mc.data_coef), length_coef=float(mc.length_coef),
              crossfield_coef=float(mc.crossfield_coef))
    assert kw["steps"] == 500
    want = np.asarray(jax_fp.acm_optimize(*(jnp.asarray(a) for a in (pos, vmask, next_idx, point_batch)),
                                          jnp.asarray(seg[:, 0]), jnp.asarray(cf), jnp.asarray(pinned), **kw))
    t = [torch.from_numpy(a) for a in (pos, vmask, next_idx.astype(np.int64), point_batch.astype(np.int64))]
    got = fp.acm_optimize(*t, torch.from_numpy(seg[:, 0]), torch.from_numpy(cf), torch.from_numpy(pinned), **kw)
    got = got.numpy()
    assert got.dtype == np.float32
    moved = np.abs(want - pos).max(1)
    assert moved[vmask & ~pinned].max() > 0.5  # the optimization does move the contours
    np.testing.assert_array_equal(got[~vmask | pinned], pos[~vmask | pinned])  # padding and endpoints stay
    np.testing.assert_allclose(got[vmask], want[vmask], rtol=0, atol=ACM_TOL)


def test_warmup_rates_match_jax_schedule():
    """The per-step lr·coef in float32 as JAX's scan computes it."""
    it = jnp.arange(500)
    coef = jnp.where(it < 100, 1.0 + (jnp.float32(0.1) - 1.0) * (100 - it) / 100, 1.0)
    np.testing.assert_array_equal(fp.warmup_rates(500, 0.01, 100, 0.1), np.asarray(jnp.float32(0.01) * coef))


# --- the methods end to end ---------------------------------------------------


def _synthetic_tile_maps():
    _, _, polygons = generate_tile(np.random.RandomState(7), 224)
    assert len(polygons) >= 3
    return ffl_oracle_maps(polygons, 224)


@pytest.fixture(scope="module")
def polygonizers():
    args = ["experiment=ffl_image", "run_type=debug", "experiment.polygonization.method=[simple,acm]"]
    return (fp.Polygonizer(compose(args).experiment.polygonization),
            jax_fp.Polygonizer(jax_compose(args).experiment.polygonization))


def _assert_same_polygons(got, want, atol):
    assert set(got) == set(want) == {"simple", "acm"}
    n_polys = 0
    for method in want:
        assert set(got[method]) == set(want[method])
        for tol in want[method]:
            for g_sample, w_sample in zip(got[method][tol], want[method][tol]):
                assert [len(p) for p in g_sample] == [len(p) for p in w_sample], (method, tol)
                for g, w in zip(g_sample, w_sample):
                    np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{method} {tol}")
                n_polys += len(w_sample)
    return n_polys


@pytest.mark.parametrize("name", ["blurred_square", "border_building", "rect"])
def test_polygonizer_matches_jax(name, polygonizers):
    port, jax_poly = polygonizers
    seg = _map(name)[None, None]
    cf = axis_aligned_crossfield(*seg.shape[2:])[None]
    got, want = port(seg, cf), jax_poly(seg, cf)
    assert port.stats["rings"] > 0 and port.stats["acm_steps"] == 500 and port.stats["dropped"] == 0
    assert _assert_same_polygons(got, want, ACM_TOL) >= 4


@pytest.fixture(scope="module")
def synthetic_tile():
    """One synthetic tile's ground-truth maps (`chip_smoke.ffl_oracle_maps`),
    their packed contours, and JAX's and the port's ACM positions."""
    _, _, polygons = generate_tile(np.random.RandomState(7), 224)
    seg, cf = (m[None] for m in ffl_oracle_maps(polygons, 224))
    assert len(polygons) >= 3 and seg.shape == (1, 1, 224, 224) and cf.shape == (1, 4, 224, 224)
    packed = fp.pack_contours([fp.extract_contours_flagged(seg[0, 0], 0.5)])
    pos, vmask, next_idx, point_batch, pinned = packed[:5]
    want = np.asarray(jax_fp.acm_optimize(*(jnp.asarray(a) for a in (pos, vmask, next_idx, point_batch)),
                                          jnp.asarray(seg[:, 0]), jnp.asarray(cf), jnp.asarray(pinned)))
    return {"seg": seg, "cf": cf, "packed": packed, "want": want, "got": _port_acm(seg, cf, packed, pos)}


def _port_acm(seg, cf, packed, pos):
    t = [torch.from_numpy(a) for a in (pos, packed[1], packed[2].astype(np.int64), packed[3].astype(np.int64))]
    return fp.acm_optimize(*t, torch.from_numpy(seg[:, 0]), torch.from_numpy(cf), torch.from_numpy(packed[4])).numpy()


def test_polygonizer_on_a_synthetic_tile_matches_jax(polygonizers, synthetic_tile, monkeypatch):
    """The ACM amplifies last-bit differences (`test_acm_amplifies_last_bit_differences`).
    Here the two runs part by up to 0.023 px (median 7.6e-6 px, 2.7 % of
    the vertices beyond 1e-3 px). So the ACM positions are held to 0.05 px,
    their median to 1e-4 px and at most 5 % of them beyond 1e-3 px; and the
    polygons are held exactly to JAX's when the port's post-processing is
    given JAX's ACM positions."""
    port, jax_poly = polygonizers
    seg, cf, vmask = synthetic_tile["seg"], synthetic_tile["cf"], synthetic_tile["packed"][1]
    d = np.abs(synthetic_tile["got"] - synthetic_tile["want"])[vmask].max(1)
    assert len(synthetic_tile["packed"][5]) >= 3
    assert d.max() <= 0.05 and np.median(d) <= ACM_TOL and (d > 1e-3).mean() <= 0.05

    def jax_acm(pos, vmask, next_idx, point_batch, indicator, c0c2, pinned, **kw):
        args = (pos, vmask, next_idx.int(), point_batch.int(), indicator, c0c2, pinned)
        return torch.from_numpy(np.asarray(jax_fp.acm_optimize(*(jnp.asarray(a.numpy()) for a in args), **kw)))

    monkeypatch.setattr(fp, "acm_optimize", jax_acm)
    assert _assert_same_polygons(port(seg, cf), jax_poly(seg, cf), 0.0) >= 6


def test_acm_amplifies_last_bit_differences(synthetic_tile):
    """ROADMAP 3.9, measured: the crossfield term reads the pixel at each
    edge's rounded midpoint, and marching squares puts many midpoints
    exactly on pixel boundaries, so a vertex that crosses one a step
    earlier takes another path. Contours nudged by 4 ulps part from the
    port's own unnudged run after 500 steps by up to 1.32 px (46 % of the
    vertices beyond 1e-3 px), far more than the port parts from JAX's run
    on the same contours (0.023 px): the ACM is defined only to about a
    pixel under last-bit differences, which is why the card against the
    CPU is held by the median and the parted share."""
    packed, vmask, pinned = synthetic_tile["packed"], synthetic_tile["packed"][1], synthetic_tile["packed"][4]
    pos = packed[0]
    sign = np.sign(np.random.RandomState(0).uniform(-1, 1, pos.shape)).astype(np.float32)
    nudged = (pos + sign * 4 * np.spacing(pos) * (vmask & ~pinned)[:, None]).astype(np.float32)
    assert np.abs(nudged - pos).max() < 1e-4
    d = np.abs(_port_acm(synthetic_tile["seg"], synthetic_tile["cf"], packed, nudged) - synthetic_tile["got"])
    d = d[vmask].max(1)
    to_jax = np.abs(synthetic_tile["got"] - synthetic_tile["want"])[vmask].max(1)
    assert d.max() > 0.5 and (d > 1e-3).mean() > 0.2
    assert d.max() > 10 * to_jax.max() and (d > 1e-3).mean() > 5 * (to_jax > 1e-3).mean()


def test_polygonizer_runs_acm_on_the_maps_device(polygonizers):
    """With `maps` given, ACM reads those tensors (here float16 on the CPU,
    as the predictor hands over its rounded maps) and gives what the host
    arrays give."""
    port, _ = polygonizers
    seg = _map("blurred_square")[None, None].astype(np.float16).astype(np.float32)
    cf = axis_aligned_crossfield(64, 64)[None].astype(np.float16).astype(np.float32)
    want = port(seg, cf)
    got = port(seg, cf, maps=(torch.from_numpy(seg).half(), torch.from_numpy(cf).half()))
    for tol in want["acm"]:
        for g, w in zip(got["acm"][tol][0], want["acm"][tol][0]):
            np.testing.assert_array_equal(g, w)


# --- host helpers -------------------------------------------------------------


def test_faces_from_polylines_matches_jax():
    rng = np.random.RandomState(5)
    H = W = 41
    lines = [np.array([[0.0, 20.0], [40.0, 20.0]]), np.array([[10.0, 0.0], [10.0, 40.0]])]
    rings = [np.concatenate([r, r[:1]]) for r in (rng.uniform(5, 35, (6, 2)) for _ in range(3))]
    for polylines in (lines, rings, lines + rings):
        kept = polylines + [jax_fp.border_ring_with_nodes(H, W, np.zeros((0, 2)))]
        got, want = ffl_asm.faces_from_polylines(kept), jax_asm.faces_from_polylines(kept)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        got, want = fp.polygonize_with_border(polylines, H, W), jax_fp.polygonize_with_border(polylines, H, W)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_detect_corners_matches_jax():
    rng = np.random.RandomState(6)
    cf = cv2.GaussianBlur(rng.uniform(-1, 1, (40, 40, 4)).astype(np.float32), (9, 9), 3).transpose(2, 0, 1)
    u, v = fp.c0c2_to_uv_lazy(np.ascontiguousarray(cf))
    ju, jv = jax_fp.c0c2_to_uv_lazy(np.ascontiguousarray(cf))
    for closed in (True, False):
        for k in range(5):
            ring = rng.uniform(0, 39, (12, 2))
            got = fp.detect_corners(ring, u, v, closed=closed)
            want = jax_fp.detect_corners(ring, ju, jv, closed=closed)
            np.testing.assert_array_equal(got, want)


def test_patched_inference_matches_jax(tmp_path):
    """A deterministic forward of each patch (its mean colour and a ramp),
    blended with the distance-transform window."""
    def forward(patch):
        m = patch.mean(axis=(1, 2, 3))[:, None, None, None]
        ramp = np.linspace(0, 1, patch.shape[1], dtype=np.float32)[None, None, :, None]
        return {"seg": np.broadcast_to(m * ramp, (1, 1) + patch.shape[1:3]).copy(),
                "crossfield": np.broadcast_to(m + ramp, (1, 4) + patch.shape[1:3]).copy()}

    image = np.random.RandomState(8).uniform(0, 1, (1, 70, 90, 3)).astype(np.float32)
    assert ffl_inference.compute_patch_boundingboxes((70, 90), 24, 32) == \
        jax_inf.compute_patch_boundingboxes((70, 90), 24, 32)
    np.testing.assert_array_equal(ffl_inference.patch_weight_window(32), jax_inf.patch_weight_window(32))
    got = ffl_inference.inference_with_patching(forward, image, 32, 8)
    want = jax_inf.inference_with_patching(forward, image, 32, 8)
    for k in want:
        assert got[k].shape == (1, 1 if k == "seg" else 4, 70, 90)
        np.testing.assert_array_equal(got[k], want[k])

    polys = [np.array([[1.0, 2.0], [5.0, 2.0], [5.0, 7.25]])]
    ffl_inference.save_geojson(polys, str(tmp_path / "port.geojson"))
    jax_inf.save_geojson(polys, str(tmp_path / "jax.geojson"))
    with open(tmp_path / "port.geojson") as f, open(tmp_path / "jax.geojson") as g:
        assert json.load(f) == json.load(g)
