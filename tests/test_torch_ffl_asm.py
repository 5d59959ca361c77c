"""The port's ASM polygonization against the JAX package's on the CPU: the
skeleton, its graph, the edge map and the packing on the fixtures of
tests/test_ffl_asm.py; the step schedule; `asm_optimize`; `asm_polygonize`
and `Polygonizer` with `method=[acm,asm]` on those fixtures and on one
synthetic tile's ground truth (`chip_smoke.ffl_oracle_maps`).

Tolerances and why:
- the skeleton, the paths, the edge map, the packing and the schedule: the
  same numpy and cv2 calls in the same order (the schedule in float32 with
  the interpolation's multiply-add fused and gamma^step correctly rounded,
  as XLA computes them in JAX's scan), so equal (exact);
- `asm_optimize`: the port's gradient is torch autograd's, JAX's
  `jax.grad` fused by XLA, so each step differs in the last bits. Where the
  crossfield is one frame (the square) the 300 steps stay within 1e-4 px
  [1.1e-5]. Elsewhere the runs part as the ACM's do (ROADMAP 3.9), faster:
  see `test_asm_optimize_on_a_synthetic_tile`, which holds one step within
  1e-4 px and the 300 steps by their median parting;
- the polygons: given JAX's optimized positions, the port's
  post-processing gives JAX's polygons exactly; from the port's own
  positions on the square, the same polygons within 1e-4 px.
"""

import os
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.predict import ffl_asm as jax_asm
from pixelspointspolygons_tpu.predict import ffl_polygonize as jax_fp
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.data.synthetic import generate_tile
from pixelspointspolygons_torch.predict import ffl_asm
from pixelspointspolygons_torch.predict import ffl_polygonize as fp
from test_torch_ffl import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_ffl_polygonize import axis_aligned_crossfield

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import ffl_oracle_maps  # noqa: E402

POS_TOL = 1e-4  # px


def _mask(name: str) -> np.ndarray:
    """The masks of tests/test_ffl_asm.py."""
    if name == "thick_ring":
        mask = np.zeros((40, 40), np.uint8)
        cv2.rectangle(mask, (10, 10), (30, 30), 1, thickness=3)
    elif name == "thin_rect":
        mask = np.zeros((40, 40), np.uint8)
        cv2.rectangle(mask, (10, 10), (30, 30), 1, thickness=1)
    else:  # "t_junction"
        mask = np.zeros((21, 21), np.uint8)
        mask[10, 2:19] = 1
        mask[2:10, 10] = 1
    return mask


def _square():
    """tests/test_ffl_asm.py::test_recovers_square's maps: (1, 1, 64, 64)
    seg and the axis-aligned crossfield."""
    seg = np.zeros((64, 64), np.float32)
    seg[16:48, 16:48] = 1.0
    seg = cv2.GaussianBlur(seg, (5, 5), 1.0)
    return seg[None, None], axis_aligned_crossfield(64, 64)[None]


@pytest.fixture(scope="module")
def tile():
    _, _, polygons = generate_tile(np.random.RandomState(7), 224)
    seg, cf = ffl_oracle_maps(polygons, 224)
    return seg[None], cf[None]


def _cfgs(extra=()):
    args = ["experiment=ffl_image", "run_type=debug", *extra]
    return compose(args).experiment.polygonization, jax_compose(args).experiment.polygonization


# --- host stages --------------------------------------------------------------


@pytest.mark.parametrize("name", ["thick_ring", "thin_rect", "t_junction"])
def test_skeleton_and_paths_match_jax(name):
    mask = _mask(name)
    skel = ffl_asm.zhang_suen_skeletonize(mask)
    np.testing.assert_array_equal(skel, jax_asm.zhang_suen_skeletonize(mask))
    for m in (mask if name != "thick_ring" else skel,):
        nodes, paths = ffl_asm.skeleton_to_paths(m)
        jnodes, jpaths = jax_asm.skeleton_to_paths(m)
        np.testing.assert_array_equal(nodes, jnodes)
        assert paths == jpaths and len(paths) >= 1


@pytest.mark.parametrize("edge_channel", [False, True])
def test_edge_probability_map_matches_jax(edge_channel):
    seg, _ = _square()
    seg = seg[0]
    if edge_channel:
        seg = np.concatenate([seg, np.random.RandomState(2).uniform(0, 0.5, seg.shape).astype(np.float32)])
    got = ffl_asm.edge_probability_map(seg, edge_channel, 0.5)
    np.testing.assert_array_equal(got, jax_asm.edge_probability_map(seg, edge_channel, 0.5))
    assert got.max() == 1.0


@pytest.mark.parametrize("max_nodes", [ffl_asm.MAX_NODES, 1200])
def test_skeleton_graphs_and_packing_match_jax(tile, max_nodes, monkeypatch):
    """The graphs of the square and the synthetic tile side by side, packed
    into one batch; with the node cap lowered the second sample's paths are
    dropped on both sides."""
    monkeypatch.setattr(ffl_asm, "MAX_NODES", max_nodes)
    monkeypatch.setattr(jax_asm, "MAX_NODES", max_nodes)
    seg, cf = tile
    square, _ = _square()
    mc, _ = _cfgs()
    per_sample = ffl_asm.skeleton_graphs(mc.asm_method, square) + ffl_asm.skeleton_graphs(mc.asm_method, seg)
    got, want = ffl_asm.pack_skeletons(per_sample), jax_asm.pack_skeletons(per_sample)
    for g, w in zip(got[:7], want[:7]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[7] == want[7] and got[8] == want[8]
    assert (got[8] > 0) == (max_nodes < ffl_asm.MAX_NODES) and len(got[7]) >= 2


def test_step_schedule_matches_jax():
    """The coefficients and the rate of each step against JAX's scan body's."""
    import jax

    mc, _ = _cfgs()
    schedule, kw = ffl_asm.asm_kwargs(mc.asm_method)
    c = mc.asm_method.loss_params.coefs
    thr, data, length, cfc = (jnp.asarray([float(x) for x in v], jnp.float32)
                              for v in (c.step_thresholds, c.data, c.length, c.crossfield))

    @jax.jit
    def jax_schedule(lr, gamma):
        def body(carry, it):
            x = it.astype(jnp.float32)
            return carry, jnp.stack([jnp.interp(x, thr, data), jnp.interp(x, thr, length), jnp.interp(x, thr, cfc),
                                     lr * gamma ** x])

        return jax.lax.scan(body, 0, jnp.arange(int(c.step_thresholds[-1])))[1]

    want = np.asarray(jax_schedule(float(mc.asm_method.lr), float(mc.asm_method.gamma)))
    assert schedule.dtype == np.float32 and schedule.shape == (300, 4) and kw == {"data_level": 0.5}
    np.testing.assert_array_equal(schedule, want)


# --- the optimization -----------------------------------------------------------


def _packed(seg):
    mc, _ = _cfgs()
    return ffl_asm.pack_skeletons(ffl_asm.skeleton_graphs(mc.asm_method, seg))


def _jax_optimize(packed, seg, cf, mc, steps=None):
    c = mc.loss_params.coefs
    args = [jnp.asarray(a) for a in packed[:7]] + [jnp.asarray(seg[:, 0]), jnp.asarray(cf)]
    sched = [jnp.asarray([float(x) for x in v], jnp.float32) for v in (c.step_thresholds, c.data, c.length,
                                                                        c.crossfield)]
    return np.asarray(jax_asm.asm_optimize(*args, *sched, steps=steps or int(c.step_thresholds[-1]),
                                           lr=float(mc.lr), gamma=float(mc.gamma), data_level=float(mc.data_level)))


def _port_optimize(packed, seg, cf, mc, steps=None):
    schedule, kw = ffl_asm.asm_kwargs(mc, steps)
    t = [torch.from_numpy(a) for a in packed[:7]]
    for i in (1, 4, 5):
        t[i] = t[i].long()
    return ffl_asm.asm_optimize(*t, torch.from_numpy(seg[:, 0]), torch.from_numpy(cf), torch.from_numpy(schedule),
                                **kw).numpy()


def _parted(got, want, valid):
    return np.abs(got - want)[valid].max(1)


def test_asm_optimize_matches_jax_where_the_field_is_one_frame():
    """The square: all 300 steps within POS_TOL; tips and padding stay."""
    seg, cf = _square()
    packed = _packed(seg)
    mc, jmc = _cfgs()
    got, want = _port_optimize(packed, seg, cf, mc.asm_method), _jax_optimize(packed, seg, cf, jmc.asm_method)
    valid, pinned = packed[2], packed[3]
    assert _parted(want, packed[0], valid).max() > 0.3 and (got[valid & pinned] == packed[0][valid & pinned]).all()
    assert (got[~valid] == packed[0][~valid]).all()
    assert _parted(got, want, valid).max() <= POS_TOL


def test_asm_optimize_on_a_synthetic_tile(tile):
    """Where the crossfield changes frame at each building's outline, the
    runs part (ROADMAP 3.9): RMSprop divides each gradient by its own
    running size, so a node whose gradient is at the rounding noise steps
    by lr·sign(noise), and a midpoint that crosses a pixel boundary a step
    earlier in one run reads another frame. So: one step from the same
    positions agrees within POS_TOL [7.6e-6 px], as the square's 300 do;
    after the 300 steps the median parting stays under 1e-3 px [2.1e-4]
    and a tenth of what JAX's own run parts from itself when its start is
    nudged by 4 ulps [median 0.14 px, every node beyond 1e-3 px; the port
    and JAX part by up to 1.25 px, 46 % of the nodes beyond 1e-3 px]."""
    seg, cf = tile
    packed = _packed(seg)
    mc, jmc = _cfgs()
    valid, pinned = packed[2], packed[3]
    one = _parted(_port_optimize(packed, seg, cf, mc.asm_method, 1), _jax_optimize(packed, seg, cf, jmc.asm_method, 1),
                  valid)
    assert one.max() <= POS_TOL, one.max()
    want = _jax_optimize(packed, seg, cf, jmc.asm_method)
    d = _parted(_port_optimize(packed, seg, cf, mc.asm_method), want, valid)
    pos = packed[0]
    sign = np.sign(np.random.RandomState(0).uniform(-1, 1, pos.shape)).astype(np.float32)
    nudged = list(packed)
    nudged[0] = (pos + sign * 4 * np.spacing(pos) * (valid & ~pinned)[:, None]).astype(np.float32)
    self_parted = _parted(_jax_optimize(nudged, seg, cf, jmc.asm_method), want, valid)
    assert _parted(want, pos, valid).max() > 0.3
    assert np.median(d) <= 1e-3 and np.median(d) <= 0.1 * np.median(self_parted), (np.median(d), np.median(self_parted))
    assert (self_parted > 1e-3).mean() > 0.9


# --- the method -------------------------------------------------------------------


def _jax_positions(monkeypatch):
    """Make the port's ASM (and ACM) optimize with JAX's functions."""
    _, jmc = _cfgs()

    def asm(pos, node_batch, node_valid, pinned, edge_a, edge_b, edge_valid, indicator, c0c2, schedule, **kw):
        packed = [a.numpy() for a in (pos, node_batch.int(), node_valid, pinned, edge_a.int(), edge_b.int(),
                                      edge_valid)]
        return torch.from_numpy(_jax_optimize(packed, indicator[:, None].numpy(), c0c2.numpy(), jmc.asm_method))

    def acm(pos, vmask, next_idx, point_batch, indicator, c0c2, pinned, **kw):
        args = (pos, vmask, next_idx.int(), point_batch.int(), indicator, c0c2, pinned)
        return torch.from_numpy(np.asarray(jax_fp.acm_optimize(*(jnp.asarray(a.numpy()) for a in args), **kw)))

    monkeypatch.setattr(ffl_asm, "asm_optimize", asm)
    monkeypatch.setattr(fp, "acm_optimize", acm)


def _assert_same(got: dict, want: dict, atol: float) -> int:
    assert set(got) == set(want)
    n = 0
    for tol in want:
        for g_sample, w_sample in zip(got[tol], want[tol]):
            assert [len(p) for p in g_sample] == [len(p) for p in w_sample], tol
            for g, w in zip(g_sample, w_sample):
                np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=tol)
            n += len(w_sample)
    return n


def test_asm_polygonize_recovers_the_square_as_jax():
    """tests/test_ffl_asm.py::test_recovers_square on both sides, from each
    side's own optimization; the stats of the run."""
    seg, cf = _square()
    mc, jmc = _cfgs()
    stats = {}
    got = ffl_asm.asm_polygonize(mc, seg, cf, stats=stats)
    want = jax_asm.asm_polygonize(jmc, seg, cf)
    assert _assert_same(got, want, POS_TOL) == 1
    p = got["tol_1"][0][0]
    assert 3 <= len(p) <= 12 and 12 < p[:, 0].min() < 20 and 44 < p[:, 0].max() < 52
    assert stats["steps"] == 300 and stats["paths"] >= 1 and stats["bucket"] == 4096 and stats["dropped"] == 0
    assert stats["optimize_ms"] > 0 and stats["skeleton_ms"] > 0 and stats["post_ms"] > 0


def test_polygonizer_acm_and_asm_on_a_synthetic_tile_match_jax(tile, monkeypatch):
    """`method=[acm,asm]` through both packages' `Polygonizer`, given JAX's
    optimized positions: both methods' polygons exactly JAX's; ASM on the
    maps' device (float16 tensors, as the predictor hands them over) gives
    what the host arrays give."""
    seg, cf = (m.astype(np.float16).astype(np.float32) for m in tile)
    mc, jmc = _cfgs(["experiment.polygonization.method=[acm,asm]"])
    port, jax_poly = fp.Polygonizer(mc), jax_fp.Polygonizer(jmc)
    own = port(seg, cf)
    on_maps = port(seg, cf, maps=(torch.from_numpy(seg).half(), torch.from_numpy(cf).half()))
    assert _assert_same(on_maps["asm"], own["asm"], 0.0) >= 3
    assert port.stats["asm"]["nodes"] > 0 and port.stats["rings"] > 0
    _jax_positions(monkeypatch)
    got, want = port(seg, cf), jax_poly(seg, cf)
    assert set(got) == set(want) == {"acm", "asm"}
    assert _assert_same(got["asm"], want["asm"], 0.0) >= 3
    assert _assert_same(got["acm"], want["acm"], 0.0) >= 3
