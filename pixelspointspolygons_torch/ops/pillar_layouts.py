"""Layouts of sorted LiDAR points on which the voxelizer's pillar sums
(`ops/voxelize.py::pillar_sums` and its kernel `csrc/pillar_sums.cu`) take
their edge cases: runs longer than a staged chunk and than a tile, runs of
exactly a cap or a chunk and one more or less, empty pillars at either end
of the grid and between full ones, a sample that is all padding, a cap
above the number of points, and a grid whose pillars do not fill the
kernel's pass of 64.

Each layout is given in the form `sort_by_pillar` returns: points (B, N, 3)
and int64 pillar ids (B, N) sorted within each sample, every pillar a run,
the padding's id n_cells last. The points span nine orders of magnitude
with either sign, so a sum taken in any other order than the run's gives
other bits; the padding holds such points too, so a sum that reads past a
run or past its cap gives other values. `dense_layout` is the dense
PointPillars encoder's grid (`config/encoder/pointpillars.yaml`): 512 px
tiles in 2 px pillars, 65,536 cells at cap 4, where every other layout
has at most 784. numpy only: the CPU tests
(tests/test_torch_pillar_sums.py against JAX's scatter-add), the card tests
(tests/test_torch_kernels.py) and chip_smoke.py phase 3 share them; the
port's own path never calls them.
"""

import numpy as np

# csrc/pillar_sums.cu stages 2,944 bytes a chunk: 245 points of 3 float32
# coordinates (122 of float64)
CHUNK_POINTS = 245
# a block owns a tile of 2,048 rows and reads the next 256 too; the end of a
# run past both is searched
TILE_ROWS, AHEAD_ROWS = 2048, 256
CAPS = (4, 64, 512)
# the dense encoder: 256 x 256 pillars at cap 4; data/synthetic.py draws
# 30,000 to 60,000 points a tile at any size, padded to 200,000 rows
DENSE_CELLS, DENSE_CAP = 256 * 256, 4
SYNTHETIC_POINTS = (30_000, 60_000)
# run lengths around every cap and one and two float32 chunks
EDGE_RUNS = (3, 4, 5, 63, 64, 65, 244, 245, 246, 489, 490, 491, 511, 512, 513)


def sorted_layout(runs: np.ndarray, n_points: int, seed: int, dtype=np.float32):
    """(points (B, N, 3) of `dtype`, ids (B, N) int64, n_cells) for run
    lengths runs (B, n_cells): pillar p of sample b holds runs[b, p] points,
    the other rows of the N = n_points are padding."""
    runs = np.asarray(runs, np.int64)
    B, n_cells = runs.shape
    pid = np.full((B, n_points), n_cells, np.int64)
    for b in range(B):
        ids = np.repeat(np.arange(n_cells), runs[b])
        assert len(ids) <= n_points, "the runs do not fit"
        pid[b, :len(ids)] = ids
    r = np.random.RandomState(seed)
    pts = r.standard_normal((B, n_points, 3)) * 10.0 ** r.uniform(-3, 6, (B, n_points, 3))
    return pts.astype(dtype), pid, n_cells


def small_layouts(dtype=np.float32) -> dict:
    """name -> (points, ids, n_cells), each a few thousand points at most."""
    r = np.random.RandomState(0)
    out = {}

    runs = r.randint(0, 21, (2, 16))
    runs[0, 5] = 2500  # longer than cap 512, two chunks, and a tile and its look-ahead
    runs[1, 0], runs[1, 15] = 650, 610  # the first and the last pillar
    out["long_run"] = sorted_layout(runs, 3000, 1, dtype)

    runs = np.zeros((1, 24), np.int64)
    runs[0, 1:1 + len(EDGE_RUNS)] = EDGE_RUNS
    out["run_lengths"] = sorted_layout(runs, int(runs.sum()) + 37, 2, dtype)

    runs = np.zeros((2, 63), np.int64)  # 64 cells with the dump cell: one whole pass of 64
    runs[0, 3:62:2] = r.randint(1, 90, 30)  # pillars 0-2 and 62 empty, every other one between
    runs[1, 40] = 70  # one full pillar in the second block
    out["empty_pillars"] = sorted_layout(runs, 1500, 3, dtype)

    runs = r.randint(0, 40, (3, 16))
    runs[1] = 0  # a sample of padding only
    out["all_padding"] = sorted_layout(runs, 700, 4, dtype)

    runs = np.zeros((2, 16), np.int64)
    runs[0, 2], runs[0, 9], runs[1, 15] = 30, 5, 40  # N = 40, under caps 64 and 512
    out["cap_above_n"] = sorted_layout(runs, 40, 5, dtype)

    runs = r.randint(0, 90, (3, 35))  # a 5 x 7 grid: 36 cells, not a multiple of 64
    runs[2, 34] = 200
    out["grid_5x7"] = sorted_layout(runs, 3300, 6, dtype)
    return out


def large_layout(dtype=np.float32, B: int = 16, n_points: int = 200_000, n_cells: int = 784):
    """All the small layouts' cases in one batch at the main path's size:
    sample 0 padding only; 1 the edge run lengths over the whole grid; 2
    one run of 100,000 points; 3 its first and last 100 pillars empty;
    the others runs of 57 points on average (as the synthetic clouds)."""
    r = np.random.RandomState(7)
    runs = r.poisson(57, (B, n_cells))
    runs[0] = 0
    runs[1] = np.resize((0,) + EDGE_RUNS, n_cells)
    runs[2] = 0
    runs[2, 400] = 100_000
    runs[3, :100] = 0
    runs[3, -100:] = 0
    return sorted_layout(runs, n_points, 8, dtype)


def dense_layout(dtype=np.float32, B: int = 16, n_points: int = 200_000, n_cells: int = DENSE_CELLS):
    """The dense encoder's layout at the main path's size: each sample's
    points, as many as data/synthetic.py draws for a tile (30,000 to
    60,000, scaled by n_points / 200,000), fall uniformly on the n_cells
    pillars, about 0.7 a pillar at full size: most runs hold 0, 1 or 2
    points, a few reach the cap of 4 or pass it, and about three quarters
    of the rows are padding, as on the synthetic train split."""
    r = np.random.RandomState(9)
    lo, hi = (k * n_points // 200_000 for k in SYNTHETIC_POINTS)
    runs = np.stack([np.bincount(r.randint(0, n_cells, r.randint(lo, hi + 1)), minlength=n_cells) for _ in range(B)])
    return sorted_layout(runs, n_points, 10, dtype)
