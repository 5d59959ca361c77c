"""The port's eval battery against the JAX package's (the same numpy code,
so equality is required): every evaluation mode through both `Evaluator`s
on the same GT and prediction files, the COCO protocol goldens of
tests/test_eval.py, RLE, the ldof shell-out, the CSV's columns, and the
gather of predictions across processes."""

import ast
import csv
import json
import os
import socket
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.eval.cocoeval import COCOEval as JaxCOCOEval
from pixelspointspolygons_tpu.eval.evaluator import Evaluator as JaxEvaluator
from pixelspointspolygons_tpu.eval.line_dof import compute_line_dof as jax_compute_line_dof
from pixelspointspolygons_tpu.utils import coco as jax_coco
from pixelspointspolygons_torch.config import compose
from pixelspointspolygons_torch.eval.cocoeval import COCOEval, mask_to_boundary
from pixelspointspolygons_torch.eval.evaluator import Evaluator
from pixelspointspolygons_torch.eval.line_dof import compute_line_dof
from pixelspointspolygons_torch.eval.metrics import calc_iou
from pixelspointspolygons_torch.parallel import all_gather_objects
from pixelspointspolygons_torch.utils import coco as port_coco
from pixelspointspolygons_torch.utils.coco import CocoIndex, generate_coco_ann

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_MODES = ["iou", "subset_iou", "coco", "boundary-coco", "polis", "mta", "juncs", "topdig", "stats"]
# RLE segmentations have no rings, which IoU's vertex count, the point
# metrics, MTA and junction AP read (in both packages)
RLE_MODES = ["coco", "boundary-coco", "topdig", "stats"]


def _building(rng, size):
    """A rotated rectangle or L-shape, (V, 2) xy inside the tile."""
    w, h = rng.uniform(8, 30, 2)
    pts = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    if rng.rand() < 0.4:
        pts = np.array([[0, 0], [w, 0], [w, h / 2], [w / 2, h / 2], [w / 2, h], [0, h]], np.float64)
    a = rng.uniform(0, np.pi)
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    pts = (pts - pts.mean(0)) @ R.T
    return np.clip(pts + rng.uniform(20, size - 20, 2), 0, size - 1)


def _dataset(kind: str, seed: int = 0, size: int = 96):
    """(GT COCO dict, prediction list). Predictions are the GT buildings
    moved by up to 2 px, some dropped, some spurious, with random scores;
    one tile has GT and no prediction, one predictions and no GT."""
    rng = np.random.RandomState(seed)
    images = [{"id": i, "width": size, "height": size, "file_name": f"{i}.png"} for i in range(1, 7)]
    anns, preds = [], []
    for img in images:
        i = img["id"]
        gts = [_building(rng, size) for _ in range(0 if i == 6 else rng.randint(1, 5))]
        for a in generate_coco_ann(gts, i):
            a.update(id=len(anns) + 1, iscrowd=0)
            if kind == "rle":
                a["segmentation"] = port_coco.rle_encode(port_coco.seg_to_mask(a["segmentation"], size, size), compressed=True)
            anns.append(a)
        if i == 5:
            continue
        dts = [g + rng.uniform(-2, 2, g.shape) for g in gts if rng.rand() < 0.8]
        dts += [_building(rng, size) for _ in range(rng.randint(0, 3))]
        preds += generate_coco_ann(dts, i, rng.uniform(0.1, 1.0, len(dts)))
    if kind == "crowd":
        region = np.array([[60.0, 60.0], [94.0, 60.0], [94.0, 94.0], [60.0, 94.0]])
        crowd = generate_coco_ann([region], 1)[0]
        crowd.update(id=len(anns) + 1, iscrowd=1)
        anns.append(crowd)
        preds += generate_coco_ann([region[:, :] * 0.9 + 7.0], 1, [0.99])
    if kind == "empty":
        preds = []
    gt = {"images": images, "annotations": anns, "categories": [{"id": 100, "name": "building"}]}
    return gt, preds


def _cfgs(tmp_path, modes):
    over = ["experiment=hisup_image", "dataset=synthetic", f"host.model_root={tmp_path}/out", "evaluation=test"]
    cfg, jcfg = compose(over), jax_compose(over)
    cfg.evaluation.modes = jcfg.evaluation.modes = list(modes)
    return cfg, jcfg


def _evaluate(evaluator, gt_file, pred_file):
    evaluator.load_gt(gt_file)
    evaluator.load_predictions(pred_file)
    return evaluator.evaluate()


@pytest.mark.parametrize(
    "kind,modes",
    [("buildings", ALL_MODES), ("crowd", ALL_MODES), ("empty", ALL_MODES), ("rle", RLE_MODES)],
)
def test_every_mode_matches_jax(kind, modes, tmp_path):
    gt, preds = _dataset(kind)
    gt_file, pred_file = tmp_path / "gt.json", tmp_path / "pred.json"
    gt_file.write_text(json.dumps(gt))
    pred_file.write_text(json.dumps(preds))
    (tmp_path / "pred_time.json").write_text(json.dumps({"prediction_time": 0.25, "num_images": 5}))
    cfg, jcfg = _cfgs(tmp_path, modes)
    got = _evaluate(Evaluator(cfg), str(gt_file), str(pred_file))
    want = _evaluate(JaxEvaluator(jcfg), str(gt_file), str(pred_file))
    # same keys in the same order, same numbers (NaN where JAX has NaN)
    assert json.dumps(got) == json.dumps(want)
    assert got["num_gt_anns"] == len(gt["annotations"]) and got["prediction_time"] == 0.25
    if kind == "buildings":
        assert 0.3 < got["IoU"] < 1.0 and 0.0 < got["AP"] < 1.0 and 0.0 < got["bAP"] < got["AP"]
        assert np.isfinite([got["polis"], got["mta"], got["junc_AP"]]).all()

    # the CSV: `experiment` first, then the metrics, as JAX's pandas writer has them
    files = [ev.to_csv(got, str(tmp_path / f"{name}.csv")) for name, ev in (("port", Evaluator(cfg)), ("jax", JaxEvaluator(jcfg)))]
    rows = []
    for path in files:
        with open(path, newline="") as f:
            rows.append(list(csv.reader(f)))
    assert rows[0][0] == rows[1][0] == ["experiment", *got]
    for a, b in zip(rows[0][1], rows[1][1]):
        if b not in ("", "nan"):  # pandas writes NaN as an empty field, csv as "nan"
            assert a == b or float(a) == float(b)


def _sq(x0, y0, s):
    return np.array([[x0, y0], [x0 + s, y0], [x0 + s, y0 + s], [x0, y0 + s]], np.float64)


SQ1, SQ2 = _sq(8.0, 8.0, 16.0), _sq(40.0, 40.0, 16.0)


def _gt(polys_per_img: dict, size: int = 64, crowd=()) -> dict:
    """tests/test_eval.py::make_gt, as a COCO dict; `crowd` lists (image,
    index) of crowd annotations."""
    anns = []
    for img_id, polys in polys_per_img.items():
        for k, a in enumerate(generate_coco_ann(polys, img_id)):
            a.update(id=len(anns) + 1, iscrowd=int((img_id, k) in crowd))
            anns.append(a)
    images = [{"id": i, "width": size, "height": size, "file_name": f"{i}.png"} for i in polys_per_img]
    return {"images": images, "annotations": anns, "categories": [{"id": 100, "name": "b"}]}


def _dts(polys, img_id, scores):
    return generate_coco_ann(polys, img_id, scores)


def _golden_cases():
    """(gt dict, predictions, expected stats) of tests/test_eval.py's COCO
    goldens, each derived there from the pycocotools rules."""
    sq = [0, 0, 10, 0, 10, 10, 0, 10]
    interp_gt = {
        "images": [{"id": 1, "height": 32, "width": 32}, {"id": 2, "height": 32, "width": 32}],
        "categories": [{"id": 100, "name": "building"}],
        "annotations": [
            {"id": i, "image_id": i, "category_id": 100, "segmentation": [sq], "area": 100.0,
             "bbox": [0, 0, 10, 10], "iscrowd": 0}
            for i in (1, 2)
        ],
    }
    interp_dt = [
        {"image_id": 1, "category_id": 100, "segmentation": [sq], "score": 0.9},
        {"image_id": 1, "category_id": 100, "segmentation": [[20, 20, 24, 20, 24, 24, 20, 24]], "score": 0.8},
        {"image_id": 2, "category_id": 100, "segmentation": [[0, 7, 10, 7, 10, 17, 0, 17]], "score": 0.5},
    ]
    big = np.array([[10.0, 40.0], [110.0, 40.0], [110.0, 140.0], [10.0, 140.0]])
    crowd_region = _sq(32.0, 32.0, 30.0)
    dt_in_crowd = _sq(32.0, 32.0, 15.0)
    spurious = np.array([[40.0, 40.0], [150.0, 40.0], [150.0, 150.0], [40.0, 150.0]])
    return {
        "interpolated_ap": (interp_gt, interp_dt, {"AP": 51 / 101, "AP50": 51 / 101, "AR100": 0.5}),
        "perfect": (_gt({1: [SQ1, SQ2], 2: [SQ1]}), _dts([SQ1, SQ2], 1, None) + _dts([SQ1], 2, None),
                    {"AP": 1.0, "AP50": 1.0, "AR100": 1.0}),
        "half_recall": (_gt({1: [SQ1, SQ2]}), _dts([SQ1], 1, None), {"AR100": 0.5}),
        "no_predictions": (_gt({1: [SQ1]}), [], {"AP": 0.0}),
        "score_order_tiebreak": (_gt({1: [SQ1]}), _dts([SQ1 + np.array([4.0, 0.0]), SQ1], 1, [0.9, 0.8]),
                                 {"AP50": 1.0, "AP75": 0.5, "AP": 0.65}),
        "maxdets_one": (_gt({1: [SQ1, SQ2]}), _dts([SQ1, SQ2], 1, [0.9, 0.8]), {"AR1": 0.5, "AR10": 1.0, "AP": 1.0}),
        "area_range_partitions": (_gt({1: [SQ1, big]}, size=160), _dts([SQ1, big], 1, [0.9, 0.8]),
                                  {"AP_small": 1.0, "AP_large": 1.0, "AP_medium": -1.0, "AP": 1.0}),
        "crowd_absorbs": (_gt({1: [SQ1, crowd_region]}, crowd={(1, 1)}), _dts([dt_in_crowd, SQ1], 1, [0.95, 0.9]),
                          {"AP": 1.0}),
        "crowd_off": (_gt({1: [SQ1, crowd_region]}), _dts([dt_in_crowd, SQ1], 1, [0.95, 0.9]),
                      {"AP": 51 / 101 * 0.5}),
        "unmatched_out_of_range": (_gt({1: [SQ1]}, size=160), _dts([spurious, SQ1], 1, [0.9, 0.8]),
                                   {"AP": 0.5, "AP_small": 1.0}),
    }


@pytest.mark.parametrize("case", list(_golden_cases()))
@pytest.mark.parametrize("iou_type", ["segm", "boundary"])
def test_coco_goldens_match_jax(case, iou_type):
    gt, dts, expected = _golden_cases()[case]
    port_gt, jax_gt = CocoIndex(json.loads(json.dumps(gt))), jax_coco.CocoIndex(json.loads(json.dumps(gt)))
    got = COCOEval(port_gt, port_gt.load_res(dts), iou_type=iou_type).run()
    want = JaxCOCOEval(jax_gt, jax_gt.load_res(dts), iou_type=iou_type).run()
    assert got == want
    if iou_type == "segm":
        for k, v in expected.items():
            assert got[k] == pytest.approx(v, abs=1e-9), k


def test_boundary_band_and_empty_iou():
    m = np.zeros((224, 224), np.uint8)
    m[50:110, 50:110] = 1
    b = mask_to_boundary(m)
    assert b[80, 50:60].tolist() == [1, 1, 1, 1, 1, 1, 0, 0, 0, 0]  # round(0.02·√(2·224²)) = 6 px
    assert b[80, 80] == 0 and m[80, 80] == 1
    assert calc_iou(np.zeros((4, 4), bool), np.zeros((4, 4), bool)) == 1.0


@pytest.mark.parametrize("shape,density", [((37, 23), 0.3), ((64, 64), 0.02), ((5, 7), 1.0), ((16, 9), 0.0)])
def test_rle_matches_jax(shape, density):
    rng = np.random.RandomState(3)
    mask = (rng.rand(*shape) < density).astype(np.uint8)
    for compressed in (False, True):
        rle = port_coco.rle_encode(mask, compressed=compressed)
        assert rle == jax_coco.rle_encode(mask, compressed=compressed)
        np.testing.assert_array_equal(port_coco.rle_decode(rle), mask)
        np.testing.assert_array_equal(port_coco.seg_to_mask(rle, *shape), mask)
    for counts in ([0, 1000, 3, 2, 900, 1], [5], [0, 2**20, 7, 2, 1, 2**18]):
        s = port_coco.rle_string_encode(counts)
        assert s == jax_coco.rle_string_encode(counts)
        assert port_coco.rle_string_decode(s) == port_coco.rle_string_decode(s.encode()) == counts


def test_ldof_shellout_matches_jax(tmp_path):
    """A stub executable that prints the reference binary's output format
    (line_dof.py:81-96), through compute_line_dof and the evaluator."""
    stub = tmp_path / "ldof"
    stub.write_text(
        "#!/bin/sh\n"
        'n=$(wc -l < "$2")\n'
        'echo "Number of degree of freedom is : $n"\n'
        'echo "Number segments is : $n"\n'
        'echo "Metric for DoF : 50.0"\n'
    )
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    gt, preds = _dataset("buildings", seed=1)
    port_gt, jax_gt = CocoIndex(gt), jax_coco.CocoIndex(gt)
    got = compute_line_dof(str(stub), port_gt, port_gt.load_res(preds))
    assert got == jax_compute_line_dof(str(stub), jax_gt, jax_gt.load_res(preds))
    assert got["norm_line_dofs"] == 0.5

    sq = [0, 0, 10, 0, 10, 10, 0, 10]
    one = CocoIndex({"images": [{"id": 1, "height": 16, "width": 16}], "annotations": [],
                     "categories": [{"id": 100, "name": "building"}]})
    res = compute_line_dof(str(stub), one, one.load_res([{"image_id": 1, "category_id": 100, "segmentation": [sq]}]))
    assert res["line_segs"] == 3.0  # 4-point open ring → 3 segments

    gt_file, pred_file = tmp_path / "gt.json", tmp_path / "pred.json"
    gt_file.write_text(json.dumps(gt))
    pred_file.write_text(json.dumps(preds))
    cfg, jcfg = _cfgs(tmp_path, ["ldof", "stats"])
    for exe in (str(stub), None):  # no executable: the mode is skipped with a warning
        cfg.host.ldof_exe = jcfg.host.ldof_exe = exe
        got = _evaluate(Evaluator(cfg), str(gt_file), str(pred_file))
        assert got == _evaluate(JaxEvaluator(jcfg), str(gt_file), str(pred_file))
        assert ("norm_line_dofs" in got) == (exe is not None)


def test_load_res_and_coco_helpers_match_jax():
    gt, preds = _dataset("buildings", seed=2)
    bare = [{k: v for k, v in p.items() if k not in ("area", "bbox")} for p in preds]
    port_gt, jax_gt = CocoIndex(gt), jax_coco.CocoIndex(gt)
    got, want = port_gt.load_res(bare), jax_gt.load_res(bare)
    assert got.dataset == want.dataset and got.imgToAnns == want.imgToAnns
    assert [a["area"] for a in got.anns.values()] == pytest.approx([p["area"] for p in preds])
    ann = gt["annotations"][0]
    np.testing.assert_array_equal(port_gt.ann_to_mask(ann), jax_gt.ann_to_mask(ann))
    assert port_gt.load_imgs(2) == jax_gt.load_imgs(2) and port_gt.load_imgs([1, 3]) == jax_gt.load_imgs([1, 3])


def test_to_latex_table_waits_for_its_roadmap_item(tmp_path):
    cfg, _ = _cfgs(tmp_path, ["iou"])
    with pytest.raises(NotImplementedError, match="ROADMAP 'Port queue' item 'Remaining encoders and CLI'"):
        Evaluator(cfg).to_latex_table(csv_file="results.csv")
    tex = Evaluator(cfg).to_latex({"IoU": 0.5, "num_images": 3})
    assert tex == JaxEvaluator(jax_compose(["experiment=hisup_image"])).to_latex({"IoU": 0.5, "num_images": 3})


_GATHER = textwrap.dedent(
    """
    import sys
    import torch.distributed as dist
    from pixelspointspolygons_torch.parallel import all_gather_objects, process_count, process_index
    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    try:
        got = all_gather_objects([{"image_id": rank, "score": 0.5 * rank}] * (rank + 1))
        assert (process_index(), process_count()) == (rank, 2)
        print(repr(got))
    finally:
        dist.destroy_process_group()
    """
)


def test_all_gather_objects():
    """One process: [obj]. Two gloo processes on this host: every rank gets
    both ranks' objects in rank order."""
    assert all_gather_objects({"a": [1, 2]}) == [{"a": [1, 2]}]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs = [
        subprocess.Popen([sys.executable, "-c", _GATHER, str(r), str(port)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    want = [[{"image_id": 0, "score": 0.0}], [{"image_id": 1, "score": 0.5}] * 2]
    assert [ast.literal_eval(o[0].strip().splitlines()[-1]) for o in outs] == [want, want]
