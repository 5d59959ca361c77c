"""The prediction window: `Pix2PolyPredictor.predict_dataset` pass after
pass over the test split, each pass from the loader to its COCO file, the
last pass finished and counted whole.

Correctness (a served model, greedy): after the window, a sample of the
predicted tiles drawn from the seed. For each, the reference encodes the
tile's image and runs its decoder teacher-forced over the program's tokens:
the widest gap by which a served token's reference logit lies below the
reference's best at its position, up to the first EOS (a token the decode
did not choose greedily); the ScoreNets' scores against the reference's on
those features; and the tile's polygons in that pass's COCO file against
the reference's assembly of the program's tokens and scores."""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np
import torch

from benchmark.counts import flops
from benchmark.harness.compare import numerics, reference_model
from benchmark.harness.runner import Check
from benchmark.harness.trace import two_stretches
from benchmark.harness.weights import make_state, write_checkpoint
from benchmark.reference import assemble
from benchmark.reference.data import eval_images, load_image, load_points, read_split
from benchmark.traffic.generate import write_splits

# limits, set from the readings in PERF.md ("Correctness")
LIMITS = {"logit_gap": 1e-2, "score_err": 2e-4, "polygons_mismatched": 0.0}
POLYGON_TOL_PX = 1e-3
# the `decode_token` fault: every row takes the token after its best at
# this decode step, inside the loop, and the loop goes on from it
FAULT_STEP = 4
# the traced stretches: from the host's assembly of a pass's batch
# TRACE_FROM to that of batch TRACE_TO (the decode of the batch after each
# in flight)
TRACE_FROM, TRACE_TO = 2, 5
CHECKPOINT = "bench"
SPLIT = "test"
# EOS's logit bias in the seeded weights: far below every other logit, so
# that every seed decodes all generation steps (the draws of some seeds
# otherwise end every row early, and a pass takes half the work)
EOS_BIAS = -1e4


def setup(ctx) -> dict:
    from pixelspointspolygons_torch.config.engine import compose
    from pixelspointspolygons_torch.predict.predictor_pix2poly import Pix2PolyPredictor

    s, tr = ctx.sizes, ctx.traffic
    cfg = compose(ctx.overrides() + [f"checkpoint={CHECKPOINT}", f"evaluation.split={SPLIT}"])
    ds = cfg.experiment.dataset
    ctx.phase("imports")
    write_splits(ds.in_path, ds.annotations, tr["splits"], ctx.seed, s["height"], s["use_lidar"], tr["max_points"])
    ctx.phase("tiles")
    state_dict = make_state(s, ctx.seed, ctx.device)
    state_dict["decoder.output.bias"][s["num_bins"] + 1] = EOS_BIAS
    ckpt = write_checkpoint(state_dict, cfg.output_dir, CHECKPOINT)
    del state_dict
    ctx.phase("weights")
    pred = Pix2PolyPredictor(cfg, device=ctx.device)
    ctx.phase("predictor")
    state = {"cfg": cfg, "pred": pred, "ckpt": ckpt, "batches": [], "pass": -1, "hook": None,
             "out_dir": os.path.join(ctx.work, "predictions")}
    _wrap(ctx, state)
    # the warm-up: a pass over the split's first two batches, one in flight
    # behind the other, the window's shapes and path
    cfg.experiment.dataset[f"{SPLIT}_subset"] = 2 * int(cfg.experiment.model.batch_size)
    _pass(state, "warmup")
    cfg.experiment.dataset[f"{SPLIT}_subset"] = None
    state["batches"].clear()
    ctx.phase("warm-up pass")
    if torch.device(ctx.device).type == "cuda":
        state["setup_peak"] = torch.cuda.max_memory_allocated()
    return state


def _wrap(ctx, state: dict) -> None:
    """Observe each batch the host assembles (its tokens and raw scores), and
    plant the test's faults where the program produces its answers."""
    pred = state["pred"]
    assemble_batch, forward = pred.assemble, pred.forward

    def observed(tokens, scores):
        if ctx.fault == "token":
            tokens = tokens.copy()
            tokens[0, 4] = (tokens[0, 4] + 1) % ctx.sizes["num_bins"]
        state["batches"].append({"pass": state["pass"], "tokens": tokens, "scores": scores})
        if state["hook"]:
            state["hook"](len(state["batches"]))
        return assemble_batch(tokens, scores)

    def half_batch(inputs, events=None):
        half = {k: v[: v.shape[0] // 2] for k, v in inputs.items()}
        (tokens, scores), info = forward(half, events)
        return (torch.cat([tokens, tokens]), torch.cat([scores, scores])), info

    pred.assemble = observed
    if ctx.fault == "half_batch":
        pred.forward = half_batch
    if ctx.fault == "decode_token":
        dec = pred.model.decoder
        decode_step = dec.decode_step

        def flipped(tok, pos, *rest):
            logits, feats = decode_step(tok, pos, *rest)
            vocab = torch.arange(logits.shape[-1], device=logits.device)
            other = (vocab == (logits.argmax(-1, keepdim=True) + 1) % logits.shape[-1]) & (pos == FAULT_STEP)
            return logits + other.to(logits.dtype) * 1e4, feats

        dec.decode_step = flipped


def _pass(state: dict, tag) -> None:
    state["cfg"].evaluation.pred_file = os.path.join(state["out_dir"], f"pass_{tag}.json")
    state["pred"].predict_dataset(SPLIT)


def window(ctx, state: dict, seconds: float) -> dict:
    on_card = torch.device(ctx.device).type == "cuda"
    times, k = [], 0
    t0 = time.perf_counter()
    while True:
        state["pass"] = k
        _pass(state, k)
        times.extend(state["pred"].batch_times)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n_tiles = int(ctx.traffic["splits"][SPLIT])
    written = []
    for p in range(k):
        with open(os.path.join(state["out_dir"], f"pass_{p}_time.json")) as f:
            written.append(int(json.load(f)["num_images"]))
    state["passes"], state["written"] = k, written
    steps = [int(b["steps"]) for b in times]
    print(f"p3bench: {k} passes, {len(times)} batches, decode steps a batch {min(steps)}-{max(steps)}",
          file=sys.stderr)
    bs = len(state["batches"][0]["tokens"])
    per_pass = -(-n_tiles // bs)
    work = sum(min(bs, n_tiles - (j % per_pass) * bs) * flops.predict_tile(ctx.sizes, int(b["steps"]))
               for j, b in enumerate(times))
    return {
        "seconds": elapsed, "passes": k, "tiles": sum(written), "attempted": k * n_tiles,
        "failed": sum(max(n_tiles - w, 0) for w in written), "batch_times": times, "flops": work,
    }


def traced(ctx, state: dict) -> dict:
    """Two more passes, each traced over batch intervals TRACE_FROM ..
    TRACE_TO (`two_stretches`: the device alone, then with the host
    operations); beside it the CUDA events' device seconds of the batches
    whose decode the device-only stretch holds, which its busy seconds
    should about cover."""
    times = []

    def run(hook):
        before = len(state["batches"])
        state["hook"] = lambda n: hook(n - before)
        state["pass"] = "traced"
        _pass(state, "traced")
        state["hook"] = None
        times.append(state["pred"].batch_times)

    out = two_stretches(run, first=TRACE_FROM, last=TRACE_TO)
    out["units"] = TRACE_TO - TRACE_FROM
    if times[0][0]["device_ms"] is not None:
        out["events_busy_s"] = sum(b["device_ms"] for b in times[0][TRACE_FROM:TRACE_TO]) * 1e-3
    return out


def release(state: dict) -> None:
    state.pop("pred", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _sample(ctx, state: dict, count: int) -> list[tuple[int, int]]:
    """(batch record, row) of `count` tiles drawn from the seed among those
    the window predicted."""
    bs, n = len(state["batches"][0]["tokens"]), int(ctx.traffic["splits"][SPLIT])
    rows = [(i, r) for i, b in enumerate(state["batches"]) if isinstance(b["pass"], int) for r in range(bs)
            if _tile_index(state, i, r, bs) < n]
    rng = np.random.RandomState(ctx.seed % (2**32))
    pick = rng.choice(len(rows), size=min(count, len(rows)), replace=False)
    return [rows[i] for i in sorted(pick)]


def _coco_polygons(path: str) -> dict:
    with open(path) as f:
        anns = json.load(f)
    out: dict = {}
    for a in anns:
        out.setdefault(a["image_id"], []).append(np.asarray(a["segmentation"][0], np.float64).reshape(-1, 2))
    return out


def check(ctx, state: dict, control: bool = False) -> list[Check]:
    """The comparison; with `control` the reference at TF32 stands in for the
    program's tokens' judge (its own first choice at each position) and its
    scores for the program's."""
    s = ctx.sizes
    cfg = state["cfg"]
    infos, _ = read_split(cfg.experiment.dataset.annotations[SPLIT])
    root = cfg.experiment.dataset.in_path
    sample = _sample(ctx, state, int(ctx.traffic["check_tiles"]))
    bs = len(state["batches"][0]["tokens"])
    model = reference_model(s, state["ckpt"], ctx.device).eval()
    bos, eos = s["num_bins"], s["num_bins"] + 1
    gap = err = 0.0
    mismatched = 0
    coco_cache: dict = {}
    for start in range(0, len(sample), bs):
        idx = sample[start: start + bs]
        pos_in_pass = [_tile_index(state, i, r, bs) for i, r in idx]
        images = eval_images(np.stack([load_image(root, infos[t]) for t in pos_in_pass]))
        tokens = torch.from_numpy(np.stack([state["batches"][i]["tokens"][r] for i, r in idx])).to(ctx.device)
        scores_prog = torch.from_numpy(np.stack([state["batches"][i]["scores"][r] for i, r in idx])).to(ctx.device)
        batch = {"images": torch.from_numpy(images).to(ctx.device)}
        if s["use_lidar"]:
            batch.update(_eval_lidar([infos[t] for t in pos_in_pass], root, s, ctx.device))
        y_in = torch.cat([torch.full_like(tokens[:, :1], bos), tokens[:, :-1]], dim=1)
        T = tokens.shape[1]
        at = torch.arange(T, device=ctx.device)[None]
        is_eos = tokens == eos
        first = torch.where(is_eos.any(1), is_eos.float().argmax(1), T - 1)[:, None]
        live = at <= first
        with torch.no_grad():
            with numerics(tf32=False):
                logits, feats = model.decoder(model.encoder(batch), y_in, None)
                feats = feats * live[..., None]
                scores_ref = model.raw_scores(feats)
            judged, scores_judged = tokens, scores_prog
            if control:
                with numerics(tf32=True):
                    logits_c, feats_c = model.decoder(model.encoder(batch), y_in, None)
                    scores_judged = model.raw_scores(feats_c * live[..., None])
                judged = logits_c.argmax(-1)
            best = logits.max(-1).values
            chosen = logits.gather(-1, judged[..., None])[..., 0]
            gap = max(gap, float(torch.where(live, best - chosen, 0.0).max()))
            scale = scores_ref.abs().amax(dim=(1, 2)).clamp(min=1e-30)
            err = max(err, float(((scores_judged - scores_ref).abs().amax(dim=(1, 2)) / scale).max()))
        for (i, r), t in zip(idx, pos_in_pass):
            b = state["batches"][i]
            want = assemble.polygons(b["tokens"][r], b["scores"][r], s)
            path = os.path.join(state["out_dir"], f"pass_{b['pass']}.json")
            if path not in coco_cache:
                coco_cache[path] = _coco_polygons(path)
            got = coco_cache[path].get(int(infos[t]["id"]), [])
            if len(got) != len(want) or any(g.shape != w.shape or np.abs(g - w).max() > POLYGON_TOL_PX
                                            for g, w in zip(got, want)):
                mismatched += 1
    values = {"logit_gap": gap, "score_err": err, "polygons_mismatched": float(mismatched)}
    return [Check(k, v, LIMITS[k]) for k, v in values.items()]


def _eval_lidar(infos: list, root: str, s: dict, device) -> dict:
    """The eval loader's clouds: in file order, zero-padded to max_num_points."""
    pts = np.zeros((len(infos), s["max_num_points"], 3), np.float32)
    mask = np.zeros((len(infos), s["max_num_points"]), bool)
    for k, info in enumerate(infos):
        p = load_points(root, info, s["z_range"])[: s["max_num_points"]]
        pts[k, : len(p)], mask[k, : len(p)] = p, True
    return {"lidar": torch.from_numpy(pts).to(device), "lidar_mask": torch.from_numpy(mask).to(device)}


def _tile_index(state: dict, i: int, r: int, bs: int) -> int:
    """The split position of row r of batch record i: the eval loader takes
    the split in order, `bs` tiles a batch, and each pass records its
    batches in that order."""
    p = state["batches"][i]["pass"]
    first = next(j for j, b in enumerate(state["batches"]) if b["pass"] == p)
    return (i - first) * bs + r
