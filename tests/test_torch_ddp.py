"""Data-parallel training in the port on the CPU: two gloo processes, each
running the DDP train step on its half of a global batch, against one
process on the whole batch — the twin of
`tests/test_infra.py::test_hrnet_bn_sync_parity`, where JAX's step on a
mesh-sharded batch equals its one-device step.

One group of 2 processes serves the whole module (`runs`, started once:
`tests/torch_ddp_worker.py`, a `file://` store under `tmp_path`, so no
port is shared between test workers). Each process uses one thread. The
cases, at the dry run's 16 px with a global batch of 8:

- HiSup with the tiny HRNet (its BatchNorms) from weights bridged from
  flax, against JAX's one-device step on the concatenated batch (losses,
  every gradient, every BatchNorm buffer), and with remat under DDP;
- Pix2Poly with the early-fusion encoder (the ScoreNets' row BatchNorms,
  the PillarFeatureNet's `RowBatchNorm`, the token loss; the halves hold
  13 and 5 non-PAD targets a row), HiSup with `vit_cnn` and FFL, against
  the port's one-process step on the whole batch (which the other test
  files hold to JAX);
- negative controls: the HRNet step with the synchronisation switched off
  (per-process statistics) and the Pix2Poly step with each process's own
  token count must exceed the bounds;
- `BatchNorm` on NCHW maps and `RowBatchNorm` on rows alone, and a group
  of one process against no group.

Bounds. Each step runs in float32 and in float64 and is held against the
port's one-process step on the whole batch in float64 ("exact"), as
tests/test_torch_grad_conditioning.py holds gradients; the readings are
from this file's runs:
- losses: 1e-6 relative to exact, in float32 (sums over halves, then a
  mean of the halves: reads ≤ 5e-7) and in float64 (HiSup's
  cross-entropy terms are float32 at any dtype: reads ≤ 1.6e-7), and 1e-6
  to the one-process float32 step;
- BatchNorm buffers: in float32 1e-6 relative to the largest value of
  each, beyond 1e-7 absolute (reads ≤ 3e-7); in float64 1e-12 (≤ 1.1e-14);
- gradients in float64, relative L2 over all parameters: 1e-10 (reads
  ≤ 1.5e-13). Not in float32: there a ReLU input within a rounding of 0
  takes either side with the order of a sum, and one such element of the
  Pix2Poly ScoreNet moves the gradient by 1.3e-2 (the halves' sums and
  the one-process sums take different sides);
- against JAX (the HRNet case at 32 px, where its 16 px BatchNorms over
  1×1 maps cost JAX's float32 gradient 1 %): losses 2e-5 and buffers 2e-5
  relative beyond 2e-6, the bounds of `test_hrnet_bn_sync_parity`
  (flax's variance E[x²] − E[x]² cancels, ROADMAP 3.11: JAX's losses
  read 6.8e-6 from exact); the float32 gradient no farther from exact than
  JAX's own (reads 9.8e-5 against 2.4e-3) and within twice that of JAX's;
- the layers alone: outputs, input gradients and running statistics 1e-6
  absolute on unit scale inputs, weight and bias gradients 1e-5 relative;
- remat under DDP: equal to DDP without it (the recompute runs the same
  kernels on the same inputs);
- a group of one process: the bounds above, against no group;
- the negative controls: per-process statistics move the losses by
  2.3e-2 and the gradient by 1.1; the local token normalizer the losses by
  7.2e-3 and the float64 gradient by 0.14.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graft_entry_torch as entry
from pixelspointspolygons_tpu.models.hisup.model import HiSup as JaxHiSup
from pixelspointspolygons_tpu.models.hisup.model import encode_targets, hisup_losses
from pixelspointspolygons_torch.models.layers import BatchNorm, RowBatchNorm
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_train_pix2poly import flax_init
from torch_ddp_worker import layer_outputs, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B = entry.S, 8
HR_S = 32  # the HRNet cases' tile size
LOSS_TOL = 1e-6
STATS_TOL, STATS_ATOL = 1e-6, 1e-7
STATS64_TOL, GRAD64_TOL = 1e-12, 1e-10
JAX_TOL, JAX_ATOL = 2e-5, 2e-6
LAYER_TOL, LAYER_GRAD_TOL = 1e-6, 1e-5
HRNET = {"name": "hrnet", "in_size": HR_S, "width": 4, "stage1_planes": 4, "stage1_blocks": 1, "num_blocks": 1,
         "num_modules": (1, 1, 1), "stem_ch": 4}


def _pix2poly_batch() -> dict:
    """The dry run's Pix2Poly batch with 12 coordinate tokens in each row of
    the first half and 4 in the second (13 and 5 non-PAD targets): the
    halves' token counts differ, so a per-process normalizer would show."""
    batch = entry.dryrun_batches(B, seed=1)["pix2poly"]
    r = np.random.RandomState(2)
    y = np.full((B, 14), 34, np.int64)
    y[:, 0] = 32
    for b in range(B):
        n = 12 if b < B // 2 else 4
        y[b, 1:n + 1] = r.randint(0, 32, n)
        y[b, n + 1] = 33
    batch["y"] = y
    return batch


def _jax_hisup_step(variables: dict, batch: dict) -> dict:
    """JAX's one-device HiSup step on the whole batch: the losses, the
    gradient and the updated BatchNorm statistics (as the hisup_step's
    loss function computes them)."""
    jm = JaxHiSup(encoder_cfg=HRNET, dim=32, pred_size=HR_S)
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v) for k, v in batch.items()}

    def loss_fn(params):
        outputs, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                {"images": jb["images"]}, train=True, mutable=["batch_stats"])
        losses = hisup_losses(outputs, encode_targets(jb, HR_S))
        return sum(entry.HISUP_WEIGHTS[k] * v for k, v in losses.items()), (losses, mut["batch_stats"])

    (total, (losses, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return {"metrics": {"loss": float(total), **{k: float(v) for k, v in losses.items()}},
            "grads": flax_to_state_dict(jax.device_get(grads)),
            "buffers": flax_to_state_dict({}, jax.device_get(stats))}


def _layer_inputs() -> dict:
    r = np.random.RandomState(5)
    out = {}
    for name, shape in (("maps", (B, 6, 5, 5)), ("rows", (B * 40, 6))):
        out[f"{name}_x"] = torch.from_numpy((r.normal(size=shape) * 2.0 + 0.5).astype(np.float32))
        out[f"{name}_g"] = torch.from_numpy(r.normal(size=shape).astype(np.float32))
        out[f"{name}_state"] = {"weight": torch.from_numpy(r.uniform(0.5, 1.5, 6).astype(np.float32)),
                                "bias": torch.from_numpy(r.uniform(-1, 1, 6).astype(np.float32)),
                                "running_mean": torch.zeros(6), "running_var": torch.ones(6)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases, JAX's step, the port's one-process steps (no group) and
    the 2-process results."""
    work = tmp_path_factory.mktemp("ddp")
    batches = entry.dryrun_batches(B)
    hr_batch = entry.dryrun_batches(B, size=HR_S)["hisup"]
    variables = flax_init(JaxHiSup(encoder_cfg=HRNET, dim=32, pred_size=HR_S), {"images": hr_batch["images"][:1]})
    gen = torch.Generator().manual_seed(4)
    hrnet = {"family": "hisup", "encoder": "hrnet", "size": HR_S, "batch": hr_batch,
             "state_dict": flax_to_state_dict(variables["params"], variables["batch_stats"])}
    cases = {
        "hisup_hrnet": hrnet,
        "hisup_vit_cnn": {"family": "hisup", "encoder": "vit_cnn", "batch": batches["hisup"],
                          "state_dict": entry.tiny_hisup("vit_cnn", gen).state_dict()},
        "pix2poly": {"family": "pix2poly", "batch": _pix2poly_batch(),
                     "state_dict": entry.tiny_pix2poly(gen).state_dict()},
        "ffl": {"family": "ffl", "batch": batches["ffl"], "state_dict": entry.tiny_ffl(gen).state_dict()},
    }
    cases.update({f"{name}_float64": {**case, "dtype": torch.float64} for name, case in cases.items()})
    cases["hisup_hrnet_remat"] = {**hrnet, "remat": True}
    inputs = {"cases": cases, "sync_controls": ["hisup_hrnet"],
              "ws1_cases": ["hisup_hrnet", "hisup_hrnet_float64", "pix2poly", "pix2poly_float64"],
              "layers": _layer_inputs()}
    torch.save(inputs, work / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    worker = os.path.join(ROOT, "tests", "torch_ddp_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(work / "inputs.pt"), str(work), str(r)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = {name: train_step(case, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
                 for name, case in cases.items() if not case.get("remat")}
        exact = {name: plain[f"{name}_float64"] for name in cases if f"{name}_float64" in cases}
        plain["layers"] = layer_outputs(inputs["layers"])
        jax_step = _jax_hisup_step(variables, hr_batch)
    finally:
        torch.set_num_threads(threads)
        outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-3000:] for o in outs]
    return {"plain": plain, "exact": exact, "jax": jax_step, **torch.load(work / "results.pt", weights_only=False),
            "ws1": torch.load(work / "results_ws1.pt", weights_only=False)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _rel_l2(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    return (num / sum(float((want[k].double() ** 2).sum()) for k in want)) ** 0.5


def _stats_err(got: dict, want: dict, atol: float = STATS_ATOL) -> float:
    """The largest distance of a buffer from its reference, less the
    absolute floor, relative to the reference's largest value."""
    assert set(got) == set(want) and want
    return max(float(((got[k].double() - want[k].double()).abs() - atol).clamp(min=0).max() / want[k].abs().max())
               for k in want)


def _gaps(got: dict, want: dict, atol: float = STATS_ATOL) -> tuple[float, float, float]:
    """(losses, gradients, buffers) of a step's results against another's."""
    loss = max(_rel(got["metrics"][k], want["metrics"][k]) for k in want["metrics"])
    return loss, _rel_l2(got["grads"], want["grads"]), _stats_err(got["buffers"], want["buffers"], atol)


def _assert_step_matches(got: dict, got64: dict, runs: dict, case: str) -> None:
    """A float32 step `got` against the one-process step in float64
    (exact) and in float32: losses and buffers; the same step in float64
    `got64` against the exact one: losses, buffers and gradients."""
    loss, _, stats = _gaps(got, runs["exact"][case])
    assert loss <= LOSS_TOL and stats <= STATS_TOL, (loss, stats)
    assert _gaps(got, runs["plain"][case])[0] <= LOSS_TOL
    loss, grad, stats = _gaps(got64, runs["exact"][case], 0.0)
    assert loss <= LOSS_TOL and grad <= GRAD64_TOL and stats <= STATS64_TOL, (loss, grad, stats)


def _same_on_both_processes(res: list) -> None:
    """DDP's gradients, the global metrics and the running statistics are
    the same on both processes."""
    a, b = res
    assert a["metrics"] == b["metrics"]
    assert all(torch.equal(a["grads"][k], b["grads"][k]) for k in a["grads"])
    assert all(torch.equal(a["buffers"][k], b["buffers"][k]) for k in a["buffers"])


def test_hrnet_hisup_ddp_step_matches_jax(runs):
    """The twin of `test_hrnet_bn_sync_parity`: the tiny HRNet HiSup's DDP
    step on the two halves against JAX's one-device step on the whole
    batch, and against the port's one-process step."""
    res = runs["ws2"]["hisup_hrnet"]
    _same_on_both_processes(res)
    n_norms = sum(isinstance(m, BatchNorm) for m in entry.tiny_hisup("hrnet", torch.Generator()).modules())
    assert n_norms >= 20 and len(res[0]["buffers"]) == 2 * n_norms
    # every BatchNorm gathered its statistics in the forward (count, mean and
    # variance) and all-reduced its two sums in the backward
    assert res[0]["collectives"]["batch_norm"] == 2 * n_norms and res[0]["collectives"]["bucket"] >= 1
    loss, grad, stats = _gaps(res[0], runs["jax"], JAX_ATOL)
    jax_grad = _rel_l2(runs["jax"]["grads"], runs["exact"]["hisup_hrnet"]["grads"])
    assert loss <= JAX_TOL and grad <= 2 * jax_grad and stats <= JAX_TOL, (loss, grad, jax_grad, stats)
    assert _rel_l2(res[0]["grads"], runs["exact"]["hisup_hrnet"]["grads"]) <= jax_grad
    _assert_step_matches(res[0], runs["ws2"]["hisup_hrnet_float64"][0], runs, "hisup_hrnet")


@pytest.mark.parametrize("case", ["pix2poly", "hisup_vit_cnn", "ffl", "hisup_hrnet_remat"])
def test_ddp_step_matches_the_one_process_step(runs, case):
    """Each family's DDP step on the two halves against the port's
    one-process step on the whole batch; HiSup with remat under DDP also
    equal to the DDP step without it."""
    res = runs["ws2"][case]
    _same_on_both_processes(res)
    if case != "hisup_hrnet_remat":
        _same_on_both_processes(runs["ws2"][f"{case}_float64"])
        _assert_step_matches(res[0], runs["ws2"][f"{case}_float64"][0], runs, case)
    if case == "pix2poly":
        assert res[0]["collectives"]["count"] == 1  # the token count, all-reduced once
        norms = [k for k in res[0]["buffers"] if k.endswith("running_var")]
        assert any(".bn" in k and "score" in k for k in norms) and any("pillar" in k for k in norms), norms
    if case == "hisup_hrnet_remat":
        ref = runs["ws2"]["hisup_hrnet"][0]
        assert res[0]["metrics"] == ref["metrics"]
        assert all(torch.equal(res[0]["grads"][k], ref["grads"][k]) for k in ref["grads"])
        assert all(torch.equal(res[0]["buffers"][k], ref["buffers"][k]) for k in ref["buffers"])


def test_negative_controls_exceed_the_bounds(runs):
    """Per-process BatchNorm statistics, and each process's own token
    count, each give a step that the bounds above refuse."""
    loss, grad, stats = _gaps(runs["controls"]["hisup_hrnet_unsynchronised"], runs["jax"], JAX_ATOL)
    assert loss > 10 * JAX_TOL and grad > 0.1 and stats > 10 * JAX_TOL, (loss, grad, stats)
    loss, grad, _ = _gaps(runs["controls"]["pix2poly_local_normalizer"], runs["exact"]["pix2poly"], 0.0)
    assert loss > 10 * LOSS_TOL and grad > 1e4 * GRAD64_TOL, (loss, grad)


@pytest.mark.parametrize("name", ["maps", "rows"])
def test_synchronised_layers_match_the_whole_batch_layer(runs, name):
    """`BatchNorm` (NCHW) and `RowBatchNorm` ((N, C)) in train mode on the
    two halves against the layer on the whole batch: outputs, input
    gradients, weight and bias gradients, running statistics; and a group
    of one process against no group."""
    want = runs["plain"]["layers"][name]
    halves = [r[name] for r in runs["ws2"]["layers"]]
    for got in (torch.cat([h["y"] for h in halves]), runs["ws1"]["layers"][0][name]["y"]):
        assert float((got - want["y"]).abs().max()) <= LAYER_TOL
    for got in (torch.cat([h["x_grad"] for h in halves]), runs["ws1"]["layers"][0][name]["x_grad"]):
        assert float((got - want["x_grad"]).abs().max()) <= LAYER_TOL
    for got in halves + [runs["ws1"]["layers"][0][name]]:
        for k in ("weight_grad", "bias_grad"):
            assert float((got[k] - want[k]).abs().max() / want[k].abs().max()) <= LAYER_GRAD_TOL, k
        for k in ("running_mean", "running_var"):
            assert float((got[k] - want[k]).abs().max()) <= LAYER_TOL, k
    assert not torch.equal(want["running_var"], torch.ones(6))
    assert issubclass(RowBatchNorm, BatchNorm)


@pytest.mark.parametrize("case", ["hisup_hrnet", "pix2poly"])
def test_world_size_one_group_matches_no_group(runs, case):
    """At world size 1 the synchronised path runs (NCCL's on the card):
    the same step as without a group, within the bounds."""
    res = runs["ws1"][case][0]
    assert res["collectives"].get("batch_norm", 0) > 0 and res["collectives"]["bucket"] >= 1
    _assert_step_matches(res, runs["ws1"][f"{case}_float64"][0], runs, case)
