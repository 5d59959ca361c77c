"""The HiSup training slice as a whole: the port's `make_train_step` and
`make_val_step` against the JAX package's, from the same bridged weights, on
batches that the JAX package's `P3Dataset` built from a synthetic tile set
(tiny HRNet, 64 px, head width 16, batch 2, CPU, float32).

Step 1 runs from identical weights. Step 2 runs from the JAX state after
step 1 copied into the port (parameters, BatchNorm statistics, Adam moments),
so each step is compared on identical inputs. A third comparison lets both
sides run two steps on their own and bounds how far they drift.

Tolerances and why:
- losses: 1e-5 relative (float32 sums in another order);
- learning rate: 1e-6 relative (optax evaluates the schedule in float32);
- gradients: both float32 gradients are compared with the port's float64
  gradient, which is exact to ~1e-10 here. The JAX package's float32
  gradient is off by up to ~2.5e-2 (relative L2 over all parameters; the
  remask and jloc heads' train-mode BatchNorm on a 2-sample batch amplify
  rounding), the port's by ~3e-3, so the bounds are 5e-2 and 1e-2;
- parameters after an update: AdamW's first steps move each element by
  about lr·sign(g). Where |g| is at the rounding noise of the gradient (the
  bias of a conv that feeds a BatchNorm has an exact gradient of 0), the two
  sides can move it in opposite directions: 2·lr apart. Every element must
  be within 2·lr (+1e-7), and all but 2% within 1e-6;
- BatchNorm statistics: 5e-4 relative (+1e-5) after an identical step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.config import compose as jax_compose
from pixelspointspolygons_tpu.data.loader import build_loader as jax_build_loader
from pixelspointspolygons_tpu.models.hisup.model import HiSup as JaxHiSup
from pixelspointspolygons_tpu.models.hisup.model import encode_targets as jax_encode_targets
from pixelspointspolygons_tpu.models.hisup.model import hisup_losses as jax_hisup_losses
from pixelspointspolygons_tpu.parallel import make_mesh, shard_batch
from pixelspointspolygons_tpu.train import hisup_step as jax_step
from pixelspointspolygons_tpu.train import state as jax_state
from pixelspointspolygons_torch.data.loader import to_device
from pixelspointspolygons_torch.models.hisup.model import HiSup
from pixelspointspolygons_torch.models.hrnet import HRNetEncoder
from pixelspointspolygons_torch.train.hisup_step import make_train_step, make_val_step
from pixelspointspolygons_torch.train.state import (
    TrainState,
    cosine_with_warmup,
    make_optimizer,
    make_scheduler,
)
from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict

TOPO = dict(width=4, stage1_planes=4, stage1_blocks=1, num_blocks=1, num_modules=(1, 1, 1), stem_ch=8)
S, DIM, LR, WD, TOTAL_STEPS = 64, 16, 1e-4, 1e-4, 10
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    cfg = jax_compose([
        "experiment=hisup_image",
        "dataset=synthetic",
        "run_type=debug",
        f"host.dataset_root={root}/data",
        f"host.model_root={root}/out",
        "experiment.dataset.num_train=4",
        "experiment.dataset.num_val=2",
        "experiment.dataset.num_test=2",
        "run_type.train_subset=null",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "experiment.model.batch_size=2",
        f"experiment.encoder.in_size={S}",
        f"experiment.model.decoder.in_feature_size={S}",
        f"experiment.model.decoder.in_feature_dim={DIM}",
    ])
    batches = list(jax_build_loader(cfg, "train"))
    assert len(batches) == 2 and batches[0]["images"].shape == (2, S, S, 3)
    weights = {k: float(v) for k, v in cfg.experiment.model.loss_weights.items()}
    jm = JaxHiSup(encoder_cfg={"name": "hrnet", "in_size": S, **TOPO}, dim=DIM, pred_size=S)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), {"images": jnp.asarray(batches[0]["images"])})

    @jax.jit
    def grads(params, batch_stats, jbatch):
        """The gradient the JAX train step takes (its loss_fn, hisup_step.py:39-44)."""
        targets = jax_encode_targets(jbatch, S)

        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": batch_stats}, {"images": jbatch["images"]},
                              train=True, mutable=["batch_stats"])
            return sum(weights[k] * v for k, v in jax_hisup_losses(out, targets).items())

        return jax.grad(loss_fn)(params)

    return {
        "batches": batches,
        "weights": weights,
        "jm": jm,
        "variables": jax.device_get(variables),  # host copy: the JAX train step donates its state
        "mesh": make_mesh(1),
        "train": jax_step.make_train_step(jm, weights, S),
        "val": jax_step.make_val_step(jm, weights, S),
        "grads": grads,
    }


def _jax_state(setup):
    tx = jax_state.make_optimizer("adamw", jax_state.cosine_with_warmup(LR, TOTAL_STEPS), weight_decay=WD)
    state = jax_state.create_train_state(setup["jm"], setup["variables"], tx)
    # committed device arrays and an array step count, as the jitted step
    # returns them, so that it compiles once
    return jax.device_put(state.replace(step=jnp.asarray(0)), jax.devices()[0])


def _port_state(setup):
    v = setup["variables"]
    model = HiSup(HRNetEncoder(in_size=S, out_dim=DIM, **TOPO), dim=DIM, pred_size=S)
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    opt = make_optimizer("adamw", model.parameters(), LR, weight_decay=WD)
    return TrainState(model, opt, make_scheduler(opt, cosine_with_warmup(LR, TOTAL_STEPS), LR))


def _jax_grads(setup, state, jbatch):
    return flax_to_state_dict(jax.device_get(setup["grads"](state.params, state.batch_stats, jbatch)))


def _port64_grads(state, batch, weights):
    """The port's gradient of the same loss evaluated in float64."""
    from pixelspointspolygons_torch.models.hisup.model import encode_targets, hisup_losses

    model = copy.deepcopy(state.model).double().train()
    targets = encode_targets(batch, S)
    targets = {k: v.double() if v.is_floating_point() else v for k, v in targets.items()}
    losses = hisup_losses(model({"images": batch["images"].double()}), targets)
    sum(weights[k] * v for k, v in losses.items()).backward()
    return {n: p.grad for n, p in model.named_parameters()}


def _rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


def _sync_port_to_jax(port, jstate):
    """Copy the JAX state (params, batch_stats, Adam moments, step) into the port."""
    sd = flax_to_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    port.model.load_state_dict(sd)
    adam = jstate.opt_state[0]  # (scale_by_adam, add_decayed_weights, scale_by_schedule)
    mu, nu = flax_to_state_dict(jax.device_get(adam.mu)), flax_to_state_dict(jax.device_get(adam.nu))
    for name, p in port.model.named_parameters():
        st = port.optimizer.state[p]
        st["exp_avg"].copy_(mu[name])
        st["exp_avg_sq"].copy_(nu[name])
        st["step"].fill_(int(adam.count))
    assert port.step == int(jstate.step)


def _assert_params_close(port, jstate, n_updates, near_frac=None):
    """Every element within 2·lr per update; with `near_frac`, all but that
    fraction within 1e-6."""
    want = flax_to_state_dict(jax.device_get(jstate.params))
    n_far = n_total = 0
    for name, p in port.model.named_parameters():
        d = (p.detach() - want[name]).abs()
        assert float(d.max()) <= 2 * n_updates * LR * 1.0001 + 1e-7, name
        n_far += int((d > 1e-6).sum())
        n_total += d.numel()
    if near_frac is not None:
        assert n_far <= near_frac * n_total, f"{n_far} of {n_total} parameters differ by more than 1e-6"


def _assert_stats_close(port, jstate, rtol):
    want = flax_to_state_dict({}, jax.device_get(jstate.batch_stats))
    got = port.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol, atol=1e-5, err_msg=k)


def _assert_metrics_close(got: dict, want: dict, rtol: float):
    assert set(got) == set(want) == {"loss", "loss_jloc", "loss_joff", "loss_mask", "loss_afm", "loss_remask"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, err_msg=k)


def test_two_train_steps_and_val_step_match_jax(setup):
    weights, mesh = setup["weights"], setup["mesh"]
    jstate, port = _jax_state(setup), _port_state(setup)
    jtrain, ptrain = setup["train"], make_train_step(weights, S)
    schedule = jax_state.cosine_with_warmup(LR, TOTAL_STEPS)
    for i, host_batch in enumerate(setup["batches"]):
        if i:  # step 2 from the JAX state after step 1
            _sync_port_to_jax(port, jstate)
        jbatch = shard_batch(host_batch, mesh)  # images and mask as float16, as the trainer ships them
        pbatch = to_device(host_batch, CPU, _DEV_KEYS)
        np.testing.assert_array_equal(pbatch["images"].numpy(), np.asarray(jbatch["images"], np.float32))

        want_lr = float(schedule(int(jstate.step)))
        np.testing.assert_allclose(port.scheduler.get_last_lr()[0], want_lr, rtol=1e-6)
        want_grads = _jax_grads(setup, jstate, jbatch)
        exact = _port64_grads(port, pbatch, weights)

        jstate, want = jtrain(jstate, jbatch)
        got = ptrain(port, pbatch)

        _assert_metrics_close(got, want, rtol=1e-5)
        port_grads = {n: p.grad for n, p in port.model.named_parameters()}
        assert set(port_grads) == set(want_grads) == set(exact)
        assert _rel_l2(port_grads, exact) <= 1e-2
        assert _rel_l2(want_grads, exact) <= 5e-2
        assert _rel_l2(port_grads, want_grads) <= 5e-2
        _assert_params_close(port, jstate, n_updates=1, near_frac=0.02)
        _assert_stats_close(port, jstate, rtol=5e-4)
        assert port.step == int(jstate.step) == i + 1

    jval = setup["val"](jstate, shard_batch(setup["batches"][0], mesh))
    pval = make_val_step(weights, S)(port, to_device(setup["batches"][0], CPU, _DEV_KEYS))
    _assert_metrics_close(pval, jval, rtol=1e-4)


def test_two_free_running_steps_stay_close(setup):
    """Both sides take two steps on their own: after the first update the
    weights differ by the flipped noise-level elements (2·lr each), so the
    second step's losses agree to 1e-3 and the parameters to 4·lr."""
    weights, mesh = setup["weights"], setup["mesh"]
    jstate, port = _jax_state(setup), _port_state(setup)
    jtrain, ptrain = setup["train"], make_train_step(weights, S)
    for host_batch in setup["batches"]:
        jstate, want = jtrain(jstate, shard_batch(host_batch, mesh))
        got = ptrain(port, to_device(host_batch, CPU, _DEV_KEYS))
        _assert_metrics_close(got, want, rtol=1e-3)
    _assert_params_close(port, jstate, n_updates=2)
    np.testing.assert_allclose(port.scheduler.get_last_lr()[0], float(jax_state.cosine_with_warmup(LR, TOTAL_STEPS)(2)), rtol=1e-6)


@pytest.mark.parametrize("name", ["cosine_with_warmup", "linear_warmup_decay"])
@pytest.mark.parametrize("total,warmup_frac", [(10, 0.0), (40, 0.05), (7, 0.3)])
def test_schedules_match_optax(name, total, warmup_frac):
    """The learning rate of every update n = 0 .. total+2 through the port's
    LambdaLR, against the optax schedule at count n (1e-6 relative: optax
    evaluates in float32)."""
    from pixelspointspolygons_torch.train import state as port_state

    want = getattr(jax_state, name)(LR, total, warmup_frac)
    model = torch.nn.Linear(1, 1)
    opt = make_optimizer("adamw", model.parameters(), LR)
    sched = make_scheduler(opt, getattr(port_state, name)(LR, total, warmup_frac), LR)
    for n in range(total + 3):
        np.testing.assert_allclose(sched.get_last_lr()[0], float(want(n)), rtol=1e-6, atol=1e-12, err_msg=str(n))
        opt.step()
        sched.step()
