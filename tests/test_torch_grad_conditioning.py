"""Where a float32 Pix2Poly gradient strays from the exact one once the
model has trained a few steps: the JAX package's and the port's float32
gradients, each against the port's float64 gradient from the same bridged
weights, on the CPU (the tiny model and batches of
tests/test_torch_train_pix2poly.py).

On an H100 the port's float32 gradient of the full-width model strays about
ten times further from the exact one after a few updates than at the
initial weights. If that came from the port, JAX's gradient would stay
near the exact one where the port's strays. Measured here, relative L2
over all parameters (JAX, port): at the initial weights 1.8e-6 and 1.5e-6;
after 12 JAX updates (TRAIN_STEPS) at 10 times the config's learning rate
5.0e-6 and 1.2e-6. JAX's drift grows with training and the port's does
not, so the port is no source of drift: each must stay under 1e-4, and the
port's within twice JAX's (+1e-6).
"""

import jax
import jax.numpy as jnp

from pixelspointspolygons_tpu.train import state as jax_state
from pixelspointspolygons_torch.train.pix2poly_step import _losses
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_train_pix2poly import (
    LR,
    PAD,
    PW,
    TOTAL_STEPS,
    VW,
    WD,
    make_batch,
    port64_grads,
    port_state_of,
    rel_l2,
    setup,  # noqa: F401  (the module-scoped fixture)
    to_torch,
)

TRAIN_STEPS = 12


def _drifts(setup, jstate, batch):
    """(JAX's, the port's) float32 gradient against the port's float64 one
    at the JAX state's weights."""
    port = port_state_of(setup)
    port.model.load_state_dict(flax_to_state_dict(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = flax_to_state_dict(jax.device_get(setup["grads"](jstate.params, jstate.batch_stats, jbatch)))
    exact = port64_grads(port, to_torch(batch))
    _losses(port.model.train(), to_torch(batch), VW, PW, PAD)["loss"].backward()
    got = {n: p.grad for n, p in port.model.named_parameters()}
    return rel_l2(want, exact), rel_l2(got, exact)


def test_float32_gradient_drift_is_the_same_in_jax(setup):
    tx = jax_state.make_optimizer("adamw", jax_state.linear_warmup_decay(10 * LR, TOTAL_STEPS, 0.05),
                                  weight_decay=WD, b2=0.95)
    jstate = jax.device_put(jax_state.create_train_state(setup["jm"], setup["variables"], tx).replace(
        step=jnp.asarray(0)), jax.devices()[0])
    probe = make_batch(2)
    readings = {"initial": _drifts(setup, jstate, probe)}
    key = jax.random.PRNGKey(0)
    for i in range(TRAIN_STEPS):
        batch = setup["batches"][i % 2]
        jstate, _ = setup["train"](jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    readings["trained"] = _drifts(setup, jstate, probe)
    for jax_drift, port_drift in readings.values():
        assert jax_drift <= 1e-4 and port_drift <= 1e-4, readings
        assert port_drift <= 2 * jax_drift + 1e-6, readings
