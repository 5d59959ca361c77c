"""`graft_entry_torch.entry()`, the port's twin of `__graft_entry__.entry()`:
the same example arguments, and outputs of the shapes and dtypes that
`jax.eval_shape` gives for the JAX entry's function (no compile), on the
CPU."""

import jax
import numpy as np
from flax import linen as fnn
import pytest
import torch

import __graft_entry__ as jax_entry
import graft_entry_torch


def test_entry_matches_the_jax_entry(monkeypatch):
    # the JAX entry's eager init of the full model takes most of a minute;
    # eval_shape needs only the variables' shapes
    init = fnn.Module.init
    monkeypatch.setattr(fnn.Module, "init", lambda self, *a, **k: jax.eval_shape(lambda: init(self, *a, **k)))
    jfn, jargs = jax_entry.entry()
    want = jax.eval_shape(jfn, *jargs)
    fn, (images, y) = graft_entry_torch.entry("cpu")
    for got, ref in ((images, jargs[2]), (y, jargs[3])):
        assert tuple(got.shape) == ref.shape and str(got.dtype).removeprefix("torch.") == str(ref.dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    out = fn(images, y)
    assert len(out) == len(want) == 2
    for got, ref in zip(out, want):
        assert tuple(got.shape) == ref.shape and str(got.dtype).removeprefix("torch.") == str(ref.dtype)
        assert torch.isfinite(got).all()
    np.testing.assert_allclose(out[1].sum(-1).numpy(), 1.0, atol=1e-5)  # the permutation's rows


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry_torch.entry()
