"""Parity of the port's mean squared error with the JAX package.

The sums of squares are float32 and taken in another order than XLA's:
``rtol=1e-5``. The integer row counter must be exactly equal, and int32.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.regression import MeanSquaredError as JaxMSE
from torchmetrics_tpu_torch.functional.regression import basic as tbasic
from torchmetrics_tpu_torch.regression import MeanSquaredError

jbasic = importlib.import_module("torchmetrics_tpu.functional.regression.basic")

RTOL = 1e-5


def _batch(seed, shape=(200,)):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=shape).astype(np.float32)
    return preds, (preds + rng.normal(scale=0.3, size=shape)).astype(np.float32)


@pytest.mark.parametrize("num_outputs", [1, 3])
@pytest.mark.parametrize("squared", [True, False])
def test_mse_multi_batch_parity(squared, num_outputs):
    shape = (64,) if num_outputs == 1 else (64, num_outputs)
    jm = JaxMSE(squared=squared, num_outputs=num_outputs)
    tm = MeanSquaredError(squared=squared, num_outputs=num_outputs, device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    for seed in range(5):
        preds, target = _batch(seed, shape)
        js = jm.update_state(js, jnp.asarray(preds), jnp.asarray(target))
        ts = tm.update_state(ts, torch.from_numpy(preds), torch.from_numpy(target))
    assert ts["total"].dtype == torch.int32 and ts["measure"].dtype == torch.float32
    assert ts["_n"].dtype == torch.int32
    np.testing.assert_array_equal(ts["total"].numpy(), np.asarray(js["total"]))
    np.testing.assert_array_equal(ts["_n"].numpy(), np.asarray(js["_n"]))
    np.testing.assert_allclose(ts["measure"].numpy(), np.asarray(js["measure"]), rtol=RTOL)
    got = tm.compute_state(ts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.compute_state(js)), rtol=RTOL)


@pytest.mark.parametrize("squared", [True, False])
def test_functional_mse_parity(squared):
    preds, target = _batch(11, (7, 5))
    want = jbasic.mean_squared_error(jnp.asarray(preds), jnp.asarray(target), squared=squared)
    got = tbasic.mean_squared_error(torch.from_numpy(preds), torch.from_numpy(target), squared=squared)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_float64_inputs_are_narrowed_like_jax():
    # with x64 off the JAX package computes in float32; so does the port
    preds, target = _batch(3)
    tm = MeanSquaredError(device="cpu")
    tm.update(preds.astype(np.float64), target.astype(np.float64))
    assert tm.metric_state["measure"].dtype == torch.float32
    jm = JaxMSE()
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=RTOL)


def test_mse_errors():
    with pytest.raises(RuntimeError, match="same shape"):
        tbasic.mean_squared_error(torch.zeros(3), torch.zeros(4))
    with pytest.raises(ValueError, match="boolean"):
        MeanSquaredError(squared=1, device="cpu")


def test_mse_compute_before_update_warns_and_gives_zero():
    tm = MeanSquaredError(device="cpu")
    with pytest.warns(UserWarning, match="before the ``update``"):
        assert float(tm.compute()) == 0.0
