"""The port's logit normalization against JAX's (``utilities/compute.py``).

``normalize_logits_if_needed`` takes the softmax as ``jax.nn.softmax`` does,
``exp(x - max) / sum`` divided: on rows built so that an exponential of
``1 - 2^-24`` ties ``1 / sum`` (a sum of 6.25), the probabilities, and so
their argmax, equal JAX's to the bit. Then one logits path of each metric
family that normalizes (and of ranking, which takes raw scores) against JAX.

Tolerances: the softmax equal bit for bit on the near-tie rows and within
1e-6 relative elsewhere (float32 sums of a row in another order); integer
results equal; the family values within 1e-6 relative (calibration,
hinge, ranking and AUROC: float32 sums in another order than XLA's).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed

F32 = np.float32


def _near_tie_logits(seed, n, c):
    """Rows where an exponential of 1 sits below the raw max (rows 0::4), where one of
    1 - 2^-24 ties 1 / 6.25 (1::4) and where it stays below 1 / 3 (2::4); the rest random."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=2.0, size=(n, c)).astype(F32)
    for rows in (slice(0, None, 4), slice(1, None, 4), slice(2, None, 4)):
        x[rows] = -100.0
    x[0::4, 0], x[0::4, 3] = -(2.0**-27), 0.0
    x[1::4, 0], x[1::4, 1:6], x[1::4, 6] = -(2.0**-24), 0.0, F32(np.log(0.25))
    x[2::4, 0], x[2::4, 1:3] = -(2.0**-24), 0.0
    return x


@pytest.mark.parametrize("c", [7, 40, 1100])
def test_softmax_divides_as_jax_on_near_tie_rows(c):
    x = _near_tie_logits(3, 64, c)
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=1))
    got = normalize_logits_if_needed(torch.from_numpy(x), "softmax").numpy()
    # the built rows' exp(-100) / sum are subnormal, which XLA on the CPU flushes to zero (ROADMAP Queue 3);
    # every normal probability of those rows is JAX's to the bit
    built = (np.arange(64) % 4 != 3)[:, None] & (np.abs(got) >= np.finfo(F32).tiny)
    assert built[1::4, :7].all()
    np.testing.assert_array_equal(got[built], want[built])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-37)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert (got.argmax(1)[1::4] == 0).all()  # the lower index ties the max probability, as in JAX


def test_softmax_nan_and_inf_rows_as_jax():
    x = np.random.default_rng(4).normal(size=(6, 5)).astype(F32)
    x[0, 2] = np.nan
    x[1] = -np.inf
    x[2, 1] = np.inf
    x[3, 0] = -np.inf
    x[4, :] = 0.0
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=1))
    got = normalize_logits_if_needed(torch.from_numpy(x), "softmax").numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_softmax_over_dim_one_of_multi_dim_inputs():
    x = np.random.default_rng(5).normal(scale=3.0, size=(3, 4, 5, 2)).astype(F32)
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=1))
    got = normalize_logits_if_needed(torch.from_numpy(x), "softmax").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


C = 40


def _family_inputs(family):
    rng = np.random.default_rng(hash(family) % 2**32)
    if family in ("stat_scores", "confusion_matrix", "binary_calibration"):
        return rng.normal(scale=2.0, size=96).astype(F32), rng.integers(0, 2, 96).astype(np.int32)
    if family == "curves":  # normal floats throughout: the near-tie rows' exp(-100) is subnormal (Queue 3)
        return rng.normal(scale=2.0, size=(96, C)).astype(F32), rng.integers(0, C, 96).astype(np.int32)
    if family == "ranking":
        return rng.normal(scale=2.0, size=(48, 8)).astype(F32), rng.integers(0, 2, (48, 8)).astype(np.int32)
    return _near_tie_logits(6, 96, C), rng.integers(0, C, 96).astype(np.int32)


FAMILIES = {  # family: (functional module, function, kwargs)
    "stat_scores": ("stat_scores", "binary_stat_scores", {}),
    "confusion_matrix": ("confusion_matrix", "binary_confusion_matrix", {}),
    "curves": ("auroc", "multiclass_auroc", {"num_classes": C, "average": "macro"}),
    "calibration": ("calibration_error", "multiclass_calibration_error", {"num_classes": C, "n_bins": 15}),
    "binary_calibration": ("calibration_error", "binary_calibration_error", {"n_bins": 15}),
    "hinge": ("hinge", "multiclass_hinge_loss", {"num_classes": C}),
    "ranking": ("ranking", "multilabel_ranking_average_precision", {"num_labels": 8}),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_path_of_each_family_against_jax(family):
    module, fn, kwargs = FAMILIES[family]
    preds, target = _family_inputs(family)
    jf = getattr(importlib.import_module(f"torchmetrics_tpu.functional.classification.{module}"), fn)
    tf = getattr(importlib.import_module(f"torchmetrics_tpu_torch.functional.classification.{module}"), fn)
    want = np.asarray(jf(jnp.asarray(preds), jnp.asarray(target), **kwargs))
    got = tf(torch.from_numpy(preds), torch.from_numpy(target), **kwargs).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
