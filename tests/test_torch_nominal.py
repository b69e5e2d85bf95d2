"""Parity of the port's nominal-association metrics with the JAX package.

The same seeded numpy series (a few hundred rows of up to 9 categories,
with NaN, +-inf, negative values and values past the int32 range) go through
both packages; the port runs on the CPU, where the contingency table is the
plain version of the ``confmat_multiclass`` kernel in its labels mode
(``chip_smoke.py`` holds the kernel against it on the card, these tables
included).

Tolerances: contingency tables (float32 counts) equal; statistics within
1e-5 relative and 1e-6 absolute (float32 chi-squared and entropy sums of at
most 81 cells, in another order than XLA's); Fleiss' kappa's counts equal.
"""

import importlib
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.nominal as jfn
import torchmetrics_tpu.nominal as jn
import torchmetrics_tpu_torch.functional.nominal as tfn
import torchmetrics_tpu_torch.nominal as tn
from torchmetrics_tpu_torch.convert import state_from_jax

jcont = importlib.import_module("torchmetrics_tpu.functional.nominal.contingency")
tcont = importlib.import_module("torchmetrics_tpu_torch.functional.nominal.contingency")
jutils = importlib.import_module("torchmetrics_tpu.functional.nominal.utils")
tutils = importlib.import_module("torchmetrics_tpu_torch.functional.nominal.utils")

CPU = {"device": "cpu"}
TOL = (1e-5, 1e-6)
STATS = ["cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u"]
F32 = np.float32


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol[0], atol=tol[1],
                               equal_nan=True)


def _series(seed, n=300, c=5, nan_every=0, agree=0.6):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, c, size=n).astype(F32)
    preds = np.where(rng.random(n) < agree, target, rng.integers(0, c, size=n)).astype(F32)
    if nan_every:
        preds[::nan_every] = np.nan
        target[3::nan_every + 1] = np.nan
    return preds, target


def _kwargs_of(name, nan_strategy, bias_correction):
    kwargs = {"nan_strategy": nan_strategy}
    if nan_strategy == "replace":
        kwargs["nan_replace_value"] = 1.0
    if name in ("cramers_v", "tschuprows_t"):
        kwargs["bias_correction"] = bias_correction
    return kwargs


# ----------------------------------------------------------------- the contingency table
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("case", ["plain", "nan", "inf and past int32", "negative and past C", "2-D scores"])
def test_contingency_table_equals_jax(nan_strategy, case):
    preds, target = _series(1, nan_every=7 if case != "plain" else 0)
    c = 5
    if case == "inf and past int32":
        preds[5::31], target[9::37], preds[2::41], target[4::43] = np.inf, -np.inf, 3e9, -5e9
    if case == "negative and past C":
        preds[5::13], target[9::17], preds[1::19], target[2::23] = -1.0, -7.0, 5.0, 6.0
    if case == "2-D scores":
        rng = np.random.default_rng(2)
        preds = rng.normal(size=(300, c)).astype(F32)
        preds[::11, 2] = np.nan
        preds[1::13] = 0.5  # ties: the first maximum
    want = np.asarray(jcont._nominal_confmat_update(jnp.asarray(preds), jnp.asarray(target), c, nan_strategy, 0.0))
    got = tcont._nominal_confmat_update(torch.from_numpy(preds), torch.from_numpy(target), c, nan_strategy, 0.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_saturating_cast_is_xla_convert():
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0**31, -(2.0**31), 2147483520.0, -1.5, 1.9, 0.0], F32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(tcont._saturating_int32(torch.from_numpy(x)).numpy(), want)


def test_dropped_rows_meet_no_real_pair():
    """A dropped row goes to flat cell C * C: past the table, so the last cell, (C-1, C-1), stays as the kept
    rows make it."""
    preds = np.array([4, 4, np.nan, 4, 0], F32)
    target = np.array([4, np.nan, 4, 4, 0], F32)
    got = tcont._nominal_confmat_update(torch.from_numpy(preds), torch.from_numpy(target), 5, "drop")
    assert float(got[4, 4]) == 2.0 and float(got.sum()) == 3.0
    want = jcont._nominal_confmat_update(jnp.asarray(preds), jnp.asarray(target), 5, "drop")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------- functional statistics
STAT_CASES = [(name, bias) for name in STATS for bias in ((True, False) if name in STATS[:2] else (True,))]


@pytest.mark.parametrize(("name", "bias_correction"), STAT_CASES)
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("seed", [3, 4])
def test_statistics_against_jax(name, nan_strategy, bias_correction, seed):
    preds, target = _series(seed, nan_every=9)
    kwargs = _kwargs_of(name, nan_strategy, bias_correction)
    _close(getattr(tfn, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
           getattr(jfn, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs))


@pytest.mark.parametrize("name", STATS)
def test_statistics_two_by_two_and_degenerate(name):
    """df = 1 takes Yates' correction; a single category gives JAX's NaN, 0 or warning."""
    preds, target = _series(5, c=2)
    _close(getattr(tfn, name)(torch.from_numpy(preds), torch.from_numpy(target)),
           getattr(jfn, name)(jnp.asarray(preds), jnp.asarray(target)))
    ones = np.ones(20, F32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(getattr(tfn, name)(torch.from_numpy(ones), torch.from_numpy(_series(6, n=20)[1])),
               getattr(jfn, name)(jnp.asarray(ones), jnp.asarray(_series(6, n=20)[1])))


def test_bias_correction_warning_as_jax():
    preds, target = np.array([0, 1, 0, 1], F32), np.array([0, 1, 1, 0], F32)
    for name in ("cramers_v", "tschuprows_t"):
        with pytest.warns(UserWarning, match="bias correction") as got:
            tv = getattr(tfn, name)(torch.from_numpy(preds[:2]), torch.from_numpy(target[:2]))
        jv = getattr(jfn, name)(jnp.asarray(preds[:2]), jnp.asarray(target[:2]))
        _close(tv, jv)
        assert got


@pytest.mark.parametrize("name", ["cramers_v_matrix", "tschuprows_t_matrix", "pearsons_contingency_coefficient_matrix",
                                  "theils_u_matrix"])
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_matrix_functions_against_jax(name, nan_strategy):
    rng = np.random.default_rng(7)
    matrix = np.stack([rng.integers(0, c, size=200) for c in (3, 5, 2, 6)], 1).astype(F32)
    matrix[::17, 1] = np.nan
    kwargs = {"nan_strategy": nan_strategy}
    _close(getattr(tfn, name)(torch.from_numpy(matrix), **kwargs), getattr(jfn, name)(jnp.asarray(matrix), **kwargs))


def test_errors_as_jax():
    x = np.zeros(4, F32)
    for name in STATS:
        for kwargs in ({"nan_strategy": "keep"}, {"nan_strategy": "replace", "nan_replace_value": "a"}):
            with pytest.raises(ValueError) as want:
                getattr(jfn, name)(jnp.asarray(x), jnp.asarray(x), **kwargs)
            with pytest.raises(ValueError) as got:
                getattr(tfn, name)(torch.from_numpy(x), torch.from_numpy(x), **kwargs)
            assert str(got.value) == str(want.value)


def test_utils_against_jax():
    preds, target = _series(8, nan_every=5)
    for strategy in ("replace", "drop"):
        got = tutils._handle_nan_in_data(torch.from_numpy(preds), torch.from_numpy(target), strategy, 2.0)
        want = jutils._handle_nan_in_data(jnp.asarray(preds), jnp.asarray(target), strategy, 2.0)
        for g, w in zip(got, want):
            _close(g, w, (0.0, 0.0))
    table = np.array([[3, 0, 1], [0, 0, 0], [2, 0, 5]], F32)
    _close(tutils._drop_empty_rows_and_cols(torch.from_numpy(table)),
           jutils._drop_empty_rows_and_cols(jnp.asarray(table)), (0.0, 0.0))


# ----------------------------------------------------------------- Fleiss' kappa
def test_fleiss_kappa_against_jax():
    rng = np.random.default_rng(9)
    counts = rng.multinomial(6, [0.2, 0.3, 0.1, 0.4], size=50).astype(np.int64)
    _close(tfn.fleiss_kappa(torch.from_numpy(counts)), jfn.fleiss_kappa(jnp.asarray(counts)))
    probs = rng.random((50, 4, 7)).astype(F32)
    probs[::6, :, 2] = np.nan  # the first NaN is the argmax, as in jnp.argmax
    probs[1::5, 1:3, 3] = 0.999  # ties: the first maximum
    _close(tfn.fleiss_kappa(torch.from_numpy(probs), mode="probs"), jfn.fleiss_kappa(jnp.asarray(probs), mode="probs"))
    got = importlib.import_module("torchmetrics_tpu_torch.functional.nominal.fleiss_kappa")._fleiss_kappa_update(
        torch.from_numpy(probs), "probs")
    want = importlib.import_module("torchmetrics_tpu.functional.nominal.fleiss_kappa")._fleiss_kappa_update(
        jnp.asarray(probs), "probs")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for ratings, mode in ((probs, "counts"), (counts, "probs"), (counts[:, :, None], "counts")):
        with pytest.raises(ValueError) as want_err:
            jfn.fleiss_kappa(jnp.asarray(ratings), mode=mode)
        with pytest.raises(ValueError) as got_err:
            tfn.fleiss_kappa(torch.from_numpy(ratings), mode=mode)
        assert str(got_err.value) == str(want_err.value)


# ----------------------------------------------------------------- classes
CLASSES = {
    "CramersV": {"num_classes": 5},
    "CramersV-drop-no-bias": {"num_classes": 5, "nan_strategy": "drop", "bias_correction": False},
    "TschuprowsT": {"num_classes": 5, "nan_replace_value": 2.0},
    "TschuprowsT-drop": {"num_classes": 5, "nan_strategy": "drop"},
    "PearsonsContingencyCoefficient": {"num_classes": 5},
    "PearsonsContingencyCoefficient-drop": {"num_classes": 5, "nan_strategy": "drop"},
    "TheilsU": {"num_classes": 5},
    "TheilsU-drop": {"num_classes": 5, "nan_strategy": "drop"},
}


def _state_np(metric):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v))
            for k, v in metric.metric_state.items()}


@pytest.mark.parametrize("key", sorted(CLASSES))
def test_classes_update_compute_forward_and_state_from_jax(key):
    name, kwargs = key.split("-")[0], CLASSES[key]
    jm, tm = getattr(jn, name)(**kwargs), getattr(tn, name)(**kwargs, **CPU)
    batches = [_series(20 + b, n=120, nan_every=11) for b in range(3)]
    for p, t in batches[:2]:
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    want_state = _state_np(jm)
    assert tm.metric_state["confmat"].dtype == torch.float32
    np.testing.assert_array_equal(tm.metric_state["confmat"].numpy(), want_state["confmat"])
    carried = getattr(tn, name)(**kwargs, **CPU)
    carried._state = state_from_jax(carried, want_state)
    p, t = batches[2]
    _close(tm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)))
    carried.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(tm.compute(), jm.compute())
    _close(carried.compute(), jm.compute())


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_class(mode):
    rng = np.random.default_rng(30)
    batches = ([rng.multinomial(5, [0.3, 0.3, 0.4], size=40).astype(np.int32) for _ in range(3)] if mode == "counts"
               else [rng.random((40, 3, 5)).astype(F32) for _ in range(3)])
    jm, tm = jn.FleissKappa(mode=mode), tn.FleissKappa(mode=mode, **CPU)
    for b in batches[:2]:
        jm.update(jnp.asarray(b))
        tm.update(torch.from_numpy(b))
    carried = tn.FleissKappa(mode=mode, **CPU)
    carried._state = state_from_jax(carried, _state_np(jm))
    for got, want in zip(tm.metric_state["counts"], _state_np(jm)["counts"]):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    _close(tm(torch.from_numpy(batches[2])), jm(jnp.asarray(batches[2])))
    carried.update(torch.from_numpy(batches[2]))
    _close(tm.compute(), jm.compute())
    _close(carried.compute(), jm.compute())


def test_class_errors_and_pickle():
    for cls, kwargs in [("CramersV", {"num_classes": 0}), ("TheilsU", {"num_classes": 3, "nan_strategy": "x"}),
                        ("FleissKappa", {"mode": "x"})]:
        with pytest.raises(ValueError) as want:
            getattr(jn, cls)(**kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tn, cls)(**kwargs, **CPU)
        assert str(got.value) == str(want.value)
    tm = tn.CramersV(num_classes=5, **CPU)
    tm.update(*map(torch.from_numpy, _series(40)))
    _close(pickle.loads(pickle.dumps(tm)).compute(), tm.compute(), (0.0, 0.0))
