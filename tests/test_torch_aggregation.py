"""Parity of the port's aggregation metrics with the JAX package's ``aggregation.py``.

The same seeded numpy values (NaNs among them) go through both packages on
the CPU, update after update, with every ``nan_strategy``. Sums, means and
ring buffers are float32 reductions taken in another order than XLA's:
within ``ATOL = 1e-5`` (values up to a few tens); max, min and cat are
exact. The ring buffers run over more updates than their window.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.aggregation as ja
import torchmetrics_tpu_torch.aggregation as ta
from torchmetrics_tpu_torch.convert import state_from_jax

ATOL = 1e-5
AGGREGATORS = ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric", "CatMetric", "RunningMean", "RunningSum"]
STRATEGIES = ["warn", "ignore", "disable", 0.5, "error"]


def _values(seed, n=16, nan=True):
    rng = np.random.default_rng(seed)
    v = (10 * rng.normal(size=n)).astype(np.float32)
    if nan:
        v[rng.integers(0, n, 3)] = np.nan
    return v


def _pair(name, **kw):
    return getattr(ja, name)(**kw), getattr(ta, name)(**kw, device="cpu")


def _assert_close(got, want, exact=False):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _run(jm, tm, batches, weights=None):
    for i, v in enumerate(batches):
        extra = () if weights is None else (weights[i],)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jm.update(jnp.asarray(v), *(jnp.asarray(w) for w in extra))
            tm.update(torch.from_numpy(v), *(torch.from_numpy(w) for w in extra))


@pytest.mark.parametrize("strategy", STRATEGIES[:4], ids=[str(s) for s in STRATEGIES[:4]])
@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregator_parity(name, strategy):
    kw = {"nan_strategy": strategy}
    if name.startswith("Running"):
        kw["window"] = 3
    jm, tm = _pair(name, **kw)
    _run(jm, tm, [_values(s) for s in range(7)])  # more updates than the window
    want, got = jm.compute(), tm.compute()
    _assert_close(got, want, exact=name in ("MaxMetric", "MinMetric", "CatMetric"))
    for leaf, value in tm.metric_state.items():
        if isinstance(value, tuple):
            for g, w in zip(value, jm.metric_state[leaf]):
                _assert_close(g, w, exact=True)
        elif leaf != "_n":
            _assert_close(value, jm.metric_state[leaf], exact=name in ("MaxMetric", "MinMetric"))


@pytest.mark.parametrize("name", AGGREGATORS)
def test_error_strategy_raises_on_nan_and_passes_finite(name):
    kw = {"nan_strategy": "error", **({"window": 2} if name.startswith("Running") else {})}
    jm, tm = _pair(name, **kw)
    _run(jm, tm, [_values(1, nan=False), _values(2, nan=False)])
    _assert_close(tm.compute(), jm.compute(), exact=name in ("MaxMetric", "MinMetric", "CatMetric"))
    with pytest.raises(RuntimeError, match="nan"):
        tm.update(torch.tensor([1.0, float("nan")]))


@pytest.mark.parametrize("name", AGGREGATORS)
def test_warn_strategy_warns(name):
    tm = getattr(ta, name)(device="cpu")
    with pytest.warns(UserWarning, match="nan"):
        tm.update(torch.tensor([1.0, float("nan")]))


@pytest.mark.parametrize("strategy", ["ignore", "disable", 2.0])
@pytest.mark.parametrize("name", ["MeanMetric", "RunningMean"])
def test_weighted_means(name, strategy):
    kw = {"nan_strategy": strategy, **({"window": 4} if name == "RunningMean" else {})}
    jm, tm = _pair(name, **kw)
    rng = np.random.default_rng(5)
    batches = [_values(10 + s) for s in range(9)]
    weights = [rng.uniform(0.1, 2.0, 16).astype(np.float32) for _ in range(9)]
    _run(jm, tm, batches, weights)
    _assert_close(tm.compute(), jm.compute())


def test_scalar_and_python_float_inputs():
    jm, tm = _pair("MeanMetric")
    for v in (1.5, 2.5, 7.0):
        jm.update(v)
        tm.update(v)
    _assert_close(tm.compute(), jm.compute())
    jm, tm = _pair("RunningSum", window=2)
    for v in (1.0, 2.0, 4.0):
        jm.update(v)
        tm.update(v)
    assert float(tm.compute()) == float(jm.compute()) == 6.0


@pytest.mark.parametrize("window", [1, 2, 5])
def test_ring_buffer_slots_follow_the_update_counter(window):
    tm = ta.RunningSum(window=window, device="cpu")
    for i in range(1, 8):
        tm.update(torch.tensor([float(i)]))
        assert float(tm.compute()) == float(sum(range(max(1, i - window + 1), i + 1)))
    assert int(tm.metric_state["_n"]) == 7


def test_constructor_checks():
    for bad in ("nope", True):
        with pytest.raises(ValueError, match="nan_strategy"):
            ta.SumMetric(nan_strategy=bad, device="cpu")
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError, match="window"):
            ta.RunningMean(window=bad, device="cpu")
    from torchmetrics_tpu_torch.classification import BinaryAccuracy

    with pytest.raises(ValueError, match="nan_strategy"):  # the base goes on refusing it for other metrics
        BinaryAccuracy(nan_strategy="warn", device="cpu")


@pytest.mark.parametrize("name", AGGREGATORS)
def test_state_from_jax_round_trip(name):
    kw = {"window": 3} if name.startswith("Running") else {}
    jm, tm = _pair(name, **kw)
    state = jm.init_state()
    for s in range(4):
        state = jm.update_state(state, jnp.asarray(_values(20 + s, nan=False)))
    np_state = {k: (list(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v)) for k, v in state.items()}
    carried = state_from_jax(tm, np_state)
    _assert_close(tm.compute_state(carried), jm.compute_state(state))
    # and the port goes on from the carried state as JAX does
    more = _values(30, nan=False)
    _assert_close(tm.compute_state(tm.update_state(carried, torch.from_numpy(more))),
                  jm.compute_state(jm.update_state(state, jnp.asarray(more))))


def test_merge_states_of_sum_mean_max_min():
    for name in ("SumMetric", "MeanMetric", "MaxMetric", "MinMetric"):
        _, tm = _pair(name)
        a = tm.update_state(tm.init_state(), torch.from_numpy(_values(40, nan=False)))
        b = tm.update_state(tm.init_state(), torch.from_numpy(_values(41, nan=False)))
        both = tm.update_state(a, torch.from_numpy(_values(41, nan=False)))
        torch.testing.assert_close(tm.compute_state(tm.merge_states(a, b)), tm.compute_state(both), rtol=0, atol=ATOL)
