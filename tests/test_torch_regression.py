"""Parity of the port's regression metrics with the JAX package: every error,
correlation, variance and distribution metric, functional and modular.

Seeded numpy inputs go through both packages on the CPU. Results are float32
reductions taken in another order than XLA's: within ``RTOL = 1e-5`` relative
and ``ATOL = 1e-5`` absolute (values of order one; sums of a few hundred
terms). Integer counts are exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.regression as jr
import torchmetrics_tpu_torch.regression as tr
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

jfb = importlib.import_module("torchmetrics_tpu.functional.regression.basic")
tfb = importlib.import_module("torchmetrics_tpu_torch.functional.regression.basic")
jfc = importlib.import_module("torchmetrics_tpu.functional.regression.correlation")
tfc = importlib.import_module("torchmetrics_tpu_torch.functional.regression.correlation")
jfv = importlib.import_module("torchmetrics_tpu.functional.regression.variance")
tfv = importlib.import_module("torchmetrics_tpu_torch.functional.regression.variance")

RTOL = ATOL = 1e-5
N = 200


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _xy(seed, shape=(N,), positive=False, ties=False):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=shape).astype(np.float32)
    p = (t + 0.3 * rng.normal(size=shape)).astype(np.float32)
    if positive:
        t, p = np.abs(t) + 0.1, np.abs(p) + 0.1
    if ties:
        t, p = np.round(t, 1), np.round(p, 1)
    return p.astype(np.float32), t.astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    return fn_t(*map(torch.from_numpy, arrays), **kw), fn_j(*map(jnp.asarray, arrays), **kw)


# ------------------------------------------------------------------ functional
FUNCTIONAL = [  # (name, module pair, kwargs, input kind)
    ("mean_squared_error", "b", {}, "plain"),
    ("mean_squared_error", "b", {"squared": False}, "plain"),
    ("mean_absolute_error", "b", {}, "plain"),
    ("mean_squared_log_error", "b", {}, "positive"),
    ("mean_absolute_percentage_error", "b", {}, "plain"),
    ("symmetric_mean_absolute_percentage_error", "b", {}, "plain"),
    ("weighted_mean_absolute_percentage_error", "b", {}, "plain"),
    ("log_cosh_error", "b", {}, "plain"),
    ("minkowski_distance", "b", {"p": 3.0}, "plain"),
    ("minkowski_distance", "b", {"p": 1}, "plain"),
    ("tweedie_deviance_score", "b", {"power": 0.0}, "positive"),
    ("tweedie_deviance_score", "b", {"power": 1.0}, "positive"),
    ("tweedie_deviance_score", "b", {"power": 1.5}, "positive"),
    ("tweedie_deviance_score", "b", {"power": 2.0}, "positive"),
    ("tweedie_deviance_score", "b", {"power": 3.0}, "positive"),
    ("critical_success_index", "b", {"threshold": 0.2}, "plain"),
    ("cosine_similarity", "b", {"reduction": "sum"}, "2d"),
    ("cosine_similarity", "b", {"reduction": "mean"}, "2d"),
    ("cosine_similarity", "b", {"reduction": "none"}, "2d"),
    ("kl_divergence", "b", {}, "dist"),
    ("kl_divergence", "b", {"reduction": "sum"}, "dist"),
    ("kl_divergence", "b", {"reduction": "none"}, "dist"),
    ("kl_divergence", "b", {"log_prob": True}, "logdist"),
    ("pearson_corrcoef", "c", {}, "plain"),
    ("pearson_corrcoef", "c", {}, "2d"),
    ("spearman_corrcoef", "c", {}, "ties"),
    ("spearman_corrcoef", "c", {}, "2d"),
    ("kendall_rank_corrcoef", "c", {"variant": "a"}, "ties"),
    ("kendall_rank_corrcoef", "c", {"variant": "b"}, "ties"),
    ("kendall_rank_corrcoef", "c", {"variant": "c"}, "ties"),
    ("concordance_corrcoef", "c", {}, "plain"),
    ("concordance_corrcoef", "c", {}, "2d"),
    ("r2_score", "v", {}, "plain"),
    ("r2_score", "v", {"adjusted": 3}, "plain"),
    ("r2_score", "v", {"multioutput": "raw_values"}, "2d"),
    ("r2_score", "v", {"multioutput": "variance_weighted"}, "2d"),
    ("explained_variance", "v", {}, "plain"),
    ("explained_variance", "v", {"multioutput": "raw_values"}, "2d"),
    ("explained_variance", "v", {"multioutput": "variance_weighted"}, "2d"),
    ("relative_squared_error", "v", {}, "plain"),
    ("relative_squared_error", "v", {"squared": False}, "2d"),
]
MODS = {"b": (jfb, tfb), "c": (jfc, tfc), "v": (jfv, tfv)}


def _inputs(kind, seed):
    if kind == "2d":
        return _xy(seed, (N // 4, 4))
    if kind in ("dist", "logdist"):
        rng = np.random.default_rng(seed)
        p, q = rng.dirichlet(np.ones(6), size=30).astype(np.float32), rng.dirichlet(np.ones(6), size=30).astype(np.float32)
        return (np.log(p), np.log(q)) if kind == "logdist" else (p, q)
    return _xy(seed, positive=kind == "positive", ties=kind == "ties")


@pytest.mark.parametrize(("name", "mod", "kw", "kind"), FUNCTIONAL,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or kind}" for n, _, kw, kind in FUNCTIONAL])
def test_functional_parity(name, mod, kw, kind):
    jm, tm = MODS[mod]
    got, want = _both(getattr(jm, name), getattr(tm, name), *_inputs(kind, 1), **kw)
    _close(got, want)


def test_csi_keep_sequence_dim():
    p, t = _xy(2, (8, 12))
    got, want = _both(jfb.critical_success_index, tfb.critical_success_index, p, t, threshold=0.0, keep_sequence_dim=0)
    _close(got, want)


def test_functional_argument_checks():
    p, t = map(torch.from_numpy, _xy(3))
    with pytest.raises(TorchMetricsUserError):
        tfb.minkowski_distance(p, t, p=0.5)
    with pytest.raises(ValueError, match="power"):
        tfb.tweedie_deviance_score(p, t, power=0.5)
    with pytest.raises(RuntimeError, match="same shape"):
        tfb.mean_absolute_error(p, t[:-1])
    with pytest.raises(ValueError, match="2D"):
        tfb.kl_divergence(p, t)
    with pytest.raises(ValueError, match="variant"):
        tfc.kendall_rank_corrcoef(p, t, variant="d")


# ------------------------------------------------------------------ modular
CLASSES = [  # (name, kwargs, input kind)
    ("MeanSquaredError", {}, "plain"),
    ("MeanSquaredError", {"squared": False}, "plain"),
    ("MeanSquaredError", {"num_outputs": 4}, "2d"),
    ("MeanAbsoluteError", {}, "plain"),
    ("MeanAbsoluteError", {"num_outputs": 4}, "2d"),
    ("MeanSquaredLogError", {}, "positive"),
    ("MeanAbsolutePercentageError", {}, "plain"),
    ("SymmetricMeanAbsolutePercentageError", {}, "plain"),
    ("WeightedMeanAbsolutePercentageError", {}, "plain"),
    ("LogCoshError", {}, "plain"),
    ("LogCoshError", {"num_outputs": 4}, "2d"),
    ("MinkowskiDistance", {"p": 2.5}, "plain"),
    ("TweedieDevianceScore", {"power": 1.5}, "positive"),
    ("TweedieDevianceScore", {"power": 2.0}, "positive"),
    ("CriticalSuccessIndex", {"threshold": 0.1}, "plain"),
    ("CriticalSuccessIndex", {"threshold": 0.1, "keep_sequence_dim": 0}, "2d"),
    ("PearsonCorrCoef", {}, "plain"),
    ("PearsonCorrCoef", {"num_outputs": 4}, "2d"),
    ("ConcordanceCorrCoef", {}, "plain"),
    ("ConcordanceCorrCoef", {"num_outputs": 4}, "2d"),
    ("SpearmanCorrCoef", {}, "ties"),
    ("KendallRankCorrCoef", {}, "ties"),
    ("KendallRankCorrCoef", {"variant": "a"}, "ties"),
    ("KendallRankCorrCoef", {"variant": "c"}, "ties"),
    ("R2Score", {}, "plain"),
    ("R2Score", {"num_outputs": 4, "multioutput": "raw_values"}, "2d"),
    ("R2Score", {"num_outputs": 4, "adjusted": 2, "multioutput": "variance_weighted"}, "2d"),
    ("ExplainedVariance", {}, "plain"),
    ("ExplainedVariance", {"num_outputs": 4, "multioutput": "raw_values"}, "2d"),
    ("RelativeSquaredError", {}, "plain"),
    ("RelativeSquaredError", {"num_outputs": 4, "squared": False}, "2d"),
    ("KLDivergence", {}, "dist"),
    ("KLDivergence", {"reduction": "none"}, "dist"),
    ("KLDivergence", {"log_prob": True, "reduction": "sum"}, "logdist"),
    ("CosineSimilarity", {"reduction": "mean"}, "2d"),
    ("CosineSimilarity", {"reduction": "none"}, "2d"),
]


@pytest.mark.parametrize(("name", "kw", "kind"), CLASSES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or kind}" for n, kw, kind in CLASSES])
def test_metric_multi_batch_parity(name, kw, kind):
    jm, tm = getattr(jr, name)(**kw), getattr(tr, name)(**kw, device="cpu")
    for seed in range(3):
        a, b = _inputs(kind, 10 + seed)
        jm.update(jnp.asarray(a), jnp.asarray(b))
        tm.update(torch.from_numpy(a), torch.from_numpy(b))
    for leaf, value in tm.metric_state.items():
        want = jm.metric_state[leaf]
        if isinstance(value, tuple):
            assert len(value) == len(want)
        elif not value.dtype.is_floating_point:
            np.testing.assert_array_equal(value.numpy(), np.asarray(want))
            assert str(value.dtype).split(".")[-1] == str(np.asarray(want).dtype)
    _close(tm.compute(), jm.compute())


def test_class_argument_checks():
    with pytest.raises(TorchMetricsUserError):
        tr.MinkowskiDistance(p=0.5, device="cpu")
    with pytest.raises(ValueError, match="power"):
        tr.TweedieDevianceScore(power=0.5, device="cpu")
    with pytest.raises(ValueError, match="multioutput"):
        tr.R2Score(multioutput="mean", device="cpu")
    with pytest.raises(ValueError, match="adjusted"):
        tr.R2Score(adjusted=-1, device="cpu")
    with pytest.raises(ValueError, match="num_outputs"):
        tr.PearsonCorrCoef(num_outputs=0, device="cpu")
    with pytest.raises(TypeError, match="log_prob"):
        tr.KLDivergence(log_prob=1, device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        tr.CosineSimilarity(reduction="max", device="cpu")


# ------------------------------------------------------------------ Pearson's merge
SPLITS = [(1, 199), (50, 150), (17, 60, 123), (100, 1, 99), (3, 3, 3, 191)]


@pytest.mark.parametrize("outputs", [1, 3])
@pytest.mark.parametrize("split", SPLITS, ids=["-".join(map(str, s)) for s in SPLITS])
@pytest.mark.parametrize("name", ["PearsonCorrCoef", "ConcordanceCorrCoef"])
def test_pearson_merge_states_over_uneven_splits(name, split, outputs):
    p, t = _xy(7, (N, outputs) if outputs > 1 else (N,))
    jm, tm = getattr(jr, name)(num_outputs=outputs), getattr(tr, name)(num_outputs=outputs, device="cpu")
    bounds = np.cumsum((0,) + split)
    jstates, tstates = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        jstates.append(jm.update_state(jm.init_state(), jnp.asarray(p[lo:hi]), jnp.asarray(t[lo:hi])))
        tstates.append(tm.update_state(tm.init_state(), torch.from_numpy(p[lo:hi]), torch.from_numpy(t[lo:hi])))
    jmerged, tmerged = jstates[0], tstates[0]
    for js, ts in zip(jstates[1:], tstates[1:]):
        jmerged, tmerged = jm.merge_states(jmerged, js), tm.merge_states(tmerged, ts)
    assert int(tmerged["_n"]) == len(split)
    for leaf in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
        _close(tmerged[leaf], jmerged[leaf])
    _close(tm.compute_state(tmerged), jm.compute_state(jmerged))
    whole = tm.update_state(tm.init_state(), torch.from_numpy(p), torch.from_numpy(t))
    torch.testing.assert_close(tm.compute_state(tmerged), tm.compute_state(whole), rtol=RTOL, atol=ATOL)


def test_pearson_sync_without_a_process_group_is_the_state():
    tm = tr.PearsonCorrCoef(device="cpu")
    p, t = _xy(8)
    state = tm.update_state(tm.init_state(), torch.from_numpy(p), torch.from_numpy(t))
    synced = tm.sync_states(state)
    for leaf, value in state.items():
        assert torch.equal(synced[leaf], value)


@pytest.mark.parametrize("name", ["PearsonCorrCoef", "R2Score", "ExplainedVariance", "MeanAbsoluteError",
                                  "WeightedMeanAbsolutePercentageError", "SpearmanCorrCoef", "KLDivergence"])
def test_state_from_jax_round_trip(name):
    jm, tm = getattr(jr, name)(), getattr(tr, name)(device="cpu")
    kind = "dist" if name == "KLDivergence" else "plain"
    state = jm.init_state()
    for seed in range(2):
        a, b = _inputs(kind, 20 + seed)
        state = jm.update_state(state, jnp.asarray(a), jnp.asarray(b))
    np_state = {k: (list(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v)) for k, v in state.items()}
    carried = state_from_jax(tm, np_state)
    _close(tm.compute_state(carried), jm.compute_state(state))
