"""The port's wrappers, each held against the JAX package's on the same seeded inputs.

Tolerances: values computed from the same integer counts (accuracies, confusion matrices) exactly equal; float32
sums (MSE) within 1e-6 relative; FID within 1e-4 relative and KID within 1e-4 of the terms' scale on the stand-in
extractor (as in ``tests/test_torch_generative.py``); the bootstrap statistics of exactly equal replicates within
1e-6 relative (``std`` and ``quantile`` are float32 reductions of XLA and ATen).
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jcls
import torchmetrics_tpu.image.generative as jimg
import torchmetrics_tpu.regression as jreg
import torchmetrics_tpu.wrappers as jw
from torchmetrics_tpu.collections import MetricCollection as JCollection
import torchmetrics_tpu_torch.classification as tcls
import torchmetrics_tpu_torch.image.generative as timg
import torchmetrics_tpu_torch.regression as treg
import torchmetrics_tpu_torch.wrappers as tw
from torchmetrics_tpu_torch import convert
from torchmetrics_tpu_torch.collections import MetricCollection as TCollection
from torchmetrics_tpu_torch.wrappers.bootstrapping import _bootstrap_sampler as t_sampler
from torchmetrics_tpu.wrappers.bootstrapping import _bootstrap_sampler as j_sampler

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, rtol=0.0, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=0, err_msg=err_msg)


def _multiclass(seed, n=64, c=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, c, n).astype(np.int32), rng.integers(0, c, n).astype(np.int32)


def _regression(seed, n=40, shape=()):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(n, *shape)).astype(np.float32)
    return preds, (preds + 0.3 * rng.normal(size=(n, *shape))).astype(np.float32)


# ------------------------------------------------------------------ WrapperMetric
def test_wrapper_metric_does_not_sync_on_compute():
    base = treg.MeanSquaredError(device=CPU)
    assert tw.Running(base).sync_on_compute is False
    assert jw.Running(jreg.MeanSquaredError()).sync_on_compute is False
    assert tw.Running(base, sync_on_compute=False).device == torch.device(CPU)
    with pytest.raises(ValueError, match="sync_on_compute"):
        tw.Running(base, sync_on_compute=True)


# ------------------------------------------------------------------ BootStrapper
@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("seed", [0, 7])
def test_bootstrap_sampler_is_the_same_draw(strategy, seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for size in (1, 10, 257):
        np.testing.assert_array_equal(t_sampler(size, strategy, a), j_sampler(size, strategy, b))


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("quantile", [None, 0.25, [0.1, 0.5, 0.9]])
def test_bootstrapper_accuracy_replicates_exactly(strategy, quantile):
    kw = dict(num_bootstraps=6, quantile=quantile, raw=True, sampling_strategy=strategy, seed=3)
    jm = jw.BootStrapper(jcls.MulticlassAccuracy(num_classes=5, average="micro"), **kw)
    tm = tw.BootStrapper(tcls.MulticlassAccuracy(num_classes=5, average="micro", device=CPU), **kw)
    for seed in (1, 2, 3):
        preds, target = _multiclass(seed)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    want, got = jm.compute(), tm.compute()
    assert sorted(got) == sorted(want)
    _same(got["raw"], want["raw"], err_msg="raw")  # the same rows: the same counts
    for key in got:
        assert got[key].dtype == torch.float32
        _same(got[key], want[key], rtol=1e-6, err_msg=key)


def test_bootstrapper_regression_forward_and_empty_batch():
    kw = dict(num_bootstraps=4, raw=True, seed=11)
    jm, tm = jw.BootStrapper(jreg.MeanSquaredError(), **kw), tw.BootStrapper(treg.MeanSquaredError(device=CPU), **kw)
    preds, target = _regression(4)
    want, got = jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target))
    for key in want:
        _same(got[key], want[key], rtol=1e-6, err_msg=key)
    # an empty batch updates each replicate as it is, and draws nothing
    jm.update(jnp.zeros((0,), jnp.float32), jnp.zeros((0,), jnp.float32))
    tm.update(torch.zeros((0,)), torch.zeros((0,)))
    preds, target = _regression(5)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _same(tm.compute()["raw"], jm.compute()["raw"], rtol=1e-6)
    tm.reset()
    assert all(m.update_count == 0 for m in tm.metrics)


def test_bootstrapper_checks():
    with pytest.raises(ValueError, match="instance of"):
        tw.BootStrapper(lambda x: x, device=CPU)
    with pytest.raises(ValueError, match="sampling_strategy"):
        tw.BootStrapper(treg.MeanSquaredError(device=CPU), sampling_strategy="bogus")
    with pytest.raises(ValueError, match="Unknown sampling strategy"):
        t_sampler(3, "bogus")


# ------------------------------------------------------------------ ClasswiseWrapper
@pytest.mark.parametrize(("labels", "prefix", "postfix"), [
    (None, None, None), (["a", "b", "c", "d", "e"], None, None), (None, "acc-", None), (None, None, "-x"),
    (["a", "b", "c", "d", "e"], "p_", "_q"),
])
def test_classwise_wrapper(labels, prefix, postfix):
    kw = dict(labels=labels, prefix=prefix, postfix=postfix)
    jm = jw.ClasswiseWrapper(jcls.MulticlassAccuracy(num_classes=5, average=None), **kw)
    tm = tw.ClasswiseWrapper(tcls.MulticlassAccuracy(num_classes=5, average=None, device=CPU), **kw)
    preds, target = _multiclass(8)
    want = jm(jnp.asarray(preds), jnp.asarray(target))
    got = tm(torch.from_numpy(preds), torch.from_numpy(target))
    assert list(got) == list(want)
    preds, target = _multiclass(9)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    want, got = jm.compute(), tm.compute()
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k], err_msg=k)
    assert tm._filter_kwargs(preds=1, bogus=2) == {"preds": 1}
    tm.reset()
    assert tm.metric.update_count == 0


def test_classwise_wrapper_on_the_confusion_matrix_family():
    jm = jw.ClasswiseWrapper(jcls.MulticlassJaccardIndex(num_classes=5, average=None))
    tm = tw.ClasswiseWrapper(tcls.MulticlassJaccardIndex(num_classes=5, average=None, device=CPU))
    for seed in (10, 11):
        preds, target = _multiclass(seed)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    want, got = jm.compute(), tm.compute()
    for k in want:
        _same(got[k], want[k], rtol=1e-6, err_msg=k)


def test_classwise_checks():
    with pytest.raises(ValueError, match="instance of `Metric`"):
        tw.ClasswiseWrapper([1, 2], device=CPU)
    with pytest.raises(ValueError, match="list of strings"):
        tw.ClasswiseWrapper(tcls.MulticlassAccuracy(num_classes=3, average=None, device=CPU), labels=("a", "b"))


# ------------------------------------------------------------------ FeatureShare and NetworkCache
def _stand_in_pair(dim):
    jext = jimg.DeterministicFeatureExtractor(dim=dim, seed=5)
    text = convert.deterministic_features_from_jax([np.asarray(k) for k in jext.kernels], np.asarray(jext.proj),
                                                   device=CPU)
    return jext, text


class _Counted:
    """A network that counts its calls."""

    def __init__(self, net):
        self.net, self.calls = net, 0
        self.num_features = getattr(net, "num_features", None)

    def __call__(self, x):
        self.calls += 1
        return self.net(x)


def _kid_terms_scale(x, y, degree=3, coef=1.0):
    """``(|kt_xx| + |kt_yy|) / (m (m - 1)) + 2 |k_xy| / m^2`` of KID's polynomial kernel over all rows: the MMD
    cancels below it."""
    g, m = 1.0 / x.shape[1], x.shape[0]
    kxx, kyy, kxy = ((a @ b.T * g + coef) ** degree for a, b in ((x, x), (y, y), (x, y)))
    return (abs(kxx.sum() - np.trace(kxx)) + abs(kyy.sum() - np.trace(kyy))) / (m * (m - 1)) + 2 * abs(kxy.sum()) / m**2


def _generative(pkg, ext, n):
    return [pkg.FrechetInceptionDistance(feature=ext, **({} if pkg is jimg else {"device": CPU})),
            pkg.KernelInceptionDistance(feature=ext, subsets=2, subset_size=n,
                                        **({} if pkg is jimg else {"device": CPU})),
            pkg.InceptionScore(feature=ext, splits=2, **({} if pkg is jimg else {"device": CPU}))]


def test_feature_share_one_forward_a_batch_against_jax():
    n = 24
    jext, text = _stand_in_pair(10)
    counted = _Counted(text)
    tfs = tw.FeatureShare(_generative(timg, counted, n), feature_attr="inception")
    jfs = jw.FeatureShare(_generative(jimg, jext, n), feature_attr="inception")
    assert len({id(m.inception) for m in tfs.values()}) == 1 and isinstance(tfs["FrechetInceptionDistance"].inception,
                                                                          tw.NetworkCache)
    assert tfs["KernelInceptionDistance"].inception.max_size == 3
    plain = _generative(timg, text, n)
    rng = np.random.default_rng(20)
    for real in (True, False):
        imgs = rng.integers(0, 256, (n, 3, 32, 32)).astype(np.uint8)
        before = counted.calls
        tfs.update(torch.from_numpy(imgs), real=real)
        assert counted.calls == before + 1  # one forward for the three metrics
        jfs.update(jnp.asarray(imgs), real=real)
        for m in plain:
            m.update(torch.from_numpy(imgs), **({"real": real} if "real" in m._filter_kwargs(real=real) else {}))
    got, want = tfs.compute(), jfs.compute()
    assert list(got) == list(want)
    fid = float(want["FrechetInceptionDistance"])
    assert abs(float(got["FrechetInceptionDistance"]) - fid) <= 1e-4 * abs(fid)
    x, y = (np.concatenate([np.asarray(v, np.float64) for v in jfs["KernelInceptionDistance"].metric_state[k]])
            for k in ("real_features", "fake_features"))
    kid_scale = _kid_terms_scale(x, y)
    assert abs(float(got["KernelInceptionDistance"][0]) - float(want["KernelInceptionDistance"][0])) <= 1e-4 * kid_scale
    for g, w in zip(got["InceptionScore"], want["InceptionScore"]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)
    # the shared network's values are the unshared metrics' bit for bit
    _same(got["FrechetInceptionDistance"], plain[0].compute())
    for g, w in zip(got["KernelInceptionDistance"], plain[1].compute()):
        _same(g, w)
    for g, w in zip(got["InceptionScore"], plain[2].compute()):
        _same(g, w)


def test_feature_share_checks():
    jext, text = _stand_in_pair(8)
    with pytest.raises(AttributeError, match="feature_network"):
        tw.FeatureShare(_generative(timg, text, 4))  # the default attribute: no generative metric has one
    with pytest.raises(AttributeError, match="feature_network"):
        jw.FeatureShare(_generative(jimg, jext, 4))
    with pytest.raises(TypeError, match="max_cache_size"):
        tw.FeatureShare(_generative(timg, text, 4), max_cache_size=2.5, feature_attr="inception")
    with pytest.raises(AttributeError, match="MeanSquaredError"):
        tw.FeatureShare([timg.FrechetInceptionDistance(feature=text, device=CPU), treg.MeanSquaredError(device=CPU)],
                        feature_attr="inception")


def test_network_cache_collision_rule_and_eviction():
    """Two inputs of one shape and dtype whose 16 strided values agree share an entry, in both packages; the
    oldest entry goes first."""
    calls = {"t": 0, "j": 0}

    def t_net(x):
        calls["t"] += 1
        return x.sum()

    def j_net(x):
        calls["j"] += 1
        return x.sum()

    tc, jc = tw.NetworkCache(t_net, max_size=2), jw.NetworkCache(j_net, max_size=2)
    a = np.zeros((64,), np.float32)
    b = a.copy()
    b[1] = 5.0  # between the sampled positions 0, 4, 8, ...
    c = a.copy()
    c[4] = 5.0  # a sampled position
    for cache, conv in ((tc, torch.from_numpy), (jc, jnp.asarray)):
        first = cache(conv(a))
        assert float(cache(conv(b))) == float(first) == 0.0  # a collision: b's own sum is 5
        assert float(cache(conv(c))) == 5.0
        cache(conv(a.reshape(8, 8)))  # another shape: a new entry, the oldest (a) evicted
        cache(conv(a))
    assert calls == {"t": 4, "j": 4}
    assert tc._key(torch.from_numpy(a), 3)[1] == 3  # non-array arguments are part of the key as they are


# ------------------------------------------------------------------ MinMaxMetric
def test_minmax_metric_on_tensor_values():
    jm, tm = jw.MinMaxMetric(jcls.BinaryAccuracy()), tw.MinMaxMetric(tcls.BinaryAccuracy(device=CPU))
    rng = np.random.default_rng(30)
    for step in range(4):
        preds = rng.uniform(size=20).astype(np.float32)
        target = rng.integers(0, 2, 20).astype(np.int32)
        want = jm(jnp.asarray(preds), jnp.asarray(target))
        got = tm(torch.from_numpy(preds), torch.from_numpy(target))
        assert sorted(got) == ["max", "min", "raw"]
        for key in want:
            _same(got[key], want[key], err_msg=f"{key} at step {step}")
        assert got["min"].dtype == torch.float32 and got["min"].device == torch.device(CPU)
    assert tw.MinMaxMetric._is_suitable_val(torch.tensor(0.5)) and tw.MinMaxMetric._is_suitable_val(torch.ones(1))
    assert not tw.MinMaxMetric._is_suitable_val(torch.ones(2)) and tw.MinMaxMetric._is_suitable_val(3)
    assert tw.MinMaxMetric._is_suitable_val(np.float32(1.0)) and not tw.MinMaxMetric._is_suitable_val("1")
    tm.reset()
    assert tm.min_val == float("inf") and tm.max_val == float("-inf")


def test_minmax_metric_refuses_a_vector():
    jm = jw.MinMaxMetric(jcls.MulticlassAccuracy(num_classes=3, average=None))
    tm = tw.MinMaxMetric(tcls.MulticlassAccuracy(num_classes=3, average=None, device=CPU))
    preds, target = _multiclass(31, c=3)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    with pytest.raises(RuntimeError, match="scalar tensor"):
        jm.compute()
    with pytest.raises(RuntimeError, match="scalar tensor"):
        tm.compute()
    with pytest.raises(ValueError, match="instance of `Metric`"):
        tw.MinMaxMetric(3, device=CPU)


# ------------------------------------------------------------------ MultioutputWrapper
@pytest.mark.parametrize("remove_nans", [True, False])
@pytest.mark.parametrize("output_dim", [-1, 1, 0])
def test_multioutput_with_nan_rows(remove_nans, output_dim):
    preds, target = _regression(40, n=12, shape=(3,))
    preds[2, 0] = np.nan
    target[5, 2] = np.nan
    if output_dim == 0:
        preds, target = preds.T.copy(), target.T.copy()
    kw = dict(num_outputs=3, output_dim=output_dim, remove_nans=remove_nans)
    jm, tm = jw.MultioutputWrapper(jreg.MeanSquaredError(), **kw), tw.MultioutputWrapper(
        treg.MeanSquaredError(device=CPU), **kw)
    if output_dim == 0 and remove_nans:
        # the sliced (1, 12) input is one row: a NaN drops it, and the squeeze of the empty dim raises in both
        with pytest.raises(ValueError, match="squeeze"):
            jm(jnp.asarray(preds), jnp.asarray(target))
        with pytest.raises(ValueError, match="squeeze"):
            tm(torch.from_numpy(preds), torch.from_numpy(target))
        preds, target = (np.nan_to_num(x) for x in (preds, target))
    want = jm(jnp.asarray(preds), jnp.asarray(target))
    got = tm(torch.from_numpy(preds), torch.from_numpy(target))
    _same(got, want, rtol=1e-6)
    preds2, target2 = _regression(41, n=7, shape=(3,))
    if output_dim == 0:
        preds2, target2 = preds2.T.copy(), target2.T.copy()
    jm.update(jnp.asarray(preds2), jnp.asarray(target2))
    tm.update(torch.from_numpy(preds2), torch.from_numpy(target2))
    _same(tm.compute(), jm.compute(), rtol=1e-6)
    tm.reset()
    assert all(m.update_count == 0 for m in tm.metrics)


def test_multioutput_squeeze_and_classification():
    kw = dict(num_outputs=2, squeeze_outputs=True)
    jm = jw.MultioutputWrapper(jcls.BinaryAccuracy(), **kw)
    tm = tw.MultioutputWrapper(tcls.BinaryAccuracy(device=CPU), **kw)
    rng = np.random.default_rng(42)
    preds, target = rng.uniform(size=(30, 2)).astype(np.float32), rng.integers(0, 2, (30, 2)).astype(np.int32)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _same(tm.compute(), jm.compute())


def test_multioutput_three_dim_input_raises_as_in_jax():
    preds = np.random.default_rng(43).normal(size=(6, 4, 2)).astype(np.float32)
    jm = jw.MultioutputWrapper(jreg.MeanSquaredError(), num_outputs=2)
    tm = tw.MultioutputWrapper(treg.MeanSquaredError(device=CPU), num_outputs=2)
    with pytest.raises(ValueError, match="out of bounds"):
        jm.update(jnp.asarray(preds), jnp.asarray(preds))
    with pytest.raises(ValueError, match="out of bounds"):
        tm.update(torch.from_numpy(preds), torch.from_numpy(preds))
    # without the NaN mask, the 3-D slices go through
    jm, tm = (w(m, num_outputs=2, remove_nans=False) for w, m in ((jw.MultioutputWrapper, jreg.MeanSquaredError()),
                                                                  (tw.MultioutputWrapper,
                                                                   treg.MeanSquaredError(device=CPU))))
    jm.update(jnp.asarray(preds), jnp.asarray(preds * 0.5))
    tm.update(torch.from_numpy(preds), torch.from_numpy(preds * 0.5))
    _same(tm.compute(), jm.compute(), rtol=1e-6)


def test_multioutput_functional_state_surface():
    kw = dict(num_outputs=3, remove_nans=False)
    jm, tm = jw.MultioutputWrapper(jreg.MeanSquaredError(), **kw), tw.MultioutputWrapper(
        treg.MeanSquaredError(device=CPU), **kw)
    js, ts = jm.init_state(), tm.init_state()
    assert sorted(ts) == sorted(js) == ["0", "1", "2"]
    parts = [_regression(s, n=9, shape=(3,)) for s in (50, 51)]
    jb = [jm.update_state(jm.init_state(), jnp.asarray(p), jnp.asarray(t)) for p, t in parts]
    tb = [tm.update_state(tm.init_state(), torch.from_numpy(p), torch.from_numpy(t)) for p, t in parts]
    _same(tm.compute_state(tm.merge_states(*tb)), jm.compute_state(jm.merge_states(*jb)), rtol=1e-6)
    with pytest.raises(ValueError, match="cannot drop NaN rows"):
        tw.MultioutputWrapper(treg.MeanSquaredError(device=CPU), num_outputs=3).update_state(
            ts, torch.from_numpy(parts[0][0]), torch.from_numpy(parts[0][1]))


# ------------------------------------------------------------------ MultitaskWrapper
def _tasks(pkg_cls, pkg_reg, coll, **dev):
    return {"cls": pkg_cls.BinaryAccuracy(**dev), "reg": pkg_reg.MeanSquaredError(**dev),
            "both": coll([pkg_reg.MeanSquaredError(**dev), pkg_reg.MeanAbsoluteError(**dev)])}


def _task_inputs(seed):
    rng = np.random.default_rng(seed)
    preds = {"cls": rng.uniform(size=16).astype(np.float32), "reg": rng.normal(size=16).astype(np.float32),
             "both": rng.normal(size=16).astype(np.float32)}
    target = {"cls": rng.integers(0, 2, 16).astype(np.int32), "reg": rng.normal(size=16).astype(np.float32),
              "both": rng.normal(size=16).astype(np.float32)}
    return preds, target


def _flat(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


@pytest.mark.parametrize(("prefix", "postfix"), [(None, None), ("val_", None), (None, "_step"), ("a/", "/b")])
def test_multitask_wrapper(prefix, postfix):
    jm = jw.MultitaskWrapper(_tasks(jcls, jreg, JCollection), prefix=prefix, postfix=postfix)
    tm = tw.MultitaskWrapper(_tasks(tcls, treg, TCollection, device=CPU), prefix=prefix, postfix=postfix)
    preds, target = _task_inputs(60)
    conv_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    conv_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    want, got = _flat(jm(conv_j(preds), conv_j(target))), _flat(tm(conv_t(preds), conv_t(target)))
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k], rtol=1e-6, err_msg=k)
    preds, target = _task_inputs(61)
    jm.update(conv_j(preds), conv_j(target))
    tm.update(conv_t(preds), conv_t(target))
    want, got = _flat(jm.compute()), _flat(tm.compute())
    for k in want:
        _same(got[k], want[k], rtol=1e-6, err_msg=k)
    clone_j, clone_t = jm.clone(prefix="c_", postfix="_d"), tm.clone(prefix="c_", postfix="_d")
    assert list(clone_t.compute()) == list(clone_j.compute())
    assert list(tm.keys()) == ["cls", "reg", "both"] and tm.clone() is not tm
    with pytest.raises(ValueError, match="same keys"):
        tm.update({"cls": torch.zeros(2)}, {"cls": torch.zeros(2)})
    tm.reset()
    assert tm.task_metrics["cls"].update_count == 0


def test_multitask_checks():
    with pytest.raises(TypeError, match="to be a dict"):
        tw.MultitaskWrapper([treg.MeanSquaredError(device=CPU)])
    with pytest.raises(TypeError, match="Metric or a MetricCollection"):
        tw.MultitaskWrapper({"a": 3}, device=CPU)


# ------------------------------------------------------------------ Running
@pytest.mark.parametrize("window", [1, 2, 3])
def test_running_window(window):
    jm, tm = jw.Running(jreg.MeanSquaredError(), window=window), tw.Running(treg.MeanSquaredError(device=CPU),
                                                                           window=window)
    _same(tm.compute(), jm.compute())  # nothing seen: the base metric's empty state
    for seed in range(5):
        preds, target = _regression(70 + seed, n=8)
        want = jm(jnp.asarray(preds), jnp.asarray(target)) if seed % 2 else jm.update(jnp.asarray(preds),
                                                                                     jnp.asarray(target))
        got = tm(torch.from_numpy(preds), torch.from_numpy(target)) if seed % 2 else tm.update(
            torch.from_numpy(preds), torch.from_numpy(target))
        if seed % 2:
            _same(got, want, rtol=1e-6, err_msg=f"forward {seed}")
        assert len(tm._batch_states) == min(seed + 1, window)
        _same(tm.compute(), jm.compute(), rtol=1e-6, err_msg=f"compute {seed}")
    tm.reset()
    assert tm._batch_states == [] and tm.base_metric.update_count == 0


def test_running_on_an_in_place_leaf():
    """The multiclass confusion matrix adds into its state in place: each window entry is its own."""
    jm = jw.Running(jcls.MulticlassConfusionMatrix(num_classes=4), window=2)
    tm = tw.Running(tcls.MulticlassConfusionMatrix(num_classes=4, device=CPU), window=2)
    for seed in range(4):
        preds, target = _multiclass(80 + seed, n=30, c=4)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
        _same(tm.compute(), jm.compute(), err_msg=f"step {seed}")


def test_running_checks():
    class FullUpdate(treg.MeanSquaredError):
        full_state_update = True

    class JFullUpdate(jreg.MeanSquaredError):
        full_state_update = True

    with pytest.raises(ValueError, match="full_state_update"):
        jw.Running(JFullUpdate())
    with pytest.raises(ValueError, match="full_state_update"):
        tw.Running(FullUpdate(device=CPU))
    for bad in (0, -2, 1.5):
        with pytest.raises(ValueError, match="positive integer"):
            tw.Running(treg.MeanSquaredError(device=CPU), window=bad)
    with pytest.raises(ValueError, match="instance of `Metric`"):
        tw.Running("mse", device=CPU)


# ------------------------------------------------------------------ MetricTracker
def _tracked_steps(jt, tt, values):
    """One step a value: MSE of preds 0 against a target whose mean square is the value (NaN for a NaN)."""
    for v in values:
        jt.increment()
        tt.increment()
        target = np.full(4, np.sqrt(v) if np.isfinite(v) else np.nan, np.float32)
        jt.update(jnp.zeros(4, jnp.float32), jnp.asarray(target))
        tt.update(torch.zeros(4), torch.from_numpy(target))


@pytest.mark.parametrize("values", [
    [0.5, 0.2, 0.9, 0.1], [0.5, 0.9, 0.9, 0.2], [0.3, 0.1, 0.3, 0.1], [0.4, np.nan, 0.2, np.nan], [np.nan, 0.1],
])
@pytest.mark.parametrize("maximize", [True, False])
def test_tracker_best_step_with_nan_and_ties(values, maximize):
    jt, tt = jw.MetricTracker(jreg.MeanSquaredError(), maximize=maximize), tw.MetricTracker(
        treg.MeanSquaredError(device=CPU), maximize=maximize)
    _tracked_steps(jt, tt, values)
    _same(tt.compute_all(), jt.compute_all(), rtol=1e-6)
    want_v, want_i = jt.best_metric(return_step=True)
    got_v, got_i = tt.best_metric(return_step=True)
    assert got_i == want_i, (values, maximize)
    _same(got_v, want_v, rtol=1e-6)
    _same(tt.best_metric(), jt.best_metric(), rtol=1e-6)
    assert tt.n_steps == len(values)


def test_tracker_collection_with_a_maximize_list():
    make = lambda pkg, **dev: [pkg.MeanSquaredError(**dev), pkg.MeanAbsoluteError(**dev)]  # noqa: E731
    jt = jw.MetricTracker(JCollection(make(jreg)), maximize=[False, True])
    tt = tw.MetricTracker(TCollection(make(treg, device=CPU)), maximize=[False, True])
    for seed in range(3):
        preds, target = _regression(90 + seed, n=10)
        jt.increment()
        tt.increment()
        want, got = jt(jnp.asarray(preds), jnp.asarray(target)), tt(torch.from_numpy(preds), torch.from_numpy(target))
        for k in want:
            _same(got[k], want[k], rtol=1e-6, err_msg=k)
    want_best, want_steps = jt.best_metric(return_step=True)
    got_best, got_steps = tt.best_metric(return_step=True)
    assert got_steps == want_steps
    for k in want_best:
        _same(got_best[k], want_best[k], rtol=1e-6, err_msg=k)
    for k, v in jt.compute_all().items():
        _same(tt.compute_all()[k], v, rtol=1e-6, err_msg=k)


def test_tracker_checks_and_reset():
    tt = tw.MetricTracker(treg.MeanSquaredError(device=CPU))
    for method in ("update", "compute", "compute_all"):
        with pytest.raises(ValueError, match="increment"):
            getattr(tt, method)() if method != "update" else tt.update(torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="increment"):
        tt(torch.zeros(2), torch.zeros(2))
    with pytest.raises(TypeError, match="Metric"):
        tw.MetricTracker(3, device=CPU)
    with pytest.raises(ValueError, match="single bool or list of bool"):
        tw.MetricTracker(treg.MeanSquaredError(device=CPU), maximize=[True, 1])
    tt.increment()
    tt.update(torch.ones(2), torch.zeros(2))
    tt.reset()
    assert tt._history[-1].update_count == 0
    tt.reset_all()
    assert tt.n_steps == 0 and not tt._increment_called
    # a value that has no best step warns and gives None, in both packages
    jt = jw.MetricTracker(jcls.MulticlassAccuracy(num_classes=3, average=None))
    tt = tw.MetricTracker(tcls.MulticlassAccuracy(num_classes=3, average=None, device=CPU))
    preds, target = _multiclass(95, c=3)
    for t in (jt, tt):
        t.increment()
        t.update(*(conv(x) for conv, x in zip((jnp.asarray, jnp.asarray) if t is jt else
                                               (torch.from_numpy, torch.from_numpy), (preds, target))))
    want_v, want_i = jt.best_metric(return_step=True)
    got_v, got_i = tt.best_metric(return_step=True)
    assert got_i == want_i
    _same(got_v, want_v)


# ------------------------------------------------------------------ input transformers
def test_binary_target_transformer_gives_int32():
    jm = jw.BinaryTargetTransformer(jcls.BinaryAccuracy(), threshold=0.5)
    tm = tw.BinaryTargetTransformer(tcls.BinaryAccuracy(device=CPU), threshold=0.5)
    rng = np.random.default_rng(100)
    preds, target = rng.uniform(size=25).astype(np.float32), rng.uniform(size=25).astype(np.float32)
    assert tm.transform_target(torch.from_numpy(target)).dtype == torch.int32
    assert jm.transform_target(jnp.asarray(target)).dtype == jnp.int32
    _same(tm.transform_target(torch.from_numpy(target)), jm.transform_target(jnp.asarray(target)))
    _same(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)))
    jm.update(jnp.asarray(preds[:10]), jnp.asarray(target[:10]))
    tm.update(torch.from_numpy(preds[:10]), torch.from_numpy(target[:10]))
    _same(tm.compute(), jm.compute())
    with pytest.raises(TypeError, match="threshold"):
        tw.BinaryTargetTransformer(tcls.BinaryAccuracy(device=CPU), threshold="0.5")


def test_lambda_input_transformer():
    jm = jw.LambdaInputTransformer(jreg.MeanSquaredError(), transform_pred=lambda p: p * 2,
                                   transform_target=lambda t: t - 1)
    tm = tw.LambdaInputTransformer(treg.MeanSquaredError(device=CPU), transform_pred=lambda p: p * 2,
                                   transform_target=lambda t: t - 1)
    preds, target = _regression(101)
    _same(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)),
          rtol=1e-6)
    plain = tw.LambdaInputTransformer(treg.MeanSquaredError(device=CPU))
    assert plain.transform_pred(3) == 3 and plain.transform_target(4) == 4
    tm.reset()
    assert tm.wrapped_metric.update_count == 0
    with pytest.raises(TypeError, match="callable"):
        tw.LambdaInputTransformer(treg.MeanSquaredError(device=CPU), transform_pred=3)
    with pytest.raises(TypeError, match="callable"):
        tw.LambdaInputTransformer(treg.MeanSquaredError(device=CPU), transform_target="t")
    with pytest.raises(TypeError, match="instance of `Metric`"):
        tw.MetricInputTransformer(None, device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tw.MetricInputTransformer(treg.MeanSquaredError(device=CPU))
