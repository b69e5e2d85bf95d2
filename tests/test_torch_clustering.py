"""Parity of the port's clustering metrics with the JAX package.

The same seeded numpy labels and embeddings go through both packages; the
port runs on the CPU, where the contingency matrix is the plain version of
the ``confmat_multiclass`` kernel and the centroid distances of
Davies-Bouldin and Dunn the plain version of ``pairwise_lp`` (``chip_smoke.py``
holds both kernels against them on the card).

Tolerances: contingency matrices (float32 counts) equal; scores within 1e-5
relative and 1e-6 absolute (float32 sums in another order than XLA's; the
per-cluster sums are ``index_add_`` where JAX takes a one-hot product),
except the adjusted mutual information. AMI's E[MI] sums float32 terms of
size n log n that cancel (``gammaln`` of values up to n, each off by
float32's rounding, then ``exp``), so two float32 evaluations drift apart,
even at a few hundred labels: on the 100 seeded small sets of
``test_adjusted_mutual_info_small_sets_against_float64`` (200 to 2,000
labels) the port and JAX lie up to 8.9e-5 relative apart (200 labels of
20 x 20 clusters; 3.2e-5 at 2,000 labels of 10). So both packages are held
against a float64 evaluation written here (numpy and
``scipy.special.gammaln``), half the predictions right, within the bound
measured there: at most 2,000 labels 2e-5 (the port lay at most 1.03e-5
from it, JAX 1.57e-5); at 20,000 labels of 100 clusters the port lies
9.1e-5 from it and JAX 5.3e-4; at 50,000 of 300, 6.8e-4 and 3.2e-3 (bounds
2e-4 / 1e-3 and 1.5e-3 / 6e-3).
"""

import importlib
import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

import torchmetrics_tpu.clustering as jc
import torchmetrics_tpu.functional.clustering as jfc
import torchmetrics_tpu_torch.clustering as tc
import torchmetrics_tpu_torch.functional.clustering as tfc
from torchmetrics_tpu_torch.convert import state_from_jax

jutils = importlib.import_module("torchmetrics_tpu.functional.clustering.utils")
tutils = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.utils")

CPU = {"device": "cpu"}
TOL = (1e-5, 1e-6)
EXTRINSIC = ["mutual_info_score", "adjusted_mutual_info_score", "normalized_mutual_info_score", "rand_score",
             "adjusted_rand_score", "fowlkes_mallows_index", "homogeneity_score", "completeness_score",
             "v_measure_score"]
INTRINSIC = ["calinski_harabasz_score", "davies_bouldin_score", "dunn_index"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol[0], atol=tol[1],
                               equal_nan=True)


def _labels(seed, n=500, k_target=8, k_pred=6, agree=0.5, offset=0):
    """Seeded labels: the prediction equal to the target (mod its cluster count) on ``agree`` of the rows;
    ``offset`` shifts the ids (negative, not contiguous)."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, k_target, size=n)
    preds = np.where(rng.random(n) < agree, target % k_pred, rng.integers(0, k_pred, size=n))
    return (3 * preds + offset).astype(np.int32), (5 * target + offset).astype(np.int32)


def _data(seed, n=300, d=12, k=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, size=n)
    centres = rng.normal(scale=4.0, size=(k, d))
    return (centres[labels] + rng.normal(size=(n, d))).astype(np.float32), labels.astype(np.int32)


# ----------------------------------------------------------------- utils
@pytest.mark.parametrize("offset", [0, -40])
@pytest.mark.parametrize("shape", [(500, 8, 6), (300, 3, 11), (40, 1, 1)])
def test_contingency_matrix_equals_jax(offset, shape):
    n, kt, kp = shape
    preds, target = _labels(1, n, kt, kp, offset=offset)
    got = tfc.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfc.calculate_contingency_matrix(jnp.asarray(preds),
                                                                                            jnp.asarray(target))))


def test_contingency_matrix_of_float_labels():
    preds, target = _labels(2)
    p, t = preds.astype(np.float32) / 2, target.astype(np.float32) - 0.5
    np.testing.assert_array_equal(tfc.calculate_contingency_matrix(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
                                  np.asarray(jfc.calculate_contingency_matrix(jnp.asarray(p), jnp.asarray(t))))


def _recording_accumulate(monkeypatch):
    """Wrap the kernel's dispatch in ``tutils``; return the list of the state shapes it is given."""
    shapes, accumulate = [], tutils._multiclass_confmat_accumulate

    def record(state, preds, target, ignore_index):
        shapes.append(tuple(state.shape))
        return accumulate(state, preds, target, ignore_index)

    monkeypatch.setattr(tutils, "_multiclass_confmat_accumulate", record)
    return shapes


def test_contingency_matrix_past_46341_ids(monkeypatch):
    """50,000 predicted clusters against 3 classes: a square table of side max(kt, kp) would need C*C past the
    kernel's int32 cells (C > 46,340); the rectangular table of 150,000 cells goes in one state of side 388."""
    n, kt = 50_000, 3
    rng = np.random.default_rng(5)
    preds = rng.permutation(n).astype(np.int32) - 7
    target = rng.integers(0, kt, size=n).astype(np.int32)
    shapes = _recording_accumulate(monkeypatch)
    got = tfc.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    want = np.zeros((kt, n), dtype=np.float32)
    np.add.at(want, (target, np.argsort(np.argsort(preds))), 1.0)
    assert got.dtype == torch.float32 and got.shape == (kt, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert shapes == [(388, 388)] and 388 * 388 >= kt * n > 387 * 387


@pytest.mark.parametrize("cells_a_launch", [1, 7, 19, 20, 47, 48])
def test_contingency_matrix_in_slices_equals_jax(monkeypatch, cells_a_launch):
    """A table of more than ``_TABLE_CELLS`` cells goes in slices, a launch each, the pairs of other slices
    dropped: here a 6 x 8 table (48 cells) in slices of a few cells."""
    preds, target = _labels(3, 400, 6, 8, offset=-3)
    monkeypatch.setattr(tutils, "_TABLE_CELLS", cells_a_launch)
    shapes = _recording_accumulate(monkeypatch)
    got = tfc.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfc.calculate_contingency_matrix(jnp.asarray(preds),
                                                                                            jnp.asarray(target))))
    sizes = [min(cells_a_launch, 48 - start) for start in range(0, 48, cells_a_launch)]
    assert shapes == [(math.isqrt(size - 1) + 1,) * 2 for size in sizes]


@pytest.mark.parametrize("p", ["min", "geometric", "arithmetic", "max", 1, 2, 3, 0.5, -1.5])
def test_entropy_generalized_mean_and_pair_counts(p):
    preds, target = _labels(3)
    _close(tfc.calculate_entropy(torch.from_numpy(target)), jfc.calculate_entropy(jnp.asarray(target)))
    x = np.array([0.4, 1.7], np.float32)
    _close(tfc.calculate_generalized_mean(torch.from_numpy(x), p), jfc.calculate_generalized_mean(jnp.asarray(x), p))
    table = np.asarray(jfc.calculate_contingency_matrix(jnp.asarray(preds), jnp.asarray(target)))
    for got, want in zip(tutils._pair_counts(torch.from_numpy(table.copy())), jutils._pair_counts(jnp.asarray(table))):
        _close(got, want)


# ----------------------------------------------------------------- extrinsic
@pytest.mark.parametrize("name", EXTRINSIC)
@pytest.mark.parametrize("case", [(500, 8, 6, 0), (2000, 10, 10, -7), (300, 1, 4, 0), (300, 4, 1, 0), (60, 1, 1, 5)])
def test_extrinsic_against_jax(name, case):
    n, kt, kp, offset = case
    preds, target = _labels(4, n, kt, kp, offset=offset)
    got = getattr(tfc, name)(torch.from_numpy(preds), torch.from_numpy(target))
    want = getattr(jfc, name)(jnp.asarray(preds), jnp.asarray(target))
    if name == "adjusted_mutual_info_score" and min(kt, kp) > 1:
        _close_ami(got, want, preds, target)
    else:
        _close(got, want)


@pytest.mark.parametrize("average_method", ["min", "geometric", "arithmetic", "max"])
def test_average_methods_and_beta(average_method):
    preds, target = _labels(5)
    _close_ami(tfc.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target), average_method),
               jfc.adjusted_mutual_info_score(jnp.asarray(preds), jnp.asarray(target), average_method), preds, target,
               average_method)
    _close(tfc.normalized_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target), average_method),
           jfc.normalized_mutual_info_score(jnp.asarray(preds), jnp.asarray(target), average_method))
    _close(tfc.v_measure_score(torch.from_numpy(preds), torch.from_numpy(target), beta=0.5),
           jfc.v_measure_score(jnp.asarray(preds), jnp.asarray(target), beta=0.5))


def test_expected_mutual_info_against_float64():
    """E[MI] alone: both float32 evaluations within 1e-5 of float64 (here the port lies 4.22e-6 from it and
    JAX 6.37e-6, the two 1.33e-4 relative apart)."""
    preds, target = _labels(6, 1500, 9, 7)
    table = np.array(jfc.calculate_contingency_matrix(jnp.asarray(preds), jnp.asarray(target)))
    want = _emi_float64(table.astype(np.float64))
    got = float(tfc.expected_mutual_info_score(torch.from_numpy(table), 1500))
    jax_value = float(jfc.expected_mutual_info_score(jnp.asarray(table), 1500))
    assert abs(got - want) <= 1e-5 and abs(jax_value - want) <= 1e-5, (got, jax_value, want)


def _table_float64(preds: np.ndarray, target: np.ndarray) -> np.ndarray:
    _, pi = np.unique(preds, return_inverse=True)
    _, ti = np.unique(target, return_inverse=True)
    c = np.zeros((ti.max() + 1, pi.max() + 1))
    np.add.at(c, (ti, pi), 1.0)
    return c


def _emi_float64(c: np.ndarray) -> float:
    """E[MI] in float64, term by term, ``scipy.special.gammaln`` for the hypergeometric pmf."""
    n, emi = c.sum(), 0.0
    for ai in c.sum(1):
        for bj in c.sum(0):
            k = np.arange(max(1.0, ai + bj - n), min(ai, bj) + 1)
            log_p = (gammaln(ai + 1) + gammaln(bj + 1) + gammaln(n - ai + 1) + gammaln(n - bj + 1) - gammaln(n + 1)
                     - gammaln(k + 1) - gammaln(ai - k + 1) - gammaln(bj - k + 1) - gammaln(n - ai - bj + k + 1))
            emi += np.sum(k / n * (np.log(n) + np.log(k) - np.log(ai) - np.log(bj)) * np.exp(log_p))
    return emi


def _ami_float64(preds: np.ndarray, target: np.ndarray, average_method: str = "arithmetic") -> float:
    """AMI in float64: the contingency, MI, both entropies and E[MI] summed term by term."""
    c = _table_float64(preds, target)
    n, a, b = c.sum(), c.sum(1), c.sum(0)
    nz = c > 0
    mi = np.sum(c[nz] / n * np.log(n * c[nz] / np.outer(a, b)[nz]))

    def entropy(x):
        x = x[x > 0] / n
        return -np.sum(x * np.log(x))

    h = np.array([entropy(b), entropy(a)])
    mean = {"min": h.min(), "max": h.max(), "arithmetic": h.mean(), "geometric": np.exp(np.log(h).mean())}
    emi = _emi_float64(c)
    return (mi - emi) / (mean[average_method] - emi)


AMI_SMALL_BOUND = 2e-5  # |AMI - float64| at most 2,000 labels (test_adjusted_mutual_info_small_sets_against_float64)
SMALL_SETS = [(200, 20, 20), (300, 3, 11), (500, 8, 6), (1500, 9, 7), (2000, 10, 10)]


def _close_ami(got, want, preds, target, average_method="arithmetic"):
    """AMI at most 2,000 labels: both packages within ``AMI_SMALL_BOUND`` of the float64 evaluation."""
    ref = _ami_float64(preds, target, average_method)
    assert abs(float(got) - ref) <= AMI_SMALL_BOUND and abs(float(want) - ref) <= AMI_SMALL_BOUND, (got, want, ref)


@pytest.mark.parametrize(("n", "k", "port_bound", "jax_bound"), [(20_000, 100, 2e-4, 1e-3),
                                                                 (50_000, 300, 1.5e-3, 6e-3)])
def test_adjusted_mutual_info_against_float64(n, k, port_bound, jax_bound):
    preds, target = _labels(n, n, k, k)
    want = _ami_float64(preds, target)
    port = float(tfc.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target)))
    jax_value = float(jfc.adjusted_mutual_info_score(jnp.asarray(preds), jnp.asarray(target)))
    assert abs(port - want) <= port_bound, (port, want)
    assert abs(jax_value - want) <= jax_bound, (jax_value, want)


@pytest.mark.parametrize("shape", SMALL_SETS, ids=str)
@pytest.mark.parametrize("seed", range(20))
def test_adjusted_mutual_info_small_sets_against_float64(shape, seed):
    preds, target = _labels(seed, *shape)
    _close_ami(tfc.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target)),
               jfc.adjusted_mutual_info_score(jnp.asarray(preds), jnp.asarray(target)), preds, target)


def test_extrinsic_errors_as_jax():
    x = np.zeros(4, np.int32)
    cases = [("mutual_info_score", (x[None], x[None])), ("rand_score", (x, x[:3])),
             ("adjusted_mutual_info_score", (x, x), {"average_method": "median"})]
    for name, args, *kw in cases:
        kwargs = kw[0] if kw else {}
        with pytest.raises(ValueError) as want:
            getattr(jfc, name)(*map(jnp.asarray, args), **kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tfc, name)(*map(torch.from_numpy, args), **kwargs)
        assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- intrinsic
@pytest.mark.parametrize("name", INTRINSIC)
@pytest.mark.parametrize("case", ["clusters", "labels not contiguous", "one cluster", "single points"])
def test_intrinsic_against_jax(name, case):
    data, labels = _data(7)
    if case == "labels not contiguous":
        labels = 7 * labels - 20
    elif case == "one cluster":
        labels = np.zeros_like(labels)
    elif case == "single points":
        data, labels = data[:6], np.arange(6, dtype=np.int32)
    _close(getattr(tfc, name)(torch.from_numpy(data), torch.from_numpy(labels)),
           getattr(jfc, name)(jnp.asarray(data), jnp.asarray(labels)))


@pytest.mark.parametrize("p", [1, 2, 3, 1.5, 2.0])
def test_dunn_index_exponents_against_jax(p):
    data, labels = _data(8, k=7)
    _close(tfc.dunn_index(torch.from_numpy(data), torch.from_numpy(labels), p),
           jfc.dunn_index(jnp.asarray(data), jnp.asarray(labels), p))


def test_intrinsic_errors_as_jax():
    data, labels = _data(9)
    for args in ((data[0], labels), (data, labels[:-1]), (data, labels[None])):
        with pytest.raises(ValueError) as want:
            jfc.calinski_harabasz_score(*map(jnp.asarray, args))
        with pytest.raises(ValueError) as got:
            tfc.calinski_harabasz_score(*map(torch.from_numpy, args))
        assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- classes
EXTRINSIC_CLASSES = {
    "MutualInfoScore": {}, "AdjustedMutualInfoScore": {}, "AdjustedMutualInfoScore-max": {"average_method": "max"},
    "NormalizedMutualInfoScore": {}, "NormalizedMutualInfoScore-geometric": {"average_method": "geometric"},
    "RandScore": {}, "AdjustedRandScore": {}, "FowlkesMallowsIndex": {}, "HomogeneityScore": {},
    "CompletenessScore": {}, "VMeasureScore": {}, "VMeasureScore-beta": {"beta": 2.0},
}
INTRINSIC_CLASSES = {"CalinskiHarabaszScore": {}, "DaviesBouldinScore": {}, "DunnIndex": {}, "DunnIndex-p1": {"p": 1}}


def _state_np(metric):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v))
            for k, v in metric.metric_state.items()}


def _check_class(name, kwargs, batches):
    jm, tm = getattr(jc, name)(**kwargs), getattr(tc, name)(**kwargs, **CPU)
    for batch in batches[:2]:
        jm.update(*map(jnp.asarray, batch))
        tm.update(*map(torch.from_numpy, batch))
    want_state = _state_np(jm)
    for leaf, want in want_state.items():
        got = tm.metric_state[leaf]
        if isinstance(want, list):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert _np(g).dtype == w.dtype, leaf
                np.testing.assert_array_equal(_np(g), w)
    carried = getattr(tc, name)(**kwargs, **CPU)
    carried._state = state_from_jax(carried, want_state)
    _close(tm(*map(torch.from_numpy, batches[2])), jm(*map(jnp.asarray, batches[2])))
    carried.update(*map(torch.from_numpy, batches[2]))
    _close(tm.compute(), jm.compute())
    _close(carried.compute(), jm.compute())


@pytest.mark.parametrize("key", sorted(EXTRINSIC_CLASSES))
def test_extrinsic_classes(key):
    batches = [_labels(20 + b, n=150) for b in range(3)]
    _check_class(key.split("-")[0], EXTRINSIC_CLASSES[key], batches)


@pytest.mark.parametrize("key", sorted(INTRINSIC_CLASSES))
def test_intrinsic_classes(key):
    batches = [_data(30 + b, n=80) for b in range(3)]
    _check_class(key.split("-")[0], INTRINSIC_CLASSES[key], batches)


def test_class_errors_and_pickle():
    for cls, kwargs in [("VMeasureScore", {"beta": 1}), ("AdjustedMutualInfoScore", {"average_method": "x"})]:
        with pytest.raises(ValueError) as want:
            getattr(jc, cls)(**kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tc, cls)(**kwargs, **CPU)
        assert str(got.value) == str(want.value)
    tm = tc.DaviesBouldinScore(**CPU)
    tm.update(*map(torch.from_numpy, _data(40)))
    _close(pickle.loads(pickle.dumps(tm)).compute(), tm.compute(), (0.0, 0.0))


# ---------------------------------------------------------------- identical labelings: MI equal to H bit for bit

textr = importlib.import_module("torchmetrics_tpu_torch.functional.clustering.extrinsic")


def _identical(n, permuted=False):
    labels = np.arange(n)
    other = np.random.default_rng(n).permutation(n) if permuted else labels
    return labels, other


@pytest.mark.parametrize(("n", "permuted"), [(2, False), (40, False), (200, False), (1000, False), (40, True)],
                         ids=["2", "40", "200", "1000", "40-permuted"])
def test_identical_labelings_mi_equals_entropy_bitwise(n, permuted):
    """MI sums only the contingency's non-zero cells, in row-major order, as the entropies sum only the non-zero
    counts (XLA's sums of JAX's masked terms round so): identical labelings give MI == H exactly."""
    preds, target = _identical(n, permuted)
    contingency = tutils.calculate_contingency_matrix(torch.tensor(preds), torch.tensor(target))
    mi = textr._mutual_info_from_contingency(contingency)
    assert torch.equal(mi, tutils._entropy_from_counts(contingency.sum(0)))
    assert torch.equal(mi, tutils._entropy_from_counts(contingency.sum(1)))


@pytest.mark.parametrize(("n", "permuted"), [(40, False), (200, False), (1000, False), (40, True)],
                         ids=["40", "200", "1000", "40-permuted"])
def test_ami_of_identical_labelings_is_one(n, permuted):
    """AMI is exactly 1 where MI == H and H - E[MI] clears the float32 epsilon; JAX gives 1 at arange(n) too
    (at the permuted relabelling its own sums give 1.0052: not held)."""
    preds, target = _identical(n, permuted)
    got = tfc.adjusted_mutual_info_score(torch.tensor(preds), torch.tensor(target))
    assert float(got) == 1.0
    if not permuted:
        assert float(jfc.adjusted_mutual_info_score(jnp.asarray(preds), jnp.asarray(target))) == 1.0
