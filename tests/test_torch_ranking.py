"""Parity of the port's multilabel ranking metrics with the JAX package, and the ``ranking_pairs`` launcher.

The same seeded numpy inputs go through both packages; the port runs on the
CPU, where the per-sample values are the plain version of the
``ranking_pairs`` kernel (``chip_smoke.py`` holds the kernel against it on
the card). Coverage and the ranking loss are sums of integer terms and must
be equal up to the float32 mean (1e-6 relative); LRAP sums fractions in
another order than XLA's: within 1e-5 relative.

Inputs cover ties (scores on a 0.1 grid), NaN and +-inf scores, a relevant
NaN, rows with no relevant label and with every label relevant, ignored
labels (``ignore_index`` None, -1 and 255), int64 targets and L = 1.
"""

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.collections as jcol
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.collections as tcol
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.kernels import ranking as krk

jrk = importlib.import_module("torchmetrics_tpu.functional.classification.ranking")
trk = importlib.import_module("torchmetrics_tpu_torch.functional.classification.ranking")

CPU = {"device": "cpu"}
RTOL = 1e-5
N, L = 48, 6
FUNCS = {
    "coverage": "multilabel_coverage_error",
    "lrap": "multilabel_ranking_average_precision",
    "loss": "multilabel_ranking_loss",
}
CLASSES = {
    "coverage": "MultilabelCoverageError",
    "lrap": "MultilabelRankingAveragePrecision",
    "loss": "MultilabelRankingLoss",
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, np.float64), rtol=rtol, atol=1e-6,
                               equal_nan=True)


def _batch(seed, n=N, labels=L, edits=()):
    rng = np.random.default_rng(seed)
    p = np.round(rng.uniform(size=(n, labels)), 1).astype(np.float32)  # ties
    t = (rng.uniform(size=(n, labels)) < 0.35).astype(np.int64)
    if "edges" in edits:
        t[0::8] = 0  # no relevant label
        t[1::8] = 1  # every label relevant
        p[2::8] = 0.5  # all tied
        p[3::8, 0] = np.nan
        p[4::8, -1], t[4::8, -1] = np.nan, 1  # a relevant NaN
        p[5::8, 0] = np.inf
        p[6::8, 0], t[6::8, 0] = -np.inf, 1
    if "ignore" in edits:
        t[rng.uniform(size=(n, labels)) < 0.15] = -1
    if "ignore255" in edits:
        t[rng.uniform(size=(n, labels)) < 0.15] = 255
    return p, t


CASES = {
    "plain": ({}, None),
    "edges": ({"edits": ("edges",)}, None),
    "ignore": ({"edits": ("ignore",)}, -1),
    "edges-ignore": ({"edits": ("edges", "ignore")}, -1),
    "ignore255": ({"edits": ("ignore255",)}, 255),
    "one-label": ({"labels": 1}, None),
    "31-labels": ({"labels": 31, "edits": ("edges",)}, None),
}


@pytest.mark.parametrize("measure", list(FUNCS))
@pytest.mark.parametrize("case", list(CASES))
def test_functional_parity(case, measure):
    opts, ignore_index = CASES[case]
    p, t = _batch(1, **opts)
    labels = p.shape[1]
    want = getattr(jrk, FUNCS[measure])(jnp.asarray(p), jnp.asarray(t), labels, ignore_index)
    got = getattr(trk, FUNCS[measure])(torch.from_numpy(p), torch.from_numpy(t), labels, ignore_index)
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-6 if measure != "lrap" else RTOL)


@pytest.mark.parametrize("target_dtype", ["int32", "int64"])
def test_int_targets_of_either_width(target_dtype):
    p, t = _batch(2, edits=("ignore",))
    t = t.astype(target_dtype)
    for measure, fn in FUNCS.items():
        want = getattr(jrk, fn)(jnp.asarray(p), jnp.asarray(t), L, -1)
        _close(getattr(trk, fn)(torch.from_numpy(p), torch.from_numpy(t), L, -1), want)


# ----------------------------------------------- plain version vs float64 numpy
def _literal(p, t, measure):
    """Each sample by its definition, in float64 numpy loops (0/1 targets, no ignored labels)."""
    out = []
    for s, y in zip(p.astype(np.float64), t):
        rel = y == 1
        if measure == "coverage":
            out.append(0.0 if not rel.any() else float((s >= s[rel].min()).sum()))
        elif measure == "lrap":
            if rel.all() or not rel.any():
                out.append(1.0)
                continue
            out.append(np.mean([(s[rel] >= s[i]).sum() / (s >= s[i]).sum() for i in np.flatnonzero(rel)]))
        else:
            n_rel, n_irr = rel.sum(), (~rel).sum()
            bad = sum((s[~rel] >= s[i]).sum() for i in np.flatnonzero(rel))
            out.append(bad / (n_rel * n_irr) if n_rel * n_irr > 0 else 0.0)
    return np.asarray(out)


@pytest.mark.parametrize("shape", [(16, 1), (20, 7), (8, 40)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("measure", list(FUNCS))
def test_plain_per_sample_against_float64_numpy(measure, shape):
    p, t = _batch(3, n=shape[0], labels=shape[1])
    t[1::5] = 1
    got = trk._ranking_per_sample_plain(torch.from_numpy(p), torch.from_numpy(t), measure, None)
    assert got.shape == (shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _literal(p, t, measure), rtol=1e-6)
    # the dispatch takes the plain version for CPU tensors
    assert torch.equal(trk._ranking_per_sample(torch.from_numpy(p), torch.from_numpy(t), measure, None), got)


# ----------------------------------------------------------------- classes
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("measure", list(CLASSES))
def test_metric_update_compute_forward(measure, ignore_index):
    name = CLASSES[measure]
    jm, tm = getattr(jc, name)(num_labels=L, ignore_index=ignore_index), \
        getattr(tc, name)(num_labels=L, ignore_index=ignore_index, **CPU)
    edits = ("edges", "ignore") if ignore_index is not None else ("edges",)
    for seed in range(3):
        p, t = _batch(10 + seed, n=N - 5 * seed, edits=edits)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    for leaf in ("measure", "total"):
        assert tm.metric_state[leaf].dtype == torch.float32
        _close(tm.metric_state[leaf], jm.metric_state[leaf])
    _close(tm.compute(), jm.compute())
    p, t = _batch(20, edits=edits)
    _close(tm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)))
    _close(tm.metric_state["measure"], jm.metric_state["measure"])
    state = {k: np.asarray(v) for k, v in jm.metric_state.items()}
    _close(tm.compute_state(state_from_jax(tm, state)), jm.compute())


def test_collection_and_pickle():
    jcoll = jcol.MetricCollection({m: getattr(jc, c)(num_labels=L) for m, c in CLASSES.items()})
    tcoll = tcol.MetricCollection({m: getattr(tc, c)(num_labels=L, **CPU) for m, c in CLASSES.items()})
    for seed in range(3):
        p, t = _batch(30 + seed)
        jcoll.update(jnp.asarray(p), jnp.asarray(t))
        tcoll.update(torch.from_numpy(p), torch.from_numpy(t))
    want, got = jcoll.compute(), tcoll.compute()
    assert set(got) == set(want) == set(CLASSES)
    for k in want:
        _close(got[k], want[k])
    clone = pickle.loads(pickle.dumps(tcoll["lrap"]))
    _close(clone.compute(), got["lrap"])


# ----------------------------------------------------------------- launcher
def test_plan_geometry():
    coco = krk.plan(256, 80, "lrap", 132)
    assert coco == krk.Plan(1, 80, 32, 80 * 16 + 128)
    assert krk.plan(256, 80, "coverage", 132) == krk.Plan(1, 80, 96, 80 * 16 + 128)
    big = krk.plan(64, 4096, "loss", 132)
    assert big.splits == 5 and big.chunk == 820 and big.threads == 224 and big.splits * big.chunk >= 4096
    assert krk.plan(32, 1000, "lrap", 132) == krk.Plan(8, 125, 32, 1000 * 16 + 128)
    assert krk.plan(4, 1, "lrap", 132).threads == 32
    limit = krk.plan(4, krk.MAX_LABELS, "lrap", 132)
    assert limit.shared_bytes <= 227 * 1024 and limit.threads <= krk.MAX_THREADS
    for n, labels in ((1, 7), (1000, 300), (3, 12_000)):
        g = krk.plan(n, labels, "lrap", 132)
        assert (g.splits - 1) * g.chunk < labels <= g.splits * g.chunk and g.threads % 32 == 0


def test_launcher_refuses_what_it_does_not_take():
    p, t = torch.rand(4, 6), torch.zeros(4, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        krk.ranking_pairs(p, t, "lrap")
    with pytest.raises(ValueError, match="measure"):
        krk.ranking_pairs(p, t, "ndcg")
    with pytest.raises(ValueError, match="float32"):
        krk.ranking_pairs(p.double(), t, "lrap")
    with pytest.raises(ValueError, match="int32 or int64"):
        krk.ranking_pairs(p, t.float(), "lrap")
    with pytest.raises(ValueError, match="both be"):
        krk.ranking_pairs(p, t[:, :5], "lrap")
    with pytest.raises(ValueError, match="at most"):
        krk.ranking_pairs(torch.rand(1, krk.MAX_LABELS + 1), torch.zeros(1, krk.MAX_LABELS + 1, dtype=torch.int32),
                          "loss")
    with pytest.raises(ValueError, match="at least one label"):
        krk.ranking_pairs(torch.rand(3, 0), torch.zeros(3, 0, dtype=torch.int32), "loss")
    with pytest.raises(ValueError, match="contiguous"):
        krk.ranking_pairs(p.t(), t.t(), "coverage")
    assert krk.ranking_pairs.launches == 0
