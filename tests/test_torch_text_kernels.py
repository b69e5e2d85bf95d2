"""The text kernels' plain versions and launch plans, held against the JAX package and models of the kernels.

``perplexity_nll`` and ``bert_greedy_match`` are CUDA C++ and run only on the
card (``chip_smoke.py`` holds them against their plain versions there). Here:

- the plain versions against JAX's forms, within 1e-5 relative (float32 sums
  and transcendental functions in another order than XLA's);
- a float32 numpy model of ``perplexity_nll``'s scan (each lane's share of a
  row in the kernel's order: the head to the first 16-byte boundary, the
  vectors in groups of ``UNROLL``, the tail; the online maximum and sum with
  its rules for NaN and +-inf; the warp's shuffle tree and the block's merge)
  against the plain version, within 1e-5 relative, NaN where it is NaN;
- a float32 numpy model of ``bert_greedy_match``'s algorithm (each side's
  tokens with a mask above 0 listed, an invalid entry outside the lists
  flooring the other side's maxima at 0, rows zero-padded to chunks of 32,
  sums of squares in order of k, each operand split into hi = tf32(x) and lo
  = tf32(x - hi) with ``cvt.rna.tf32.f32`` modelled bit for bit, the products
  lo.hi, hi.lo and hi.hi of each step of 8 added to float32 accumulators,
  NaN-propagating maxima) against JAX within 1e-5 absolute, also on
  embeddings shaped like a real encoder's (a shared direction and four
  outlier dimensions at 40x) where a single TF32 pass misses 1e-5, NaN where
  JAX is NaN; and JAX's rule that a row of negative valid similarities floors
  at 0 only where its axis has an invalid entry;
- the backward of ``perplexity_nll`` (``_nll_grad``) against autograd of the
  plain version and JAX's gradient;
- every launcher check raises before anything is built, and a CPU tensor never
  reaches a kernel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.kernels import bert_match as kbm
from torchmetrics_tpu_torch.kernels import perplexity as kppl

jbert = importlib.import_module("torchmetrics_tpu.functional.text.bert")
jppl = importlib.import_module("torchmetrics_tpu.functional.text.perplexity")
tppl = importlib.import_module("torchmetrics_tpu_torch.functional.text.perplexity")
tbert = importlib.import_module("torchmetrics_tpu_torch.functional.text.bert")

TOL = (1e-5, 1e-7)
F32 = np.float32


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol[0], atol=tol[1],
                               equal_nan=True)


# ---------------------------------------------------------------- perplexity_nll


class _Online:
    """The kernel's running (m, s) in float32."""

    def __init__(self):
        self.m, self.s = F32(-np.inf), F32(0.0)

    def empty(self):
        return self.m == -np.inf and self.s == 0

    def add(self, x):
        x = F32(x)
        if x == -np.inf:
            return
        if x > self.m:
            self.s = F32(np.nan) if x == np.inf else F32(self.s * np.exp(F32(self.m - x)) + F32(1.0))
            self.m = x
        else:
            self.s = F32(self.s + np.exp(F32(x - self.m)))

    def merge(self, om, os_):
        if om == -np.inf and os_ == 0:
            return
        if self.empty():
            self.m, self.s = om, os_
            return
        nm = max(self.m, om) if not (np.isnan(self.m) or np.isnan(om)) else (om if np.isnan(self.m) else self.m)
        self.s = F32(F32(self.s * np.exp(F32(self.m - nm))) + F32(os_ * np.exp(F32(om - nm))))
        self.m = nm


def _scan_model(row: np.ndarray, lanes: int, misalign: int, vec: int) -> _Online:
    """One row by ``lanes`` threads in the kernel's order; ``misalign`` elements past a 16-byte boundary."""
    v = len(row)
    head = min((vec - misalign) if misalign else 0, v)
    n_vec = (v - head) // vec
    accs = [_Online() for _ in range(lanes)]
    for lane, acc in enumerate(accs):
        for i in range(lane, head, lanes):
            acc.add(row[i])
        j = lane
        while j + (kppl.UNROLL - 1) * lanes < n_vec:
            for u in range(kppl.UNROLL):
                for e in range(vec):
                    acc.add(row[head + (j + u * lanes) * vec + e])
            j += kppl.UNROLL * lanes
        while j < n_vec:
            for e in range(vec):
                acc.add(row[head + j * vec + e])
            j += lanes
        for i in range(head + n_vec * vec + lane, v, lanes):
            acc.add(row[i])
    for w0 in range(0, lanes, 32):  # each warp's xor tree, all lanes at once
        warp = accs[w0:w0 + 32]
        for off in (16, 8, 4, 2, 1):
            old = [(a.m, a.s) for a in warp]
            for lane, a in enumerate(warp):
                a.merge(*old[lane ^ off])
    acc = accs[0]
    for w0 in range(32, lanes, 32):  # the block's warps, in order
        acc.merge(accs[w0].m, accs[w0].s)
    return acc


def _kernel_model(logits: np.ndarray, target: np.ndarray, ignore_index, itemsize: int = 4):
    """The kernel's (total, count, row NLLs) in float32, rows laid out back to back from a 16-byte boundary."""
    n, v = logits.shape
    vec = 16 // itemsize
    nll = np.zeros(n, F32)
    for r in range(n):
        t = int(target[r])
        if ignore_index is not None and t == ignore_index:
            continue
        acc = _scan_model(logits[r], kppl.plan(v), (r * v) % vec, vec)
        wrapped = t + v if t < 0 else t
        if not 0 <= wrapped < v:
            nll[r] = np.nan
            continue
        picked = F32(F32(F32(logits[r, wrapped]) - acc.m) - F32(np.log(acc.s)))
        nll[r] = -picked
    count = F32(n if ignore_index is None else int((target != ignore_index).sum()))
    total = nll.sum(dtype=F32)
    return (F32(-0.0) if total == 0 else total), count, nll


def _rows(seed, n, v, scale=3.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((n, v))).astype(F32), rng.integers(0, v, n).astype(np.int64)


@pytest.mark.parametrize("v", [1, 2, 3, 5, 37, 4096, 4097, 5003])
def test_kernel_model_against_plain(v):
    logits, target = _rows(v, 3 if v > 4096 else 5, v)
    target[1] = -100
    for ignore_index in (None, -100):
        total, count, _ = _kernel_model(logits, target if ignore_index else np.abs(target), ignore_index)
        want = kppl._perplexity_nll_plain(torch.tensor(logits), torch.tensor(target if ignore_index else
                                                                             np.abs(target)), ignore_index)
        _close(total, want[0].numpy())
        assert count == float(want[1])


@pytest.mark.parametrize("edit", ["nan-kept", "nan-ignored", "inf-kept", "inf-ignored", "-inf-target", "-inf-other",
                                  "all-inf-row", "all--inf-row", "target-v", "target--v", "target--v-1"])
def test_kernel_model_non_finite_and_targets(edit):
    v = 40
    logits, target = _rows(7, 4, v)
    target[2] = -100
    row = 2 if edit.endswith("ignored") else 1
    if edit.startswith("nan"):
        logits[row, 5] = np.nan
    elif edit.startswith("inf"):
        logits[row, 5] = np.inf
    elif edit == "-inf-target":
        logits[1, target[1]] = -np.inf
    elif edit == "-inf-other":
        logits[1, (target[1] + 1) % v] = -np.inf
    elif edit == "all-inf-row":
        logits[1] = np.inf
    elif edit == "all--inf-row":
        logits[1] = -np.inf
    else:
        target[1] = {"target-v": v, "target--v": -v, "target--v-1": -v - 1}[edit]
    total, count, nll = _kernel_model(logits, target, -100)
    want = kppl._perplexity_nll_plain(torch.tensor(logits), torch.tensor(target), -100)
    jax_total, jax_count = jppl._perplexity_update(jnp.asarray(logits[None]), jnp.asarray(target[None]), -100)
    _close(total, want[0].numpy())
    _close(total, np.asarray(jax_total))
    assert count == float(want[1]) == float(jax_count)
    assert nll[2] == 0.0  # the ignored row adds nothing


def test_plain_version_is_jax_form():
    logits, target = _rows(11, 64, 300)
    target[::7] = -100
    target[3] = -5
    for ignore_index in (None, -100):
        want = jppl._perplexity_update(jnp.asarray(logits[None]), jnp.asarray(target[None]), ignore_index)
        got = kppl._perplexity_nll_plain(torch.tensor(logits), torch.tensor(target), ignore_index)
        _close(got[0], want[0])
        assert float(got[1]) == float(want[1])
    total, count = kppl._perplexity_nll_plain(torch.zeros((0, 7)), torch.zeros(0, dtype=torch.int64), None)
    assert float(total) == 0.0 and torch.signbit(total) and float(count) == 0.0


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_backward_formula(ignore_index):
    """``_nll_grad`` from the rows' log-sum-exp against autograd of the plain version and JAX's gradient."""
    logits, target = _rows(12, 9, 17)
    target[2] = -100 if ignore_index else target[2]
    target[4] = -3
    x = torch.tensor(logits, requires_grad=True)
    kppl._perplexity_nll_plain(x, torch.tensor(target), ignore_index)[0].mul(2.5).backward()
    lse = torch.logsumexp(torch.tensor(logits), dim=-1)
    got = kppl._nll_grad(torch.tensor(logits), torch.tensor(target), ignore_index, lse, torch.tensor(2.5))
    _close(got, x.grad)
    want = jax.grad(lambda z: 2.5 * jppl._perplexity_update(z[None], jnp.asarray(target[None]), ignore_index)[0])(
        jnp.asarray(logits))
    _close(got, np.asarray(want))
    half = kppl._nll_grad(torch.tensor(logits).half(), torch.tensor(target), ignore_index, lse, torch.tensor(1.0))
    assert half.dtype == torch.float16


def test_backward_ignored_rows_stay_zero_with_non_finite_logits():
    logits, target = _rows(13, 4, 9)
    logits[1] = np.nan
    logits[2, 3] = 1e30
    target[1] = target[2] = -100
    lse = torch.zeros(4)
    got = kppl._nll_grad(torch.tensor(logits), torch.tensor(target), -100, lse, torch.tensor(1.0))
    assert torch.equal(got[1:3], torch.zeros(2, 9))


def test_plan_and_launcher_checks():
    assert kppl.plan(1) == kppl.plan(kppl.WARP_ROW_MAX) == 32 and kppl.plan(kppl.WARP_ROW_MAX + 1) == kppl.THREADS
    before = kppl.perplexity_nll.launches
    x, t = torch.zeros((3, 5)), torch.zeros(3, dtype=torch.int64)
    for args, match in (((x.double(), t), "float32, bfloat16 or float16"), ((x, t.float()), "int32 or int64"),
                        ((x[None], t), r"\(N, V\)"), ((x, t[:2]), r"\(N, V\)"), ((torch.zeros((3, 0)), t), "V >= 1"),
                        ((x.t(), torch.zeros(5, dtype=torch.int64)), "contiguous"),
                        ((x, t), "CUDA tensors only")):
        with pytest.raises(ValueError, match=match):
            kppl.perplexity_nll(*args)
    tppl._perplexity_update(torch.zeros((2, 3, 5)), torch.zeros((2, 3), dtype=torch.int64))
    assert kppl.perplexity_nll.launches == before  # the CPU takes the plain version


# ---------------------------------------------------------------- bert_greedy_match


def _pairs(seed, b, tp, tt, h, masked=0.25):
    rng = np.random.default_rng(seed)
    pe = rng.standard_normal((b, tp, h)).astype(F32)
    te = rng.standard_normal((b, tt, h)).astype(F32)
    pm = (rng.random((b, tp)) > masked).astype(F32)
    tm = (rng.random((b, tt)) > masked).astype(F32)
    return pe, pm, te, tm


def _tf32(x):
    """``cvt.rna.tf32.f32``: round to the nearest TF32 (10 mantissa bits), ties away from zero: add 0x1000 to the
    float's bits, then clear the low 13."""
    bits = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)


def _bert_model(pe, pm, te, tm, pw=None, tw=None, passes=3):
    """The kernel's algorithm in float32. Its passes over blocks of ``kbm.BLOCK`` listed rows a side compute each
    entry as one pass does, so the model takes every listed row at once; ``passes=1`` keeps hi.hi alone (a single
    TF32 product)."""
    b, tp, h = pe.shape
    tt_ = te.shape[1]
    width = h + (-h) % kbm.CHUNK  # H zero-filled to whole chunks
    out = np.zeros((3, b), F32)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for k in range(b):
            ip, it = np.flatnonzero(pm[k] > 0), np.flatnonzero(tm[k] > 0)  # the lists
            x = np.zeros((len(ip), width), F32)
            y = np.zeros((len(it), width), F32)
            x[:, :h], y[:, :h] = pe[k, ip], te[k, it]
            ss_x, ss_y = np.zeros(len(ip), F32), np.zeros(len(it), F32)
            for c in range(width):  # fmaf in order of k: the product is exact in float64, one rounding
                ss_x = (x[:, c].astype(np.float64) ** 2 + ss_x).astype(F32)
                ss_y = (y[:, c].astype(np.float64) ** 2 + ss_y).astype(F32)
            x_hi, y_hi = _tf32(x), _tf32(y)
            x_lo, y_lo = _tf32(x - x_hi), _tf32(y - y_hi)
            terms = [(x_lo, y_hi), (x_hi, y_lo), (x_hi, y_hi)][3 - passes:]
            acc = np.zeros((len(ip), len(it)), F32)
            for k0 in range(0, width, 8):  # an mma a step of 8, each added to the float32 accumulator
                for a, c in terms:
                    acc = (acc + a[:, k0:k0 + 8].astype(np.float64) @ c[:, k0:k0 + 8].T.astype(np.float64)).astype(F32)
            inv_x = (1 / np.maximum(np.sqrt(ss_x), F32(1e-12))).astype(F32)
            inv_y = (1 / np.maximum(np.sqrt(ss_y), F32(1e-12))).astype(F32)
            sim = np.where(pm[k, ip][:, None] * tm[k, it][None, :] > 0, acc * inv_x[:, None] * inv_y[None, :], F32(0))
            # an entry outside a list is invalid, 0: it floors the other side's maxima; np.maximum keeps a NaN
            row_max = np.full(tp, 0.0 if len(it) < tt_ else -np.inf, F32)
            col_max = np.full(tt_, 0.0 if len(ip) < tp else -np.inf, F32)
            if sim.size:
                row_max[ip] = np.maximum(row_max[ip], sim.max(1))
                col_max[it] = np.maximum(col_max[it], sim.max(0))
            wp = pm[k] if pw is None else pw[k] * pm[k]
            wt = tm[k] if tw is None else tw[k] * tm[k]
            p = (np.where(pm[k] > 0, row_max, 0) * wp).sum() / max(wp.sum(), 1e-12)
            r = (np.where(tm[k] > 0, col_max, 0) * wt).sum() / max(wt.sum(), 1e-12)
            out[:, k] = p, r, 2 * p * r / max(p + r, 1e-12)
    return out


def _encoder_like(seed, b, t, h, outliers=4, scale=40.0):
    """Embeddings shaped like a trained encoder's: a direction shared by every token (mean cosine about 0.24) and
    a few outlier dimensions ``scale`` times the others, with seeded lengths of 10 to ``t`` tokens."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(h)
    u *= 0.8 * np.sqrt(h) / np.linalg.norm(u)
    dims = rng.choice(h, outliers, replace=False)

    def side():
        x = rng.standard_normal((b, t, h)) + u
        x[..., dims] *= scale
        return x.astype(F32)

    pe, te = side(), side()
    pm = (np.arange(t) < rng.integers(10, t + 1, (b, 1))).astype(F32)
    tm = (np.arange(t) < rng.integers(10, t + 1, (b, 1))).astype(F32)
    return pe, pm, te, tm


def _plain(pe, pm, te, tm, pw=None, tw=None):
    t = lambda x: None if x is None else torch.tensor(x)  # noqa: E731
    return np.stack([x.numpy() for x in kbm._bert_greedy_match_plain(t(pe), t(pm), t(te), t(tm), t(pw), t(tw))])


def _jax(pe, pm, te, tm, pw=None, tw=None):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    return np.stack([np.asarray(x) for x in jbert._bert_score_from_embeddings(j(pe), j(pm), j(te), j(tm), j(pw),
                                                                              j(tw))])


@pytest.mark.parametrize(("b", "tp", "tt", "h"), [(3, 9, 14, 16), (2, 1, 1, 33), (2, 70, 130, 8), (1, 5, 5, 1),
                                                  (2, 64, 64, 40)])
@pytest.mark.parametrize("idf", [False, True])
def test_bert_plain_and_tile_model_against_jax(b, tp, tt, h, idf):
    pe, pm, te, tm = _pairs(b * tp + tt, b, tp, tt, h)
    rng = np.random.default_rng(h)
    pw, tw = ((rng.random((b, tp)).astype(F32), rng.random((b, tt)).astype(F32)) if idf else (None, None))
    want = _jax(pe, pm, te, tm, pw, tw)
    _close(_plain(pe, pm, te, tm, pw, tw), want, (1e-5, 1e-6))
    _close(_bert_model(pe, pm, te, tm, pw, tw), want, (0.0, 1e-5))


def test_bert_negative_rows_floor_at_zero_only_beside_an_invalid_entry():
    """JAX sets an invalid entry to 0 before the max over the whole padded axis: a prediction token whose valid
    similarities are all negative keeps its negative best match when every target token is valid, and floors at
    0 when one is masked."""
    h = 6
    te = np.stack([np.eye(3, h, dtype=F32) * (1.0 + k) for k in range(2)])  # target tokens along three axes
    pe = -te.sum(1, keepdims=True) + 0.1 * np.eye(1, h, 5, dtype=F32)  # (2, 1, h): against every one of them
    pm = np.ones((2, 1), F32)
    tm = np.ones((2, 3), F32)
    tm[1, 2] = 0.0  # pair 1: one invalid target token
    for fn in (_jax, _plain, _bert_model):
        p = fn(pe, pm, te, tm)[0]
        assert p[0] < 0 and p[1] == 0.0, (fn.__name__, p)
    _close(_plain(pe, pm, te, tm), _jax(pe, pm, te, tm), (1e-5, 1e-6))


def test_bert_masked_rows_and_zero_norms():
    pe, pm, te, tm = _pairs(30, 3, 7, 9, 12)
    pm[0] = 0.0  # every prediction token masked: P = 0
    tm[1] = 0.0
    pe[2, :3] = 0.0  # zero-norm embeddings: similarity 0
    te[2, 4] = 0.0
    want = _jax(pe, pm, te, tm)
    _close(_plain(pe, pm, te, tm), want, (1e-5, 1e-6))
    _close(_bert_model(pe, pm, te, tm), want, (0.0, 1e-5))
    assert want[0, 0] == 0.0 and want[1, 1] == 0.0


def test_bert_encoder_like_embeddings_within_tolerance():
    """Outlier dimensions make each product's rounding large beside the cosine: three TF32 passes stay within
    float32's noise of JAX's float32 einsum, at roberta-large's H."""
    pe, pm, te, tm = _encoder_like(40, 6, 48, 1_024)
    want = _jax(pe, pm, te, tm)
    _close(_plain(pe, pm, te, tm), want, (1e-5, 1e-6))
    _close(_bert_model(pe, pm, te, tm), want, (0.0, 1e-5))


def test_bert_single_tf32_pass_misses_tolerance():
    """The encoder-like case catches the shortcut: one TF32 product (hi.hi alone) misses phase 3's 1e-5."""
    pe, pm, te, tm = _encoder_like(40, 6, 48, 1_024)
    want = _jax(pe, pm, te, tm)
    assert np.abs(_bert_model(pe, pm, te, tm, passes=1) - want).max() > 1e-5
    assert np.abs(_bert_model(pe, pm, te, tm) - want).max() < 1e-6


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf], ids=["nan", "+inf", "-inf"])
@pytest.mark.parametrize("where", ["valid prediction row", "valid target row", "masked rows"])
def test_bert_non_finite_embeddings(value, where):
    """A NaN or +-inf in a valid row makes that pair's P, R and F1 NaN (its norm and every similarity of the row
    are NaN, and JAX's max keeps a NaN); in a masked row it changes nothing. NaN positions must match."""
    pe, pm, te, tm = _pairs(50, 3, 5, 6, 8, masked=0.0)
    pm[:, 3] = 0.0
    tm[:, 4] = 0.0
    if where == "valid prediction row":
        pe[1, 2, 5] = value
    elif where == "valid target row":
        te[1, 0, 1] = value
    else:
        pe[1, 3, 5] = value
        te[1, 4, 2] = value
    want = _jax(pe, pm, te, tm)
    assert np.isfinite(want[:, [0, 2]]).all()
    assert np.isnan(want[:, 1]).all() if where != "masked rows" else np.isfinite(want[:, 1]).all()
    _close(_plain(pe, pm, te, tm), want, (1e-5, 1e-6))
    _close(_bert_model(pe, pm, te, tm), want, (0.0, 1e-5))


def test_bert_special_token_holes():
    """BERTScore drops [CLS] and [SEP] from the masks: a hole at position 0 and at the last valid token of each
    row, so the valid tokens are no prefix; the lists skip the holes, which floor the other side at 0."""
    pe, pm, te, tm = _pairs(51, 4, 12, 10, 24, masked=0.0)
    for m, lengths in ((pm, (12, 9, 5, 3)), (tm, (10, 10, 4, 2))):
        for k, n in enumerate(lengths):
            m[k, n:] = 0.0
            m[k, [0, n - 1]] = 0.0
    want = _jax(pe, pm, te, tm)
    _close(_plain(pe, pm, te, tm), want, (1e-5, 1e-6))
    _close(_bert_model(pe, pm, te, tm), want, (0.0, 1e-5))


def test_bert_launcher_checks_and_dispatch():
    pe, pm, te, tm = (torch.tensor(x) for x in _pairs(31, 2, 4, 5, 8))
    before = kbm.bert_greedy_match.launches
    for args, match in (((pe[0], pm, te, tm), r"\(B, Tp, H\)"), ((pe, pm, te[:, :, :3], tm), r"\(B, Tp, H\)"),
                        ((pe[:, :0], pm[:, :0], te, tm), "at least 1"),
                        ((pe, pm, te, tm), "CUDA tensors only")):
        with pytest.raises(ValueError, match=match):
            kbm.bert_greedy_match(*args)
    long = torch.zeros((1, kbm.MAX_TOKENS, 2))
    with pytest.raises(ValueError, match="up to"):
        kbm.bert_greedy_match(long, long[..., 0], long[:, :1], long[:, :1, 0])
    tbert._bert_score_from_embeddings(pe, pm, te, tm)
    assert kbm.bert_greedy_match.launches == before  # the CPU takes the plain version
    # a block's shared memory: the aligned stages and lo parts, 6 bytes a token (a maximum and a list entry), the
    # pass's norms and masks
    static = 4 * kbm.BLOCK * 4 + 2 * (kbm.THREADS // 32) * 4 + (kbm.THREADS // 32) * 16
    assert 32 * kbm.CHUNK + (kbm.STAGES + 2) * 2 * kbm.BLOCK * kbm.CHUNK * 4 + 6 * kbm.MAX_TOKENS + static <= 227 * 1024
