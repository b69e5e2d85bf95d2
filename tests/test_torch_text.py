"""The port's text metrics beyond ROUGE, held against the JAX package.

The same seeded sentences, token ids and logits go through both packages;
the port runs on the CPU (``device="cpu"``), where Perplexity takes the plain
version of the ``perplexity_nll`` kernel and BERTScore the plain version of
``bert_greedy_match`` (``chip_smoke.py`` holds the kernels against them on the
card; ``tests/test_torch_text_kernels.py`` holds the plain versions and models
of the kernels against JAX).

Tolerances:
- host counts (edit distances, n-gram counts, lengths, SQuAD sums) and the
  float32 states built from them: equal;
- scores computed from them in float32 (WER, BLEU, chrF, EED, TER): within
  1e-6 relative (the same formula, float32 in another order);
- tensor metrics (Perplexity, BERTScore, InfoLM's distributions): within
  1e-5 relative (float32 sums and transcendental functions in another order
  than XLA's); InfoLM's divergences of near-equal distributions cancel to
  1e-5 of their terms, so they are held on the same distributions, and end
  to end within 1e-5 relative plus 1e-6 absolute.

BERTScore and InfoLM also run through one tiny random-initialised checkpoint
(hidden 32, 2 layers, a WordPiece vocabulary written from the seeded words),
saved once: the port loads it with torch ``AutoModel``, the JAX package with
``FlaxAutoModel(from_pt=True)``.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.text as jft
import torchmetrics_tpu.text as jt
import torchmetrics_tpu_torch.functional.text as tft
import torchmetrics_tpu_torch.text as tt
from torchmetrics_tpu_torch.convert import state_from_jax

# the modules, not the functions of their names that the namespaces re-export
jbert, jhelper, jinfolm, jppl, tbert, thelper, tinfolm, tppl = (
    importlib.import_module(f"{pkg}.functional.text.{m}") for pkg in ("torchmetrics_tpu", "torchmetrics_tpu_torch")
    for m in ("bert", "helper", "infolm", "perplexity"))

CPU = {"device": "cpu"}
EXACT, HOST_TOL, TENSOR_TOL = (0.0, 0.0), (1e-6, 0.0), (1e-5, 1e-7)
WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "fast", "home", "Home.", "cat!", "it's", "is",
         "there", "42", "3.5", "U.S.", "e.g.", "(big)", "red,", "blue?", "der", "Hund", "läuft", "猫", "在", "垫子"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, equal_nan=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol[0], atol=tol[1],
                               equal_nan=equal_nan)


def _sentence(rng, lo=0, hi=12):
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))


def _corpus(seed, n, refs=1, lo=0):
    rng = np.random.default_rng(seed)
    preds = [_sentence(rng, lo) for _ in range(n)]
    target = [[_sentence(rng, lo) for _ in range(refs)] for _ in range(n)]
    return preds, target


def _flat(target):
    return [t[0] for t in target]


def _assert_states(tm, jm):
    """Every leaf of the port's state equal (lists item by item) to the JAX state's, in dtype and value."""
    assert set(tm.metric_state) == set(jm.metric_state)
    for name, want in jm.metric_state.items():
        got = tm.metric_state[name]
        if isinstance(want, (list, tuple)):
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype), name
                _close(g, w, EXACT)
        else:
            assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype), name
            _close(got, want, EXACT)


def _round_trip(tm_factory, jm, *batch):
    """A JAX state carried into a fresh port metric: same compute, and one more update on both agrees."""
    tm = tm_factory()
    np_state = {k: ([np.asarray(v) for v in val] if isinstance(val, (list, tuple)) else np.asarray(val))
                for k, val in jm.metric_state.items()}
    tm._state = state_from_jax(tm, np_state)
    _assert_states(tm, jm)
    if batch:
        jm.update(*batch)
        tm.update(*batch)
        _assert_states(tm, jm)
    return tm


# ---------------------------------------------------------------- helper


def test_edit_distance_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(30):
        a = list(rng.choice(WORDS[:8], int(rng.integers(0, 12))))
        b = list(rng.choice(WORDS[:8], int(rng.integers(0, 12))))
        for cost in (1, 2):
            assert thelper._edit_distance(a, b, cost) == jhelper._edit_distance(a, b, cost)
        np.testing.assert_array_equal(thelper._edit_distance_matrix(a, b), jhelper._edit_distance_matrix(a, b))


# ---------------------------------------------------------------- the ASR family

ASR = ["word_error_rate", "char_error_rate", "match_error_rate", "word_information_lost",
       "word_information_preserved"]
ASR_CLASSES = {"word_error_rate": "WordErrorRate", "char_error_rate": "CharErrorRate",
               "match_error_rate": "MatchErrorRate", "word_information_lost": "WordInfoLost",
               "word_information_preserved": "WordInfoPreserved"}


@pytest.mark.parametrize("name", ASR)
@pytest.mark.parametrize("n", [0, 1, 9])
def test_asr_functional(name, n):
    preds, target = _corpus(n, n, lo=1)
    want = getattr(jft, name)(preds, _flat(target))
    got = getattr(tft, name)(preds, _flat(target))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, want, HOST_TOL, equal_nan=True)


@pytest.mark.parametrize("name", ASR)
def test_asr_classes(name):
    jm, tm = getattr(jt, ASR_CLASSES[name])(), getattr(tt, ASR_CLASSES[name])(**CPU)
    for seed in range(3):
        preds, target = _corpus(20 + seed, 4, lo=1)
        jm.update(preds, _flat(target))
        tm.update(preds, _flat(target))
    _assert_states(tm, jm)
    _close(tm.compute(), jm.compute(), HOST_TOL)
    preds, target = _corpus(30, 3, lo=1)
    _round_trip(lambda: getattr(tt, ASR_CLASSES[name])(**CPU), jm, preds, _flat(target))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("cost", [1, 2])
def test_edit_distance(reduction, cost):
    preds, target = _corpus(40, 7)
    want = jft.edit_distance(preds, _flat(target), substitution_cost=cost, reduction=reduction)
    got = tft.edit_distance(preds, _flat(target), substitution_cost=cost, reduction=reduction)
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)
    tol = HOST_TOL if reduction == "mean" else EXACT  # XLA's mean multiplies by 1 / n
    _close(got, want, tol)
    jm, tm = jt.EditDistance(cost, reduction), tt.EditDistance(cost, reduction, **CPU)
    for seed in range(2):
        preds, target = _corpus(41 + seed, 5)
        jm.update(preds, _flat(target))
        tm.update(preds, _flat(target))
    _assert_states(tm, jm)
    _close(tm.compute(), jm.compute(), tol)
    _round_trip(lambda: tt.EditDistance(cost, reduction, **CPU), jm, preds, _flat(target))


def test_edit_distance_empty_and_errors():
    _close(tft.edit_distance([], []), jft.edit_distance([], []), EXACT, equal_nan=True)
    assert tuple(tft.edit_distance([], [], reduction="none").shape) == (0,)
    assert tuple(tt.EditDistance(reduction="none", **CPU).compute().shape) == (0,)
    with pytest.raises(ValueError, match="same length"):
        tft.edit_distance(["a"], ["a", "b"])
    with pytest.raises(ValueError, match="reduction"):
        tft.edit_distance(["a"], ["b"], reduction="max")
    with pytest.raises(ValueError, match="substitution_cost"):
        tt.EditDistance(substitution_cost=-1, **CPU)


# ---------------------------------------------------------------- BLEU and SacreBLEU


@pytest.mark.parametrize(("n_gram", "smooth", "refs"), [(1, False, 1), (2, True, 2), (4, False, 3), (4, True, 1)])
def test_bleu_functional(n_gram, smooth, refs):
    preds, target = _corpus(50 + n_gram, 12, refs, lo=3)
    _close(tft.bleu_score(preds, target, n_gram=n_gram, smooth=smooth),
           jft.bleu_score(preds, target, n_gram=n_gram, smooth=smooth), HOST_TOL)
    weights = [0.1 * (i + 1) for i in range(n_gram)]
    _close(tft.bleu_score(preds, target, n_gram=n_gram, weights=weights),
           jft.bleu_score(preds, target, n_gram=n_gram, weights=weights), HOST_TOL)


@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char"])
@pytest.mark.parametrize("lowercase", [False, True])
def test_sacre_bleu_functional(tokenize, lowercase):
    preds, target = _corpus(60, 10, 2, lo=3)
    kw = {"tokenize": tokenize, "lowercase": lowercase, "smooth": True}
    _close(tft.sacre_bleu_score(preds, target, **kw), jft.sacre_bleu_score(preds, target, **kw), HOST_TOL)
    from torchmetrics_tpu.functional.text.sacre_bleu import _SacreBLEUTokenizer as JTok
    from torchmetrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer as TTok

    for line in preds + ["a&quot;b -\n c", "x-1 2.5, y.", "猫在垫子上 ok!"]:
        assert list(TTok(tokenize, lowercase)(line)) == list(JTok(tokenize, lowercase)(line))


def test_bleu_errors_and_empty():
    for fn in (tft.bleu_score, tft.sacre_bleu_score):
        with pytest.raises(ValueError, match="Corpus has different size"):
            fn(["a"], [])
        with pytest.raises(ValueError, match="weights"):
            fn(["a"], [["a"]], weights=[1.0])
        _close(fn([], []), jft.bleu_score([], []), EXACT)
    for tok in ("ja-mecab", "ko-mecab"):
        with pytest.raises(ModuleNotFoundError):
            tft.sacre_bleu_score(["a"], [["a"]], tokenize=tok)
    with pytest.raises(ValueError, match="Unsupported tokenizer"):
        tft.sacre_bleu_score(["a"], [["a"]], tokenize="nope")
    with pytest.raises(ValueError, match="tokenize"):
        tt.SacreBLEUScore(tokenize="nope", **CPU)
    # the reservoir is ported; an unknown approx mode stays refused, as in JAX
    assert set(tt.BLEUScore(approx="reservoir", **CPU)._defaults) == {"corpus_sample", "samples_total"}
    with pytest.raises(ValueError, match="approx"):
        tt.BLEUScore(approx="sketchy", **CPU)


@pytest.mark.parametrize("cls", ["BLEUScore", "SacreBLEUScore"])
def test_bleu_classes(cls):
    jm, tm = getattr(jt, cls)(n_gram=3, smooth=True), getattr(tt, cls)(n_gram=3, smooth=True, **CPU)
    for seed in range(3):
        preds, target = _corpus(70 + seed, 5, 2, lo=2)
        jm.update(preds, target)
        tm.update(preds, target)
    _assert_states(tm, jm)
    _close(tm.compute(), jm.compute(), HOST_TOL)
    _close(tm(preds, target), jm(preds, target), HOST_TOL)  # forward: the batch's score
    _round_trip(lambda: getattr(tt, cls)(n_gram=3, smooth=True, **CPU), jm, preds, target)


# ---------------------------------------------------------------- chrF, EED, TER, SQuAD


@pytest.mark.parametrize(("n_char", "n_word", "beta", "lowercase", "whitespace"),
                         [(6, 2, 2.0, False, False), (6, 0, 1.0, True, False), (3, 3, 3.0, False, True)])
def test_chrf(n_char, n_word, beta, lowercase, whitespace):
    preds, target = _corpus(80, 8, 2, lo=1)
    kw = {"n_char_order": n_char, "n_word_order": n_word, "beta": beta, "lowercase": lowercase,
          "whitespace": whitespace}
    j_corpus, j_sent = jft.chrf_score(preds, target, return_sentence_level_score=True, **kw)
    t_corpus, t_sent = tft.chrf_score(preds, target, return_sentence_level_score=True, **kw)
    _close(t_corpus, j_corpus, HOST_TOL)
    _close(t_sent, j_sent, HOST_TOL)
    jm, tm = jt.CHRFScore(return_sentence_level_score=True, **kw), tt.CHRFScore(return_sentence_level_score=True,
                                                                             **kw, **CPU)
    for seed in range(2):
        preds, target = _corpus(81 + seed, 4, 2, lo=1)
        jm.update(preds, target)
        tm.update(preds, target)
    _assert_states(tm, jm)
    for g, w in zip(tm.compute(), jm.compute()):
        _close(g, w, HOST_TOL)
    _round_trip(lambda: tt.CHRFScore(return_sentence_level_score=True, **kw, **CPU), jm, preds, target)


@pytest.mark.parametrize("language", ["en", "ja"])
def test_eed(language):
    preds, target = _corpus(90, 8, 2, lo=1)
    j_avg, j_sent = jft.extended_edit_distance(preds, target, language=language, return_sentence_level_score=True)
    t_avg, t_sent = tft.extended_edit_distance(preds, target, language=language, return_sentence_level_score=True)
    _close(t_avg, j_avg, HOST_TOL)
    _close(t_sent, j_sent, EXACT)
    jm, tm = jt.ExtendedEditDistance(language, True), tt.ExtendedEditDistance(language, True, **CPU)
    for seed in range(2):
        preds, target = _corpus(91 + seed, 4, 1, lo=1)
        jm.update(preds, target)
        tm.update(preds, target)
    _assert_states(tm, jm)
    for g, w in zip(tm.compute(), jm.compute()):
        _close(g, w, HOST_TOL)
    _round_trip(lambda: tt.ExtendedEditDistance(language, True, **CPU), jm, preds, target)


@pytest.mark.parametrize(("normalize", "no_punctuation", "lowercase", "asian_support"),
                         [(False, False, True, False), (True, True, False, True), (True, False, True, False)])
def test_ter(normalize, no_punctuation, lowercase, asian_support):
    kw = {"normalize": normalize, "no_punctuation": no_punctuation, "lowercase": lowercase,
          "asian_support": asian_support}
    preds, target = _corpus(100, 8, 2, lo=1)
    j_score, j_sent = jft.translation_edit_rate(preds, target, return_sentence_level_score=True, **kw)
    t_score, t_sent = tft.translation_edit_rate(preds, target, return_sentence_level_score=True, **kw)
    _close(t_score, j_score, HOST_TOL)
    _close(t_sent, j_sent, EXACT)
    jm = jt.TranslationEditRate(return_sentence_level_score=True, **kw)
    tm = tt.TranslationEditRate(return_sentence_level_score=True, **kw, **CPU)
    for seed in range(2):
        preds, target = _corpus(101 + seed, 4, 2, lo=1)
        jm.update(preds, target)
        tm.update(preds, target)
    _assert_states(tm, jm)
    for g, w in zip(tm.compute(), jm.compute()):
        _close(g, w, HOST_TOL)
    _round_trip(lambda: tt.TranslationEditRate(return_sentence_level_score=True, **kw, **CPU), jm, preds, target)


def _squad_batch(seed, n):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n):
        answers = [_sentence(rng, 1, 5) for _ in range(int(rng.integers(1, 4)))]
        guess = answers[0] if rng.random() < 0.3 else _sentence(rng, 0, 5)
        preds.append({"prediction_text": guess, "id": f"q{seed}-{i}"})
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{seed}-{i}"})
    return preds, target


def test_squad():
    preds, target = _squad_batch(110, 12)
    want, got = jft.squad(preds, target), tft.squad(preds, target)
    for k in ("exact_match", "f1"):
        _close(got[k], want[k], HOST_TOL)
    jm, tm = jt.SQuAD(), tt.SQuAD(**CPU)
    for seed in range(3):
        preds, target = _squad_batch(111 + seed, 5)
        jm.update(preds, target)
        tm.update(preds, target)
    _assert_states(tm, jm)
    for k, w in jm.compute().items():
        _close(tm.compute()[k], w, HOST_TOL)
    _round_trip(lambda: tt.SQuAD(**CPU), jm, preds, target)
    with pytest.raises(KeyError, match="prediction_text"):
        tft.squad([{"id": "1"}], target)


@pytest.mark.parametrize("fn", ["chrf_score", "extended_edit_distance", "translation_edit_rate"])
def test_empty_corpus(fn):
    _close(getattr(tft, fn)([], []), getattr(jft, fn)([], []), EXACT, equal_nan=True)


def test_empty_classes_compute_as_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in ("ExtendedEditDistance", "InfoLM"):
            _close(getattr(tt, name)(**CPU).compute(), getattr(jt, name)().compute(), EXACT)
        jm, tm = jt.SQuAD(), tt.SQuAD(**CPU)
        jm.update([], [])
        tm.update([], [])
        for k, w in jm.compute().items():
            _close(tm.compute()[k], w, EXACT, equal_nan=True)


# ---------------------------------------------------------------- Perplexity


def _logits(seed, b, t, v, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal((b, t, v))).astype(dtype), rng.integers(0, v, (b, t)).astype(np.int64)


@pytest.mark.parametrize("v", [1, 2, 3, 37, 1000])
@pytest.mark.parametrize("ignore_index", [None, -100, 0])
def test_perplexity_functional(v, ignore_index):
    logits, target = _logits(v, 3, 9, v)
    target[0, :4] = -100
    want = jppl._perplexity_update(jnp.asarray(logits), jnp.asarray(target), ignore_index)
    got = tppl._perplexity_update(torch.tensor(logits), torch.tensor(target), ignore_index)
    _close(got[0], want[0], TENSOR_TOL, equal_nan=True)
    _close(got[1], want[1], EXACT)
    _close(tft.perplexity(torch.tensor(logits), torch.tensor(target), ignore_index),
           jft.perplexity(jnp.asarray(logits), jnp.asarray(target), ignore_index), TENSOR_TOL, equal_nan=True)


@pytest.mark.parametrize("edit", ["nan", "inf", "-inf", "-inf-kept", "+inf-kept", "nan-kept"])
def test_perplexity_non_finite_logits(edit):
    """An ignored row adds nothing whatever its logits (JAX's masked sum is a select); a kept one with NaN or
    +inf is NaN, with -inf at the target +inf."""
    logits, target = _logits(120, 2, 5, 7)
    target[0, 2] = -100
    row, value = (1, 3) if edit.endswith("kept") else (0, 2), {"nan": np.nan, "inf": np.inf}.get(edit[:3], None)
    if edit.startswith("-inf"):
        logits[row][target[row] if edit.endswith("kept") else 1] = -np.inf
    elif edit.startswith("+inf"):
        logits[row][1] = np.inf
    else:
        logits[row][:] = value
    want = jppl._perplexity_update(jnp.asarray(logits), jnp.asarray(target), -100)
    got = tppl._perplexity_update(torch.tensor(logits), torch.tensor(target), -100)
    _close(got[0], want[0], TENSOR_TOL, equal_nan=True)
    _close(got[1], want[1], EXACT)


@pytest.mark.parametrize("t", [-1, -7, 7, -8, 100])
def test_perplexity_targets_out_of_range(t):
    """[-V, 0) wraps once; outside [-V, V) the total is NaN (take_along_axis's fill)."""
    logits, target = _logits(121, 2, 4, 7)
    target[1, 1] = t
    want = jppl._perplexity_update(jnp.asarray(logits), jnp.asarray(target))
    got = tppl._perplexity_update(torch.tensor(logits), torch.tensor(target))
    _close(got[0], want[0], TENSOR_TOL, equal_nan=True)
    assert np.isnan(_np(got[0])) == (not -7 <= t < 7)


@pytest.mark.parametrize("shape", [(0, 4, 5), (2, 0, 5)])
def test_perplexity_empty_batch(shape):
    want = jppl._perplexity_update(jnp.zeros(shape), jnp.zeros(shape[:2], jnp.int32), -100)
    got = tppl._perplexity_update(torch.zeros(shape), torch.zeros(shape[:2], dtype=torch.int64), -100)
    assert float(got[0]) == float(want[0]) == 0.0 and np.signbit(_np(got[0])) and np.signbit(np.asarray(want[0]))
    _close(got[1], want[1], EXACT)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_perplexity_half_logits_in_float32(dtype):
    logits, target = _logits(122, 2, 6, 50)
    half = torch.tensor(logits).to(dtype)
    want = jppl._perplexity_update(jnp.asarray(half.float().numpy()), jnp.asarray(target), None)
    _close(tppl._perplexity_update(half, torch.tensor(target), None)[0], want[0], TENSOR_TOL)


@pytest.mark.parametrize("ignore_index", [None, -100])
def test_perplexity_gradient_equals_jax(ignore_index):
    logits, target = _logits(123, 2, 5, 11)
    target[0, 1] = -100 if ignore_index else target[0, 1]
    want = jax.grad(lambda x: jppl._perplexity_update(x, jnp.asarray(target), ignore_index)[0])(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tppl._perplexity_update(x, torch.tensor(target), ignore_index)[0].backward()
    _close(x.grad, want, TENSOR_TOL)


def test_perplexity_class_and_errors():
    jm, tm = jt.Perplexity(ignore_index=-100), tt.Perplexity(ignore_index=-100, **CPU)
    for seed in range(3):
        logits, target = _logits(130 + seed, 2, 6, 40)
        target[0, 0] = -100
        jm.update(jnp.asarray(logits), jnp.asarray(target))
        tm.update(torch.tensor(logits), torch.tensor(target))
    for name in ("total_log_probs", "count"):
        _close(tm.metric_state[name], jm.metric_state[name], TENSOR_TOL)
    _close(tm.compute(), jm.compute(), TENSOR_TOL)
    tm2 = _round_trip(lambda: tt.Perplexity(ignore_index=-100, **CPU), jm)
    tm2.update(torch.tensor(logits), torch.tensor(target))
    jm.update(jnp.asarray(logits), jnp.asarray(target))
    _close(tm2.compute(), jm.compute(), TENSOR_TOL)
    with pytest.raises(ValueError, match="ignore_index"):
        tt.Perplexity(ignore_index=1.5, **CPU)
    for bad in ((torch.zeros(2, 3), torch.zeros(2, 3)), (torch.zeros(2, 3, 4), torch.zeros(2)),
                (torch.zeros(2, 3, 4), torch.zeros(2, 4))):
        with pytest.raises(ValueError):
            tft.perplexity(*bad)


# ---------------------------------------------------------------- BERTScore

PAIRS = (["the cat sat on the mat", "a dog ran fast home", "it's there", "cat"],
         ["the cat is on the mat", "dogs ran home", "there it is", "a red cat sat"])


def test_hash_embedding_is_jax_bit_for_bit():
    rng = np.random.default_rng(140)
    ids = rng.integers(-(2**31), 2**31 - 1, (4, 9)).astype(np.int32)
    ids[0, :4] = [0, 1, 2**31 - 1, -1]
    mask = rng.integers(0, 2, (4, 9)).astype(np.int32)
    for dim in (1, 128, 512):
        want = np.asarray(jbert._hash_embedding_model(jnp.asarray(ids), jnp.asarray(mask), dim))
        got = tbert._hash_embedding_model(torch.tensor(ids), torch.tensor(mask), dim).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_bert_host_helpers_equal_jax():
    tok_j, tok_t = jbert.WhitespaceTokenizer(6), tbert.WhitespaceTokenizer(6)
    for texts in (PAIRS[0], PAIRS[1], [], [""]):
        a, b = tok_j(texts), tok_t(texts)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[k], b[k])
    enc = tok_t(PAIRS[1])
    idf = tbert._compute_idf(enc["input_ids"], enc["attention_mask"])
    assert idf == jbert._compute_idf(enc["input_ids"], enc["attention_mask"])
    np.testing.assert_array_equal(tbert._idf_weights(enc["input_ids"], enc["attention_mask"], idf),
                                  jbert._idf_weights(enc["input_ids"], enc["attention_mask"], idf))
    np.testing.assert_array_equal(tbert._process_special_tokens_mask(enc["attention_mask"]),
                                  jbert._process_special_tokens_mask(enc["attention_mask"]))


@pytest.mark.parametrize("idf", [False, True])
def test_bert_score_hash_embedder(idf):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jft.bert_score(*PAIRS, idf=idf, return_hash=True)
        got = tft.bert_score(*PAIRS, idf=idf, return_hash=True, **CPU)
    assert got["hash"] == want["hash"]
    for k in ("precision", "recall", "f1"):
        assert got[k].dtype == torch.float32
        _close(got[k], want[k], TENSOR_TOL)


def test_bert_score_user_model():
    def j_model(ids, mask):
        return jbert._hash_embedding_model(ids, mask, 48) + 0.01 * jnp.asarray(ids)[..., None]

    def t_model(ids, mask):
        return tbert._hash_embedding_model(ids, mask, 48) + 0.01 * ids[..., None]

    want = jft.bert_score(*PAIRS, model=j_model, idf=True)
    got = tft.bert_score(*PAIRS, model=t_model, idf=True, **CPU)
    for k in ("precision", "recall", "f1"):
        _close(got[k], want[k], TENSOR_TOL)


def test_bert_errors():
    with pytest.raises(NotImplementedError, match="all_layers"):
        tft.bert_score(["a"], ["a"], all_layers=True, **CPU)
    with pytest.raises(NotImplementedError, match="rescale_with_baseline"):
        tt.BERTScore(rescale_with_baseline=True, **CPU)
    with pytest.raises(ValueError, match="same"):
        tft.bert_score(["a"], ["a", "b"], model=tbert._hash_embedding_model, **CPU)
    with pytest.raises(OSError):  # a checkpoint the user named loads locally or raises; nothing is downloaded
        tft.bert_score(["a"], ["a"], model_name_or_path="no-such-checkpoint-anywhere", **CPU)


def test_bert_class_hash_embedder():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, tm = jt.BERTScore(idf=True), tt.BERTScore(idf=True, **CPU)
        for i in range(2):
            jm.update(PAIRS[0][2 * i:2 * i + 2], PAIRS[1][2 * i:2 * i + 2])
            tm.update(PAIRS[0][2 * i:2 * i + 2], PAIRS[1][2 * i:2 * i + 2])
        _assert_states(tm, jm)
        want, got = jm.compute(), tm.compute()
        for k in ("precision", "recall", "f1"):
            _close(got[k], want[k], TENSOR_TOL)
        tm2 = _round_trip(lambda: tt.BERTScore(idf=True, **CPU), jm)  # (each instance's tokenizer has its own vocab)
        for k, w in jm.compute().items():
            _close(tm2.compute()[k], w, TENSOR_TOL)
        empty = tt.BERTScore(**CPU).compute()
        assert all(tuple(v.shape) == (0,) for v in empty.values())


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted({w.lower() for s in PAIRS[0] + PAIRS[1]
                                                                  for w in s.split()}) + ["extra", "tokens"]


def _tiny_checkpoint(tmp_path_factory, name, masked_lm):
    from transformers import BertConfig, BertForMaskedLM, BertModel, BertTokenizer

    d = tmp_path_factory.mktemp(name)
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d))
    cfg = BertConfig(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=64, max_position_embeddings=64)
    torch.manual_seed(0)
    (BertForMaskedLM if masked_lm else BertModel)(cfg).eval().save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    return _tiny_checkpoint(tmp_path_factory, "tiny_bert", masked_lm=False)


@pytest.fixture(scope="module")
def tiny_mlm(tmp_path_factory):
    return _tiny_checkpoint(tmp_path_factory, "tiny_mlm", masked_lm=True)


@pytest.mark.parametrize("idf", [False, True])
def test_bert_score_checkpoint(tiny_bert, idf):
    """One checkpoint for both: torch ``AutoModel`` in the port, ``FlaxAutoModel(from_pt=True)`` in JAX."""
    kw = {"model_name_or_path": tiny_bert, "num_layers": 2, "max_length": 32, "idf": idf}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jft.bert_score(*PAIRS, **kw)
        got = tft.bert_score(*PAIRS, **kw, **CPU)
        jm, tm = jt.BERTScore(**kw), tt.BERTScore(**kw, **CPU)
    for k in ("precision", "recall", "f1"):
        _close(got[k], want[k], (1e-5, 1e-6))
    jm.update(*PAIRS)
    tm.update(*PAIRS)
    _assert_states(tm, jm)
    for k, w in jm.compute().items():
        _close(tm.compute()[k], w, (1e-5, 1e-6))


# ---------------------------------------------------------------- InfoLM

MEASURES = [("kl_divergence", None, None), ("alpha_divergence", 0.5, None), ("beta_divergence", None, 0.5),
            ("ab_divergence", 0.5, 0.5), ("renyi_divergence", 0.5, None), ("l1_distance", None, None),
            ("l2_distance", None, None), ("l_infinity_distance", None, None), ("fisher_rao_distance", None, None)]


@pytest.mark.parametrize(("measure", "alpha", "beta"), MEASURES, ids=[m[0] for m in MEASURES])
def test_information_measures(measure, alpha, beta):
    rng = np.random.default_rng(150)
    p, t = (rng.dirichlet(np.full(50, 0.5), 6).astype(np.float32) for _ in range(2))
    want = jinfolm._InformationMeasure(measure, alpha, beta)(jnp.asarray(p), jnp.asarray(t))
    got = tinfolm._InformationMeasure(measure, alpha, beta)(torch.tensor(p), torch.tensor(t))
    _close(got, want, TENSOR_TOL)


def test_measure_arguments_are_checked_as_in_jax():
    for args in (("nope", None, None), ("alpha_divergence", None, None), ("alpha_divergence", 1.0, None),
                 ("beta_divergence", None, -1.0), ("ab_divergence", 0.5, -0.5), ("renyi_divergence", 1.0, None)):
        with pytest.raises(ValueError):
            jinfolm._InformationMeasure(*args)
        with pytest.raises(ValueError):
            tinfolm._InformationMeasure(*args)
        with pytest.raises(ValueError):
            tt.InfoLM(information_measure=args[0], alpha=args[1], beta=args[2], **CPU)


@pytest.mark.parametrize("idf", [False, True])
def test_sentence_distribution_and_hash_lm(idf):
    rng = np.random.default_rng(151)
    ids = rng.integers(0, 300, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 4:] = 0
    w = rng.random((3, 7)).astype(np.float32) if idf else None
    want_lm = jinfolm._hash_lm(jnp.asarray(ids), jnp.asarray(mask), 64)
    got_lm = tinfolm._hash_lm(torch.tensor(ids), torch.tensor(mask), 64)
    _close(got_lm, want_lm, TENSOR_TOL)
    logits = rng.standard_normal((3, 7, 64)).astype(np.float32)
    want = jinfolm._sentence_distribution(jnp.asarray(logits), jnp.asarray(mask), None if w is None else jnp.asarray(w))
    got = tinfolm._sentence_distribution(torch.tensor(logits), torch.tensor(mask), None if w is None else torch.tensor(w))
    _close(got, want, TENSOR_TOL)


@pytest.mark.parametrize(("measure", "alpha", "beta"), MEASURES, ids=[m[0] for m in MEASURES])
def test_infolm_hash_lm(measure, alpha, beta):
    kw = {"information_measure": measure, "alpha": alpha, "beta": beta, "idf": measure == "kl_divergence",
          "temperature": 0.05, "return_sentence_level_score": True}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_score, j_sent = jft.infolm(*PAIRS, **kw)
        t_score, t_sent = tft.infolm(*PAIRS, **kw, **CPU)
    # Fisher-Rao's arccos has slope 1 / sqrt(1 - x^2) at sum(sqrt(p t)) = x near 1, about 70 here: float32's
    # rounding of the sum (6e-8) becomes 4e-6 of a 0.02 result, and the hash LM's two softmaxes differ by more
    tol = (1e-3, 1e-6) if measure == "fisher_rao_distance" else (1e-5, 1e-6)
    _close(t_sent, j_sent, tol)
    _close(t_score, j_score, tol)


@pytest.mark.parametrize("idf", [False, True])
def test_infolm_checkpoint(tiny_mlm, idf):
    """The per-position masking through one checkpoint: torch ``AutoModelForMaskedLM`` in the port, Flax in JAX."""
    kw = {"model_name_or_path": tiny_mlm, "idf": idf, "max_length": 16, "information_measure": "l2_distance"}
    j_score, j_sent = jft.infolm(*PAIRS, return_sentence_level_score=True, **kw)
    t_score, t_sent = tft.infolm(*PAIRS, return_sentence_level_score=True, **kw, **CPU)
    _close(t_sent, j_sent, (1e-5, 1e-6))
    for texts in PAIRS:
        enc = tinfolm._load_hf_mlm(tiny_mlm)[0](texts, padding="max_length", max_length=16, truncation=True,
                                                 return_tensors="np")
        args = (enc["input_ids"], enc["attention_mask"], 0.25, idf)
        _close(tinfolm._hf_data_distribution(tiny_mlm, *args, device=torch.device("cpu")),
               jinfolm._hf_data_distribution(tiny_mlm, *args), (1e-5, 1e-7))
    jm, tm = jt.InfoLM(return_sentence_level_score=True, **kw), tt.InfoLM(return_sentence_level_score=True, **kw,
                                                                         **CPU)
    jm.update(*PAIRS)
    tm.update(*PAIRS)
    for g, w in zip(tm.compute(), jm.compute()):
        _close(g, w, (1e-5, 1e-6))
    _round_trip(lambda: tt.InfoLM(return_sentence_level_score=True, **kw, **CPU), jm)


# ---------------------------------------------------------------- DistinctNGrams


@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("ignore_index", [None, 0])
def test_distinct_ngrams(ngram, ignore_index):
    jm, tm = jt.DistinctNGrams(ngram, ignore_index), tt.DistinctNGrams(ngram, ignore_index, **CPU)
    rng = np.random.default_rng(160 + ngram)
    for shape in ((3, 9), (12,), (2, 5)):
        ids = rng.integers(0, 6, shape).astype(np.int32)
        jm.update(jnp.asarray(ids))
        tm.update(torch.tensor(ids))
    _assert_states(tm, jm)
    _close(tm.compute(), jm.compute(), HOST_TOL)
    _round_trip(lambda: tt.DistinctNGrams(ngram, ignore_index, **CPU), jm, rng.integers(0, 6, (2, 7)).astype(np.int32))


def test_distinct_errors():
    # the HyperLogLog mode is ported; approx_error without approx stays refused, as in JAX
    assert tt.DistinctNGrams(approx="sketch", **CPU)._defaults["registers"].shape == (2048,)
    with pytest.raises(ValueError, match="approx_error"):
        tt.DistinctNGrams(approx_error=0.01, **CPU)
    with pytest.raises(ValueError, match="ngram"):
        tt.DistinctNGrams(0, **CPU)
    with pytest.raises(ValueError, match="at least 3"):
        tt.DistinctNGrams(3, **CPU).update(torch.tensor([[1, 2]]))



def test_empty_embedding_metrics():
    """BERTScore's and InfoLM's empty corpora: empty scores, and InfoLM's mean of none, as in JAX."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, got = jft.bert_score([], []), tft.bert_score([], [], **CPU)
        for k in ("precision", "recall", "f1"):
            assert tuple(got[k].shape) == np.asarray(want[k]).shape == (0,)
        j_score, j_sent = jft.infolm([], [], idf=False, return_sentence_level_score=True)
        t_score, t_sent = tft.infolm([], [], idf=False, return_sentence_level_score=True, **CPU)
    assert tuple(t_sent.shape) == np.asarray(j_sent).shape == (0,)
    _close(t_score, j_score, EXACT, equal_nan=True)
