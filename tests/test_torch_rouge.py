"""The port's ROUGE, held against the JAX package's.

Tokenizing and scoring are the same host Python in both packages, so the
per-sample scores are equal floats and the states equal float32 items
exactly; the means ``rtol=1e-6`` (float32 sums in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmetrics_tpu.functional.text.helper import _count_ngram as j_count_ngram
from torchmetrics_tpu.functional.text.helper import _lcs_length as j_lcs_length
from torchmetrics_tpu.functional.text.helper import _lcs_members as j_lcs_members
from torchmetrics_tpu.functional.text.rouge import rouge_score as j_rouge_score
from torchmetrics_tpu.text import ROUGEScore as JaxROUGE
from torchmetrics_tpu_torch.functional.text.helper import _count_ngram, _lcs_length, _lcs_members, _lcs_table
from torchmetrics_tpu_torch.functional.text.rouge import rouge_score
from torchmetrics_tpu_torch.text import ROUGEScore

VOCAB = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "fast", "home", "Home.", "cat!"]
KEYS = ("rouge1", "rouge2", "rougeL", "rougeLsum")


def _corpus(seed, n, refs=1):
    rng = np.random.default_rng(seed)

    def sentence():
        words = list(rng.choice(VOCAB, int(rng.integers(0, 10))))
        if len(words) > 4 and rng.uniform() < 0.5:
            words[3] += "."  # two sentences, for ROUGE-Lsum
        return " ".join(words)

    preds = [sentence() for _ in range(n)]
    target = [[sentence() for _ in range(refs)] for _ in range(n)] if refs > 1 else [sentence() for _ in range(n)]
    return preds, target


def test_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = list(rng.choice(VOCAB, int(rng.integers(0, 12))))
        b = list(rng.choice(VOCAB, int(rng.integers(0, 12))))
        assert _lcs_length(a, b) == j_lcs_length(a, b)
        assert _lcs_members(a, b) == j_lcs_members(a, b)
        assert _count_ngram(a, 3) == j_count_ngram(a, 3)
        assert _lcs_table(a, b)[-1, -1] == _lcs_length(a, b)


@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("refs", [1, 3])
def test_rouge_score_parity(refs, accumulate):
    preds, target = _corpus(refs, 12, refs)
    want = j_rouge_score(preds, target, accumulate=accumulate, rouge_keys=KEYS)
    got = rouge_score(preds, target, accumulate=accumulate, rouge_keys=KEYS)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("keys", [KEYS, ("rouge1", "rougeL"), "rouge2"], ids=["all", "dryrun", "one"])
def test_rouge_metric_states_and_values(keys):
    jm, tm = JaxROUGE(rouge_keys=keys), ROUGEScore(rouge_keys=keys, device="cpu")
    for seed in range(3):
        preds, target = _corpus(10 + seed, seed + 2)
        jm.update(preds, target)
        tm.update(preds, target)
    for name, want in jm.metric_state.items():
        got = tm.metric_state[name]
        if name == "_n":
            assert int(got) == int(want) == 3
            continue
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k, w in jm.compute().items():
        np.testing.assert_allclose(tm.compute()[k].numpy(), np.asarray(w), rtol=1e-6, err_msg=k)


def test_single_strings_empty_and_bad_args():
    tm, jm = ROUGEScore(rouge_keys="rouge1", device="cpu"), JaxROUGE(rouge_keys="rouge1")
    assert float(tm.compute_state(tm.init_state())["rouge1_fmeasure"]) == 0.0
    tm.update("the cat is on the mat", "a cat is on the mat")
    jm.update("the cat is on the mat", "a cat is on the mat")
    np.testing.assert_allclose(tm.compute()["rouge1_fmeasure"].numpy(), np.asarray(jm.compute()["rouge1_fmeasure"]))
    with pytest.raises(ValueError):
        ROUGEScore(rouge_keys="rouge10", device="cpu")
    with pytest.raises(ValueError):
        ROUGEScore(accumulate="sum", device="cpu")
    # the reservoir is ported; a sample size below 1 stays refused, as in JAX
    assert set(ROUGEScore(approx="reservoir", device="cpu")._defaults) == {"corpus_sample", "samples_total"}
    with pytest.raises(ValueError, match="sample_size"):
        ROUGEScore(approx="reservoir", sample_size=0, device="cpu")
