"""SacreBLEU: BLEU with canonical tokenizers (counterpart of
``torchmetrics_tpu/functional/text/sacre_bleu.py``).

Tokenizers: ``13a`` (mteval-v13a), ``zh``, ``intl`` (unicode-punctuation
aware), ``char`` and ``none``, copied from the JAX package (host Python).
``ja-mecab`` and ``ko-mecab`` need the mecab native tokenizers and raise, as
in the JAX package.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.sacre_bleu import sacre_bleu_score
    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
    >>> round(float(sacre_bleu_score(preds, target)), 4)
    0.7598
"""

from __future__ import annotations

import re
import unicodedata
from functools import lru_cache
from typing import Optional, Sequence

from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bleu import _corpus_bleu

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char", "ja-mecab", "ko-mecab")


class _SacreBLEUTokenizer:
    """Host-side tokenizer registry."""

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Unsupported tokenizer selected. Please, choose one of {list(AVAILABLE_TOKENIZERS)}")
        if tokenize in ("ja-mecab", "ko-mecab"):
            raise ModuleNotFoundError(
                f"Tokenizer `{tokenize}` requires the mecab native tokenizers which are not installed."
            )
        self.tokenize_name = tokenize
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized = getattr(self, f"_tokenize_{self.tokenize_name.replace('-', '_')}")(line)
        if self.lowercase:
            tokenized = [t.lower() for t in tokenized]
        return tokenized

    @staticmethod
    def _tokenize_none(line: str) -> Sequence[str]:
        return line.strip().split()

    @staticmethod
    def _tokenize_13a(line: str) -> Sequence[str]:
        # mteval-v13a normalization
        line = line.replace("<skipped>", "")
        line = line.replace("-\n", "")
        line = line.replace("\n", " ")
        line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        line = f" {line} "
        line = re.sub(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", line)
        line = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", line)
        line = re.sub(r"([\.,])([^0-9])", r" \1 \2", line)
        line = re.sub(r"([0-9])(-)", r"\1 \2 ", line)
        return line.strip().split()

    @staticmethod
    def _tokenize_intl(line: str) -> Sequence[str]:
        """Unicode-aware punctuation splitting (mteval international mode).

        Mirrors sacrebleu's ``(\\P{N})(\\p{P})`` / ``(\\p{P})(\\P{N})`` and
        ``\\p{S}`` rules with character classes built per-line from unicodedata
        (python ``re`` lacks \\p{...} properties).
        """
        puncts = {ch for ch in line if unicodedata.category(ch).startswith("P")}
        symbols = {ch for ch in line if unicodedata.category(ch).startswith("S")}
        if puncts:
            p_cls = "[" + re.escape("".join(puncts)) + "]"
            line = re.sub(rf"(\D)({p_cls})", r"\1 \2 ", line)
            line = re.sub(rf"({p_cls})(\D)", r" \1 \2", line)
        if symbols:
            s_cls = "[" + re.escape("".join(symbols)) + "]"
            line = re.sub(rf"({s_cls})", r" \1 ", line)
        return line.strip().split()

    @staticmethod
    def _tokenize_char(line: str) -> Sequence[str]:
        return list(line.strip())

    @staticmethod
    def _tokenize_zh(line: str) -> Sequence[str]:
        """Separate CJK ideographs into single tokens; latin runs stay words."""
        line = line.strip()
        out = []
        for ch in line:
            if _is_chinese_char(ch):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return _SacreBLEUTokenizer._tokenize_13a("".join(out))


@lru_cache(maxsize=4096)
def _is_chinese_char(ch: str) -> bool:
    cp = ord(ch)
    return any(
        lo <= cp <= hi
        for lo, hi in (
            (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
            (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
        )
    )


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
) -> Tensor:
    """SacreBLEU corpus score."""
    return _corpus_bleu(preds, target, n_gram, smooth, weights, _SacreBLEUTokenizer(tokenize, lowercase))
