"""Carry a JAX metric's state into the port.

Metrics have no weights: what crosses between the two packages is the state
pytree. The JAX side turns its state into numpy first
(``{k: np.asarray(v) for k, v in state.items()}``, list states as lists of
arrays); :func:`state_from_jax` checks it against the port metric's spec and
places it on the metric's device. A synced JAX state loads the same way.
Every state kind of the port carries over: int32 counters and binned curve
states, float32 sums, the cat lists of the exact curves, ``CatMetric`` and
the rank correlations, Pearson's moments, the aggregators' values and
ring buffers (with their ``_n`` counter, which picks the next slot), the
calibration bins (``conf_sum`` float32, ``acc_sum`` and ``count`` int32),
the fairness counters (float32 per group), the hinge and ranking sums,
the exact-match sums or samplewise cat list, retrieval's three cat lists
(indexes, preds, target), PSNR's float32 sums with its int32 pixel count
and target extremes (or its cat lists with ``dim``), PSNR-B's sums, SSIM's
and MS-SSIM's sums or cat lists (with the full maps or contrast
sensitivities), the spectral metrics' cat lists (D-s and QNR with ``ms``,
``pan`` and ``pan_lr``), VIF's sums and total variation's sums or score
list, the segmentation scores' float32 sums and sample counts, nominal
association's float32 ``(C, C)`` table, ``FleissKappa``'s int32 count list,
the clustering metrics' cat lists of labels, or of data and labels, and the
text metrics' states: the error rates' float32 sums (``EditDistance``'s int32
sums or distance list), BLEU's and SacreBLEU's numerator, denominator and
lengths, chrF's count arrays and sentence list, EED's sentence list, TER's and
SQuAD's sums, Perplexity's ``total_log_probs`` and ``count``, BERTScore's
four cat lists of int32 ids and masks, InfoLM's score list and
``DistinctNGrams``' n-gram rows and total.
:func:`collection_states_from_jax` does it for every member state of a
``MetricCollection`` (``{leader name: state}``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import _N, Metric, State
from torchmetrics_tpu_torch.utilities.data import to_tensor
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError


def state_from_jax(metric: Metric, np_state: Mapping[str, Any]) -> State:
    """The port's state for ``metric`` from a JAX state of numpy arrays.

    The dtypes stay the JAX ones (int32 stays int32, float32 stays float32);
    a list (cat) leaf, a list or tuple of arrays, becomes a tuple of tensors
    of the same dtypes, 64-bit types narrowed as the JAX package runs. A leaf
    whose kind, dtype or shape does not match the port's spec raises
    :class:`StateRestoreError`, as does a missing or unknown leaf.
    """
    expected = set(metric._defaults) | {_N}
    missing, unknown = sorted(expected - set(np_state)), sorted(set(np_state) - expected)
    if missing or unknown:
        raise StateRestoreError(
            f"JAX state does not match {type(metric).__name__}: missing {missing}, unknown {unknown}",
            leaf=(missing or unknown)[0],
            reason="unknown-leaf" if unknown else "missing-leaf",
        )
    counter = np.asarray(np_state[_N])
    if counter.shape != () or counter.dtype != np.int32:
        raise StateRestoreError(
            f"Counter {_N!r} must be an int32 scalar, got {counter.dtype} of shape {counter.shape}",
            leaf=_N,
            reason="dtype",
        )
    state: State = {_N: torch.tensor(counter, device=metric.device)}
    for name in metric._defaults:
        # copies: the port's state never shares memory with the JAX buffers
        value = np_state[name]
        if isinstance(value, (list, tuple)):
            state[name] = metric._validate_leaf(name, [to_tensor(np.array(v), metric.device) for v in value])
        else:
            state[name] = metric._validate_leaf(name, np.array(value))
    return state


def collection_states_from_jax(collection: Any, np_states: Mapping[str, Mapping[str, Any]]) -> Dict[str, State]:
    """The port's ``{leader name: state}`` for a ``MetricCollection`` from the
    JAX collection's per-member numpy states (``init_states``'s keys)."""
    unknown = sorted(set(np_states) - set(collection.keys(keep_base=True)))
    if unknown:
        raise StateRestoreError(f"JAX collection states name unknown members {unknown}", leaf=unknown[0],
                                reason="unknown-leaf")
    return {name: state_from_jax(collection[name], st) for name, st in np_states.items()}
