"""Input and behaviour checks (counterpart of ``torchmetrics_tpu/utilities/checks.py``).

:func:`check_forward_full_state_property` tests empirically whether
``full_state_update=False`` is safe for a metric class and times both paths;
:func:`_input_format_classification` is the reference-named alias of
:func:`~torchmetrics_tpu_torch.utilities.formatting.classify_inputs`.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.utilities.checks import _input_format_classification
    >>> p, t, case = _input_format_classification(torch.tensor([0.2, 0.8]), torch.tensor([0, 1]))
    >>> case.value, p.tolist(), t.tolist()
    ('binary', [[0], [1]], [[0], [1]])
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.prints import rank_zero_info


def _host(value: Any) -> np.ndarray:
    """A metric's output as a numpy array on the host (tensors of any device)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def check_forward_full_state_property(
    metric_class: type,
    init_args: Optional[Dict[str, Any]] = None,
    input_args: Optional[Dict[str, Any]] = None,
    num_update_to_compare: int = 10,
    reps: int = 3,
) -> None:
    """Empirically check that ``full_state_update=False`` matches ``True`` and time both.

    Instantiates the metric twice with ``full_state_update`` overridden to
    True and False, runs ``forward`` ``num_update_to_compare`` times with
    ``input_args`` on each and requires every batch value and the final
    ``compute()`` to match (``atol=1e-6``); then logs wall-clock timings of
    both with ``rank_zero_info``. Raises ``RuntimeError`` on a mismatch.
    """
    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):  # type: ignore[misc, valid-type]
        full_state_update = True

    class PartialState(metric_class):  # type: ignore[misc, valid-type]
        full_state_update = False

    full = FullState(**init_args)
    partial_state = PartialState(**init_args)

    for i in range(num_update_to_compare):
        out1 = full(**input_args)
        out2 = partial_state(**input_args)
        if not np.allclose(_host(out1), _host(out2), atol=1e-6, equal_nan=True):
            raise RuntimeError(
                f"The metric {metric_class.__name__} cannot safely set `full_state_update=False`: "
                f"forward outputs diverge on update {i}: {out1} vs {out2}."
            )
    # the accumulated states are where the two paths can actually diverge
    # (update-twice vs compute-batch-then-merge): compare the final compute()
    res1, res2 = full.compute(), partial_state.compute()
    if not np.allclose(_host(res1), _host(res2), atol=1e-6, equal_nan=True):
        raise RuntimeError(
            f"The metric {metric_class.__name__} cannot safely set `full_state_update=False`: "
            f"accumulated compute() diverges: {res1} vs {res2}."
        )

    def _time(m_cls: type) -> float:
        best = float("inf")
        for _ in range(reps):
            m = m_cls(**init_args)
            start = time.perf_counter()
            for _ in range(num_update_to_compare):
                m(**input_args)
            if m.device.type == "cuda":
                torch.cuda.synchronize(m.device)
            best = min(best, time.perf_counter() - start)
        return best

    t_full = _time(FullState)
    t_partial = _time(PartialState)
    rank_zero_info(
        f"Full state for {metric_class.__name__} metric took: {t_full:.4f}s per {num_update_to_compare} steps\n"
        f"Partial state for {metric_class.__name__} metric took: {t_partial:.4f}s per {num_update_to_compare} steps"
    )
    faster = t_partial < t_full
    rank_zero_info(f"Recommended setting `full_state_update={not faster}`")


def _input_format_classification(preds, target, threshold=0.5, top_k=None, num_classes=None, multiclass=None,
                                 ignore_index=None):
    """Reference-named alias of :func:`~torchmetrics_tpu_torch.utilities.formatting.classify_inputs`."""
    from torchmetrics_tpu_torch.utilities.formatting import classify_inputs

    return classify_inputs(
        preds, target, threshold=threshold, top_k=top_k, num_classes=num_classes,
        multiclass=multiclass, ignore_index=ignore_index,
    )
