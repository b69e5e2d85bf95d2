"""Carry a JAX metric's state into the port.

Metrics have no weights: what crosses between the two packages is the state
pytree. The JAX side turns its state into numpy first
(``{k: np.asarray(v) for k, v in state.items()}``, list states as lists of
arrays); :func:`state_from_jax` checks it against the port metric's spec and
places it on the metric's device.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from torchmetrics_tpu_torch.core.metric import _N, Metric, State
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError


def state_from_jax(metric: Metric, np_state: Mapping[str, Any]) -> State:
    """The port's state for ``metric`` from a JAX state of numpy arrays.

    The dtypes stay the JAX ones (int32 stays int32, float32 stays float32);
    a leaf whose dtype or shape does not match the port's spec raises
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
            value = [np.array(v) for v in value]
        else:
            value = np.array(value)
        state[name] = metric._validate_leaf(name, value)
    return state
