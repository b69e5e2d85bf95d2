"""Exception types (counterpart of ``torchmetrics_tpu/utilities/exceptions.py``)."""

from __future__ import annotations

from typing import Optional, Sequence


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API."""


class StateRestoreError(TorchMetricsUserError):
    """A state dict failed validation before being installed.

    Raised by ``Metric.load_state_dict`` and ``convert.state_from_jax`` when a
    leaf's kind, shape or dtype does not match the metric it is loaded into,
    before any state leaf is touched.

    Attributes:
        leaf: name of the offending state leaf.
        reason: mismatch category: ``"kind"``, ``"shape"``, ``"dtype"``,
            ``"unknown-leaf"`` or ``"mesh-shape"`` (a ``SyncStepper``
            snapshot restored onto another world size).
        mesh_shape: the world size the snapshot was taken in, when known.
    """

    def __init__(self, message: str, leaf: Optional[str] = None, reason: Optional[str] = None,
                 mesh_shape: Optional[tuple] = None) -> None:
        super().__init__(message)
        self.leaf = leaf
        self.reason = reason
        self.mesh_shape = mesh_shape


class ReplicaDivergenceError(TorchMetricsUserError):
    """Metric state disagrees across ranks that must agree.

    Raised by ``parallel.ragged.sync_ragged_states(verify_consistency=True)``
    when the ranks' update counts differ: a lost or repeated step would
    silently skew the gathered aggregate.

    Attributes:
        leaves: names of the state leaves that diverged.
        replicas: ranks that disagree with the majority.
    """

    def __init__(self, message: str, *, leaves: Sequence[str] = (), replicas: Optional[Sequence[int]] = None) -> None:
        super().__init__(message)
        self.leaves = tuple(leaves)
        self.replicas = None if replicas is None else tuple(replicas)
