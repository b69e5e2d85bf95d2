"""Cross-process sync of metric state (counterpart of ``torchmetrics_tpu/parallel``).

The JAX package syncs inside a jitted step over a named mesh axis; the port
syncs eagerly over ``torch.distributed``'s default process group, one rank
per device. Each rank updates on its own shard and the sync combines the
states: :func:`sync_state` (one collective per (dtype, op) bucket, the
coalescing planner of :mod:`.coalesce`, with compressed and sharded buckets
and the quarantine weight), :func:`sync_ragged_states` (the pad-gather-trim
of variable-length list states, :mod:`.ragged`). :class:`SyncPolicy`,
:class:`SyncStepper` and :class:`DeferredRaggedSync` defer the collective
to every ``k`` steps or to compute. JAX's ``SyncAdvisor`` and
``SyncAutotuner`` wait for the observability and compile slices.
"""

from torchmetrics_tpu_torch.parallel.coalesce import (
    Bucket,
    SyncPlan,
    SyncPolicy,
    SyncStepper,
    apply_sync_plan,
    bucketed_collective_count,
    build_sync_plan,
    cadence_stepper,
    coalesced_host_sync,
    coalesced_metric_sync,
    coalesced_sync_state,
    flush_sync,
    per_leaf_collective_count,
)
from torchmetrics_tpu_torch.parallel.compress import CompressionConfig, CompressionSpec
from torchmetrics_tpu_torch.parallel.ragged import DeferredRaggedSync, sharded_list_update, sync_ragged_states
from torchmetrics_tpu_torch.parallel.sync import (
    distributed_available,
    gather_all_arrays,
    host_sync_state,
    reduce,
    reduce as reduce_op,
    sharded_collection_update,
    sharded_update,
    sync_state,
)

__all__ = [
    "Bucket",
    "CompressionConfig",
    "CompressionSpec",
    "DeferredRaggedSync",
    "SyncPlan",
    "SyncPolicy",
    "SyncStepper",
    "apply_sync_plan",
    "bucketed_collective_count",
    "build_sync_plan",
    "cadence_stepper",
    "coalesced_host_sync",
    "coalesced_metric_sync",
    "coalesced_sync_state",
    "distributed_available",
    "flush_sync",
    "gather_all_arrays",
    "host_sync_state",
    "per_leaf_collective_count",
    "reduce",
    "reduce_op",
    "sharded_collection_update",
    "sharded_list_update",
    "sharded_update",
    "sync_ragged_states",
    "sync_state",
]
