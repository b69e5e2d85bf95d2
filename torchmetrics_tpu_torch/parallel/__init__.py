"""Cross-process sync of metric state (counterpart of ``torchmetrics_tpu/parallel``).

The JAX package syncs inside a jitted step over a named mesh axis; the port
syncs eagerly over ``torch.distributed``'s default process group, one rank
per device. Each rank updates on its own shard and the sync combines the
states: :func:`sync_state` (one collective per (dtype, op) bucket, the
coalescing planner of :mod:`.coalesce`), :func:`sync_ragged_states` (the
pad-gather-trim of variable-length list states, :mod:`.ragged`).
"""

from torchmetrics_tpu_torch.parallel.coalesce import (
    Bucket,
    SyncPlan,
    apply_sync_plan,
    build_sync_plan,
    coalesced_metric_sync,
    coalesced_sync_state,
)
from torchmetrics_tpu_torch.parallel.ragged import sync_ragged_states
from torchmetrics_tpu_torch.parallel.sync import (
    distributed_available,
    gather_all_arrays,
    host_sync_state,
    reduce,
    reduce as reduce_op,
    sharded_update,
    sync_state,
)

__all__ = [
    "Bucket",
    "SyncPlan",
    "apply_sync_plan",
    "build_sync_plan",
    "coalesced_metric_sync",
    "coalesced_sync_state",
    "distributed_available",
    "gather_all_arrays",
    "host_sync_state",
    "reduce",
    "reduce_op",
    "sharded_update",
    "sync_ragged_states",
    "sync_state",
]
