"""Multi-host initialization for block-sharded mapping.

The reference has no distributed backend (single ROS process + OpenMP).
Here, long-horizon mapping shards the block pool over all devices of one or
more hosts: call :func:`initialize` once per host process, then build a
``ShardedBGKOctoMap`` on :func:`global_mesh`.

Host-side scan ingestion is replicated (every host parses the scan and
builds the same bucket tables — deterministic), so no host-to-host data
exchange is needed beyond XLA's own collectives: the batch→owner-slot
scatter runs as NCCL collectives, over NVLink between the GPUs of one host
and over the network between hosts.
"""

from __future__ import annotations

import jax

from la3dm_tpu.parallel import mesh as pm


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize with env-var fallback (JAX_COORDINATOR etc.)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh() -> "jax.sharding.Mesh":
    """1-D block mesh over every device of the slice (all hosts)."""
    return pm.block_mesh(devices=jax.devices())
