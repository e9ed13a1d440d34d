"""Device-mesh utilities: block-sharded map state.

The reference's parallelism is one OpenMP ``parallel for`` over blocks per
phase (bgkoctomap.cpp:250-283) in shared memory.  The device analog
shards the *block axis* of every pool array over a 1-D ``Mesh`` — each
device owns a contiguous slab of block slots — and runs the per-scan fused
update under ``jit`` with GSPMD shardings, so the kernel evaluation is
embarrassingly parallel over blocks and the scatter back into the pool
stays device-local when the test-block batch is aligned to slot ownership.

Cross-block coupling (ExtendedBlock reads of neighbor training points,
kernel support ℓ) is resolved host-side at bucketing time: each test-block
row carries its full neighborhood's training data, so no device-side halo
exchange is needed for correctness.  The scan-batch axis is sharded too;
XLA inserts the all-to-all for rows whose target slot lives elsewhere.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def block_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the block axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("blocks",))


def pool_sharding(mesh: Mesh) -> NamedSharding:
    """Pool arrays [capacity, V]: shard the slot axis."""
    return NamedSharding(mesh, P("blocks", None))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Per-scan bucket arrays [B, ...]: shard the test-block axis."""
    return NamedSharding(mesh, P(*(("blocks",) + (None,) * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
