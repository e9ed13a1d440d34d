"""Block-sharded occupancy maps over a device mesh.

``ShardedBGKOctoMap`` / ``ShardedBGKLOctoMap`` distribute the block pool's
slot axis over a 1-D ``Mesh`` and run the fused scan update under GSPMD:
the per-block kernel evaluation parallelizes over the batch axis, and the
pool scatter executes against the sharded state.  Slot allocation
round-robins new blocks across device chunks so *active* blocks — not just
addresses — balance across the mesh (sensor sweeps concentrate work in few
blocks; SURVEY.md §7 hard parts).

Cross-block coupling (ExtendedBlock training-point reads within kernel
support ℓ) is resolved at bucketing time — each test-block row already
carries its 7-neighborhood's points — so the only cross-device traffic is
the batch-row → owner-slot scatter, which XLA lowers to an all-to-all
between the mesh's devices.

The pool capacity is fixed at construction (growth would re-layout every
shard); pick capacity ≥ expected block count.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from la3dm_tpu.geometry import blocks as geo
from la3dm_tpu.models import base
from la3dm_tpu.models.bgk import BGKOctoMap
from la3dm_tpu.models.bgkl import BGKLOctoMap
from la3dm_tpu.models.bgklv import BGKLVOctoMap
from la3dm_tpu.models.gp import GPOctoMap
from la3dm_tpu.parallel import mesh as pm
from la3dm_tpu.utils.config import MapConfig


class ShardedBlockPool(base.BlockPool):
    """Load-aware device placement; grows by resharding.

    New blocks are placed on the device with the least **accumulated work**
    (``ensure`` weights — entry/tile counts supplied by the engines), not
    round-robin by address: sensor sweeps concentrate work in few blocks, so
    balancing block *count* alone leaves touched-voxel skews of 4-5× on the
    LV family (SURVEY §7 hard part; the reference's analogue is the OpenMP
    ``schedule(dynamic)`` at bgkoctomap.cpp:250-252).  Repeat references to
    existing blocks keep accumulating onto their device's load, so later
    placement decisions see the true work distribution.

    Growth doubles capacity and re-lays-out every shard: slot s on device
    d = s // chunk at offset o = s % chunk moves to d·new_chunk + o — device
    residency (and the accumulated loads) are preserved, a device-side
    gather re-places all per-block rows, and the host key→slot dict is
    rebuilt.  Growth happens between scans (``ensure`` runs host-side), so
    jitted step shapes change only at that boundary — one recompile per
    doubling, like the unsharded pool.
    """

    def __init__(self, voxels_per_block, fields, capacity, mesh):
        n_dev = len(mesh.devices.flat)
        capacity = base.round_up(capacity, n_dev)
        super().__init__(voxels_per_block, fields, capacity=capacity)
        self.mesh = mesh
        self.n_dev = n_dev
        self.chunk = self.capacity // n_dev
        self.sharding = pm.pool_sharding(mesh)
        for k in self.fields:
            self.fields[k] = jax.device_put(self.fields[k], self.sharding)
        self.touched = jax.device_put(self.touched, self.sharding)
        self.eff_level = jax.device_put(self.eff_level, self.sharding)
        #: per-device accumulated ensure-weight and resident block count
        self.dev_load = np.zeros(n_dev, np.float64)
        self._dev_count = np.zeros(n_dev, np.int64)

    def _grow(self, min_capacity):
        self.generation += 1  # invalidates previously returned slot ids
        new_cap = self.capacity
        while new_cap < min_capacity:
            new_cap *= 2
        new_chunk = new_cap // self.n_dev
        # slot s = (d, offset) keeps its device and offset under the new chunk
        keys = np.asarray(list(self._slot_of.keys()), np.int64)
        old_slots = np.asarray(list(self._slot_of.values()), np.int64)
        d = old_slots // self.chunk
        new_slots = d * new_chunk + old_slots % self.chunk
        self._relayout(new_slots, old_slots, keys, new_cap)

    def ensure(self, coords: np.ndarray,
               weights: np.ndarray | None = None) -> np.ndarray:
        """Slots for coords [N,3], placing new blocks on the least-loaded
        device.  ``weights`` [N] (work units — entries/tiles this scan) feed
        the load tracker for existing AND new blocks; None counts 1 per new
        block (pure count balance)."""
        keys = geo.pack_key(coords)
        missing, seen = [], set()
        for i, k in enumerate(keys):
            ki = int(k)
            if ki not in self._slot_of and ki not in seen:
                missing.append(i)
                seen.add(ki)
        if missing:
            if self.n_blocks + len(missing) > self.capacity:
                self._grow(self.n_blocks + len(missing))
            # longest-processing-time greedy: place the heaviest new blocks
            # first on the least-loaded device — near-optimal makespan, vs
            # arrival order which lets an early heavy block land anywhere
            if weights is not None:
                missing.sort(key=lambda i: -float(weights[i]))
            for i in missing:
                # least accumulated load among devices with free slots
                # (ties → fewer resident blocks, then lowest index)
                space = self._dev_count < self.chunk
                load = np.where(space, self.dev_load, np.inf)
                cand = np.flatnonzero(load == load.min())
                d = int(cand[np.argmin(self._dev_count[cand])])
                s = d * self.chunk + int(self._dev_count[d])
                self._dev_count[d] += 1
                if weights is None:
                    self.dev_load[d] += 1.0
                else:
                    self.dev_load[d] += float(weights[i])
                self._slot_of[int(keys[i])] = s
                self.coords[s] = coords[i]
                self.n_blocks += 1
        placed = set(missing)
        slots = np.empty(len(keys), dtype=np.int32)
        for i, k in enumerate(keys):
            slots[i] = self._slot_of[int(k)]
            if weights is not None and i not in placed:
                # accumulate repeat work onto the owning device's load
                self.dev_load[slots[i] // self.chunk] += float(weights[i])
        return slots

    def _relayout(self, new_slots: np.ndarray, old_slots: np.ndarray,
                  keys: np.ndarray, new_cap: int) -> None:
        """Move every block old→new slot with one sharded device gather."""
        new_chunk = new_cap // self.n_dev
        src = np.full(new_cap, self.capacity, np.int64)
        src[new_slots] = old_slots
        src_dev = jax.device_put(jnp.asarray(src), pm.replicated(self.mesh))

        def regather(arr, fill):
            padded = jnp.concatenate(
                [arr, jnp.full((1, self.V), fill, arr.dtype)])
            return jax.device_put(padded[src_dev], self.sharding)

        for name, arr in self.fields.items():
            self.fields[name] = regather(arr, self._fills[name])
        self.touched = regather(self.touched, False)
        self.eff_level = regather(self.eff_level, 0)
        new_coords = np.zeros((new_cap, 3), np.int64)
        new_coords[new_slots] = self.coords[old_slots]
        self.coords = new_coords
        self._slot_of = {int(k): int(s) for k, s in zip(keys, new_slots)}
        self.capacity = new_cap
        self.chunk = new_chunk

    def rebalance(self, block_load: np.ndarray) -> None:
        """Re-place every block by MEASURED per-slot load (LPT), then move
        the pool state with the reshard gather (SURVEY §7: balance *active*
        work, not addresses).

        Weight-predicted placement is first-touch — a block whose work turns
        out much larger than its ensure-weights (common for the LV family,
        where kernel reach per entry varies wildly) stays wherever it landed.
        This corrects placement against ground truth (e.g. per-slot touched-
        voxel counts) between scans; slot ids change (generation bump), which
        every engine already re-resolves across calls.
        """
        if self.n_blocks == 0:
            return
        self.generation += 1
        keys = np.asarray(list(self._slot_of.keys()), np.int64)
        old_slots = np.asarray(list(self._slot_of.values()), np.int64)
        loads = np.asarray(block_load, np.float64)[old_slots]
        order = np.argsort(-loads, kind="stable")
        dev_load = np.zeros(self.n_dev)
        dev_count = np.zeros(self.n_dev, np.int64)
        new_slots = np.empty(len(old_slots), np.int64)
        for j in order:
            space = dev_count < self.chunk
            masked = np.where(space, dev_load, np.inf)
            cand = np.flatnonzero(masked == masked.min())
            d = int(cand[np.argmin(dev_count[cand])])
            new_slots[j] = d * self.chunk + dev_count[d]
            dev_count[d] += 1
            dev_load[d] += loads[j]
        self._relayout(new_slots, old_slots, keys, self.capacity)
        self.dev_load = dev_load
        self._dev_count = dev_count

    def active_slots(self) -> np.ndarray:
        return np.fromiter(self._slot_of.values(), dtype=np.int32, count=self.n_blocks)


class _ShardedMixin:
    def __init__(self, cfg: MapConfig, mesh=None, capacity: int = 8192):
        self._mesh = mesh if mesh is not None else pm.block_mesh()
        self._capacity = capacity
        super().__init__(cfg)
        self._level_offsets = jax.device_put(
            self._level_offsets, pm.replicated(self._mesh))

    def _make_pool(self):
        return ShardedBlockPool(self.V, self.FIELD_FILLS, self._capacity, self._mesh)

    def rebalance(self) -> None:
        """Re-place blocks across devices by MEASURED touched-voxel load.

        Call between scans when the per-device skew matters (long-running
        servers, load-concentrated sweeps); one device-side reduce + one
        resharding gather.  Safe at any scan boundary — engines re-resolve
        slot ids per call via the pool generation protocol.
        """
        load = np.asarray(jnp.sum(self.pool.touched, axis=1))
        self.pool.rebalance(load)


class ShardedBGKOctoMap(_ShardedMixin, BGKOctoMap):
    """BGK map with the block pool sharded over a 1-D mesh."""


class ShardedBGKLOctoMap(_ShardedMixin, BGKLOctoMap):
    """BGKL map with the block pool sharded over a 1-D mesh."""


class ShardedGPOctoMap(_ShardedMixin, GPOctoMap):
    """GP map: batched Cholesky tiers parallelize over the model-batch axis;
    the BCM scatter addresses the sharded pool (all-to-all between devices)."""


class ShardedBGKLVOctoMap(_ShardedMixin, BGKLVOctoMap):
    """LV map: the tile engine's flat [capacity·V] pool views reshape a
    slot-sharded [capacity, V] array, so each device owns a contiguous flat
    slab and the per-tile scatter stays GSPMD-partitioned."""

    def __init__(self, cfg: MapConfig, mesh=None, capacity: int = 8192):
        super().__init__(cfg, mesh=mesh, capacity=capacity)
        # device-resident tile constants, replicated (lazily created in the
        # base class; eager + replicated here so jit sees consistent devices)
        import jax.numpy as jnp

        self._dev_consts = (
            jax.device_put(jnp.asarray(self._vox_base_t),
                           pm.replicated(self._mesh)),
        )
