"""Block pool and shared map machinery.

The reference keeps ``std::unordered_map<BlockHashKey, Block*>``
(``bgkoctomap.h:377``) of per-block pointer octrees.  Here the map is a
**dense block pool**: preallocated ``[capacity, n³]`` device arrays of
posterior state plus a host-side key→slot dict.  New blocks are allocated
host-side between scans; device code only ever sees static shapes.
"""

from __future__ import annotations

import enum
import functools
from typing import Iterable

import numpy as np
import jax
import jax.numpy as jnp

from la3dm_tpu.geometry import blocks as geo
from la3dm_tpu.models import pruning
from la3dm_tpu.utils.config import MapConfig


@functools.partial(
    jax.jit,
    static_argnames=("state_fn", "n", "max_level"),
    donate_argnames=("fields", "touched", "eff"),
)
def _prune_step(fields, touched, eff, slots, state_fn, n, max_level):
    """Gather the batch, collapse homogeneous sibling groups, scatter back.

    ``slots`` padded with pool.capacity (clamped gather, dropped scatter).
    """
    safe = jnp.minimum(slots, eff.shape[0] - 1)
    vals = {k: v[safe] for k, v in fields.items()}
    vals["touched"] = touched[safe].astype(jnp.float32)
    new_vals, new_eff = pruning.prune_blocks(vals, eff[safe], n=n,
                                             max_level=max_level, state_fn=state_fn)
    for k in fields:
        fields[k] = fields[k].at[slots].set(new_vals[k], mode="drop")
    touched = touched.at[slots].set(new_vals["touched"] > 0, mode="drop")
    eff = eff.at[slots].set(new_eff, mode="drop")
    return fields, touched, eff


@jax.jit
def _gather_point_vals(arr, slots, vidx):
    """Device-side per-point gather: ``arr[slots, vidx]`` with clamped slots.

    The query path fetches only the [N]-sized result — never the full
    [capacity, V] pool field (335 MB per field at depth-6/540-scan scale).
    """
    safe = jnp.clip(slots, 0, arr.shape[0] - 1)
    return arr[safe, vidx]


@jax.jit
def _gather_slot_rows(arr, slots):
    """Device-side block-row gather: ``arr[slots]`` with clamped slots."""
    return arr[jnp.minimum(slots, arr.shape[0] - 1)]


class State(enum.IntEnum):
    """Mirrors the reference State enum (+UNCERTAIN from the LV family)."""

    FREE = 0
    OCCUPIED = 1
    UNKNOWN = 2
    UNCERTAIN = 3


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 0)


class BlockPool:
    """Growable pool of per-block dense voxel arrays.

    ``fields`` maps name → fill value; every field is a float32 [cap, V]
    array except ``touched`` (bool) and ``eff_level`` (int8), which all
    families share.
    """

    def __init__(self, voxels_per_block: int, fields: dict[str, float],
                 capacity: int | None = None):
        self.V = voxels_per_block
        if capacity is None:
            # initial allocation ≤ ~32 MiB per field: deep trees (block_depth
            # 6 ⇒ V = 32768, the *_large_map configs) would otherwise eat
            # ~1 GiB per field before the first scan; growth doubles on demand
            capacity = max(256, min(8192, (1 << 23) // max(voxels_per_block, 1)))
        self.capacity = capacity
        self.n_blocks = 0
        self._slot_of: dict[int, int] = {}
        self.coords = np.zeros((capacity, 3), dtype=np.int64)  # host mirror
        self.fields = {
            name: jnp.full((capacity, self.V), fill, dtype=jnp.float32)
            for name, fill in fields.items()
        }
        self.touched = jnp.zeros((capacity, self.V), dtype=bool)
        self.eff_level = jnp.zeros((capacity, self.V), dtype=jnp.int8)
        self._fills = dict(fields)
        #: growth generation.  This pool's growth appends (slot ids are
        #: stable), so it never changes; the sharded pool bumps it on every
        #: _grow because growth there re-lays-out every slot.  Engines that
        #: cache slot ids across ensure() calls compare generations and
        #: re-resolve via lookup() when it moved.
        self.generation = 0

    def __len__(self) -> int:
        return self.n_blocks

    @property
    def nbytes(self) -> int:
        """Device bytes of the pool state: every field, touched, eff_level."""
        return (sum(a.nbytes for a in self.fields.values())
                + self.touched.nbytes + self.eff_level.nbytes)

    def _grow(self, min_capacity: int) -> None:
        new_cap = self.capacity
        while new_cap < min_capacity:
            new_cap *= 2
        pad = new_cap - self.capacity
        self.coords = np.concatenate([self.coords, np.zeros((pad, 3), np.int64)])
        for name, arr in self.fields.items():
            filler = jnp.full((pad, self.V), self._fills[name], dtype=arr.dtype)
            self.fields[name] = jnp.concatenate([arr, filler])
        self.touched = jnp.concatenate([self.touched, jnp.zeros((pad, self.V), bool)])
        self.eff_level = jnp.concatenate([self.eff_level, jnp.zeros((pad, self.V), jnp.int8)])
        self.capacity = new_cap

    def ensure(self, coords: np.ndarray,
               weights: np.ndarray | None = None) -> np.ndarray:
        """Get slots for integer block coords [N,3], allocating new blocks.

        ``weights`` [N] is advisory work-volume information for load-aware
        placement; the single-device pool ignores it (the sharded pool uses
        it to balance accumulated work across device chunks).
        """
        keys = geo.pack_key(coords)
        slots = np.empty(len(keys), dtype=np.int32)
        missing = []
        for i, k in enumerate(keys):
            s = self._slot_of.get(int(k), -1)
            slots[i] = s
            if s < 0:
                missing.append(i)
        if missing:
            need = self.n_blocks + len(missing)
            if need > self.capacity:
                self._grow(need)
            for i in missing:
                s = self.n_blocks
                self._slot_of[int(keys[i])] = s
                self.coords[s] = coords[i]
                slots[i] = s
                self.n_blocks += 1
        return slots

    def lookup(self, coords: np.ndarray) -> np.ndarray:
        """Slots for coords [N,3]; −1 where the block does not exist."""
        keys = geo.pack_key(coords)
        return np.array([self._slot_of.get(int(k), -1) for k in keys], dtype=np.int32)

    def active_slots(self) -> np.ndarray:
        return np.arange(self.n_blocks, dtype=np.int32)


class OccupancyMapBase:
    """Shared behavior of the four map families."""

    #: pool field names, set by subclasses (e.g. ("A", "B"))
    FIELD_FILLS: dict[str, float] = {}

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        self.n = cfg.cells_per_edge
        self.V = cfg.voxels_per_block
        self.block_size = cfg.block_size
        self.FIELD_FILLS = self._field_fills()
        self.pool = self._make_pool()
        # voxel-center offset tables per octree level, [L, V, 3]
        self._level_offsets = jnp.asarray(
            np.stack([geo.level_offsets(cfg.resolution, cfg.block_depth, L)
                      for L in range(cfg.block_depth)]), dtype=jnp.float32)
        self._neighbor_offsets = (
            geo.full_neighbor_offsets() if cfg.predict else geo.FACE_NEIGHBOR_OFFSETS
        )
        self.num_slots = len(self._neighbor_offsets)
        # stable jit keys: state_fn closures are created ONCE (a fresh closure
        # per call would miss the static-argnames cache and recompile per scan)
        self._state_fn = self._make_state_fn()
        #: perf counters (kernel_evals = training-entry × voxel pairs
        #: evaluated; host_s = wall time in host preprocessing/table building,
        #: i.e. everything before each device dispatch; query_fetch_bytes =
        #: device→host bytes materialized by search()/leaves() — the query
        #: paths gather on device and fetch O(result), never O(map);
        #: host_fallback_chunks = scan chunks that device ingestion handed to
        #: the host path, models/ingest.py)
        self.stats = {"kernel_evals": 0, "scans": 0, "host_s": 0.0,
                      "host_fallback_chunks": 0, "query_fetch_bytes": 0}

    def _fetch(self, arr) -> np.ndarray:
        """Materialize a device array on host, accounting the bytes."""
        out = np.asarray(arr)
        self.stats["query_fetch_bytes"] += out.nbytes
        return out

    def _make_state_fn(self):
        raise NotImplementedError

    def _field_fills(self) -> dict[str, float]:
        raise NotImplementedError

    def _make_pool(self) -> BlockPool:
        return BlockPool(self.V, self.FIELD_FILLS)

    def _prune(self, slots: np.ndarray) -> None:
        """Prune the updated blocks (reference prunes test blocks per scan)."""
        if self.cfg.block_depth <= 1 or len(slots) == 0:
            return
        B = len(slots)
        B_pad = next_pow2(max(B, 32))
        sl = np.full(B_pad, self.pool.capacity, np.int32)
        sl[:B] = slots
        new_fields, self.pool.touched, self.pool.eff_level = _prune_step(
            self.pool.fields, self.pool.touched, self.pool.eff_level,
            jnp.asarray(sl), self._state_fn, self.n, self.cfg.block_depth - 1)
        # jit flattens dicts key-sorted; restore the canonical field order
        self.pool.fields = {k: new_fields[k] for k in self.FIELD_FILLS}

    # -- geometry helpers -------------------------------------------------

    def block_centers(self, coords: np.ndarray) -> np.ndarray:
        return geo.block_center(coords, self.block_size)

    def eff_voxel_centers(self, slots: np.ndarray) -> np.ndarray:
        """World-frame eff-leaf centers [B, V, 3] for the given pool slots.

        Matches ``Block::get_point`` = key_loc offset + block center
        (bgkblock.cpp:137-139), at each voxel's owning-leaf level.
        """
        eff = self._gather_rows(self.pool.eff_level, slots)  # [B, V]
        table = np.asarray(self._level_offsets)       # [L, V, 3]
        off = np.take_along_axis(table[None], eff[:, None, :, None].astype(np.int64), axis=1)[:, 0]
        centers = self.block_centers(self.pool.coords[slots])
        return (off + centers[:, None, :]).astype(np.float32)

    # -- voxel-storage order ----------------------------------------------
    # Pools store each block's V voxels in ENGINE-NATIVE order.  For the
    # point families that is raster order (x fastest); the LV family stores
    # tile-major so its per-tile pool updates are contiguous 512-element
    # runs (models/bgklv.py).  Every query/export path converts through
    # these hooks; the defaults are identity.

    def _stored_vidx(self, vidx: np.ndarray) -> np.ndarray:
        """Raster voxel index → stored column index."""
        return vidx

    def _stored_to_raster(self, rows: np.ndarray) -> np.ndarray:
        """[N, V] stored-order columns → raster order (host numpy)."""
        return rows

    def _raster_to_stored(self, rows: np.ndarray) -> np.ndarray:
        """[N, V] raster-order columns → stored order (host numpy)."""
        return rows

    def _stored_to_raster_dev(self, arr):
        """[N, V] stored-order device array → raster order (stays on device;
        used by snapshot builders like models/raycast.py)."""
        return arr

    # -- queries ----------------------------------------------------------

    def _gather_rows(self, arr, slots: np.ndarray) -> np.ndarray:
        """Fetch ``arr[slots]`` via a device-side gather, in RASTER voxel
        order: O(len(slots)·V) transferred, never the full [capacity, V]
        pool field.  Slots are padded to a power of two so the jitted gather
        compiles once per (capacity, pad) bucket, not per call."""
        B = len(slots)
        Bpad = next_pow2(max(B, 32))
        sl = np.full(Bpad, self.pool.capacity, np.int32)
        sl[:B] = slots
        return self._stored_to_raster(
            self._fetch(_gather_slot_rows(arr, jnp.asarray(sl)))[:B])

    def search(self, points: np.ndarray) -> dict[str, np.ndarray]:
        """Vectorized ``search(point3f)`` (bgkoctomap.cpp:563-574).

        Returns per-point posterior fields + ``prob``, ``var``, ``state``;
        points in non-existent blocks report the default (prior) node.
        The per-point values are gathered ON DEVICE and only the [N]-sized
        results cross to the host (the pool fields can be hundreds of MB).
        """
        points = np.atleast_2d(np.asarray(points, dtype=np.float32))
        coords = geo.point_to_block_coord(points, self.block_size)
        slots = self.pool.lookup(coords)
        exists = slots >= 0
        centers = self.block_centers(coords)
        vidx = geo.point_to_voxel_index(points, centers, self.cfg.resolution, self.n)
        N = len(points)
        Npad = next_pow2(max(N, 32))
        sl = np.zeros(Npad, np.int32)
        sl[:N] = np.where(exists, slots, 0)
        vi = np.zeros(Npad, np.int32)
        vi[:N] = self._stored_vidx(vidx)
        sl_d, vi_d = jnp.asarray(sl), jnp.asarray(vi)
        out = {}
        for name, arr in self.pool.fields.items():
            vals = self._fetch(_gather_point_vals(arr, sl_d, vi_d))[:N]
            out[name] = np.where(exists, vals, np.float32(self.FIELD_FILLS[name]))
        tch = self._fetch(_gather_point_vals(self.pool.touched, sl_d, vi_d))[:N]
        out["touched"] = np.where(exists, tch, False)
        post = self._posterior(out)
        post["touched"] = out["touched"]  # evidence flag alongside the posterior
        return post

    def _posterior(self, fields: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def get_bbox(self) -> tuple[np.ndarray, np.ndarray]:
        """Map bounding box over existing blocks (bgkoctomap.cpp:368-381)."""
        if self.pool.n_blocks == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        centers = self.block_centers(self.pool.coords[self.pool.active_slots()])
        half = np.float32(self.block_size / 2.0)
        return centers.min(0) - half, centers.max(0) + half

    # -- export (LeafIterator equivalent) ---------------------------------

    def leaves(self, expand_pruned: bool = True) -> dict[str, np.ndarray]:
        """All map leaves as flat arrays (centers, size, posterior, state).

        ``expand_pruned=True`` mirrors ``get_pruned_locs`` (bgkoctomap.h:269-287):
        collapsed leaves are reported as their base-resolution voxels (the
        static nodes do this unless original_size is set).  With False, each
        collapsed leaf is reported once at its own size.
        """
        nb = self.pool.n_blocks
        if nb == 0:
            empty = {k: np.zeros((0,)) for k in ("x", "y", "z", "size", "prob", "var")}
            empty["state"] = np.zeros((0,), np.int8)
            return empty
        slots = self.pool.active_slots()
        eff = self._gather_rows(self.pool.eff_level, slots).astype(np.int64)
        fields = {k: self._gather_rows(v, slots)
                  for k, v in self.pool.fields.items()}
        fields["touched"] = self._gather_rows(self.pool.touched, slots)
        post = self._posterior(fields)

        centers = self.block_centers(self.pool.coords[slots])  # [B,3]
        res = self.cfg.resolution
        level_tab = np.asarray(self._level_offsets)  # [L,V,3]

        if expand_pruned:
            offs = level_tab[0][None]  # every base voxel at its own center
            mask = np.ones_like(eff, dtype=bool)
            size = np.full(eff.shape, res, dtype=np.float32)
        else:
            # one representative voxel per leaf: the minimum-corner base voxel
            n = self.n
            ix = np.arange(n)
            zz, yy, xx = np.meshgrid(ix, ix, ix, indexing="ij")
            flat = np.stack([xx, yy, zz], -1).reshape(-1, 3)  # raster coords
            m = 1 << eff  # [B,V]
            is_corner = ((flat[None, :, 0] % m == 0) & (flat[None, :, 1] % m == 0)
                         & (flat[None, :, 2] % m == 0))
            mask = is_corner
            offs = np.take_along_axis(level_tab[None], eff[:, None, :, None], axis=1)[:, 0]
            size = (res * m).astype(np.float32)

        pos = centers[:, None, :] + offs  # [B,V,3]
        flat_mask = mask.reshape(-1)
        out = {
            "x": pos[..., 0].reshape(-1)[flat_mask],
            "y": pos[..., 1].reshape(-1)[flat_mask],
            "z": pos[..., 2].reshape(-1)[flat_mask],
            "size": size.reshape(-1)[flat_mask],
        }
        for k, v in post.items():
            out[k] = v.reshape(-1)[flat_mask]
        return out

    # -- checkpoint/resume ------------------------------------------------

    def save(self, path: str) -> None:
        """Serialize the full map state (the reference's dead ``<<``/``>>``
        node operators, bgkoctree_node.cpp:46-58, never got a map-level
        caller; this is the real thing)."""
        slots = self.pool.active_slots()
        data = {
            "coords": self.pool.coords[slots],
            "touched": self._gather_rows(self.pool.touched, slots),
            "eff_level": self._gather_rows(self.pool.eff_level, slots),
            "config": np.frombuffer(repr(self.cfg).encode(), dtype=np.uint8),
        }
        for k, v in self.pool.fields.items():
            data[f"field_{k}"] = self._gather_rows(v, slots)
        np.savez_compressed(path, **data)

    def load(self, path: str) -> None:
        assert self.pool.n_blocks == 0, "load into an empty map"
        data = np.load(path)
        coords = data["coords"]
        slots = self.pool.ensure(coords)
        for k in self.pool.fields:
            self.pool.fields[k] = self.pool.fields[k].at[slots].set(
                jnp.asarray(self._raster_to_stored(data[f"field_{k}"])))
        self.pool.touched = self.pool.touched.at[slots].set(
            jnp.asarray(self._raster_to_stored(data["touched"])))
        self.pool.eff_level = self.pool.eff_level.at[slots].set(
            jnp.asarray(self._raster_to_stored(data["eff_level"])))
