"""BGKOctoMap — Bayesian generalized kernel inference with Beta posteriors.

Accelerator re-design of the reference BGK family pipeline
(``src/bgkoctomap/bgkoctomap.cpp:214-366``), built as a **two-pass row
engine** so whole scan *sequences* integrate in one device dispatch:

  host:   scans → training entries (geometry/preprocess) → per-block
          neighbor tables (bucketing) → fixed-width entry rows
  device: HEAVY pass — every (row × node) kernel product, evaluated at ALL
          octree-level node centers of the row's test block, accumulated
          per (scan, block, neighbor-slot); LIGHT pass — lax.scan over
          scans applying the per-model k̄ gate, the Beta update, and the
          per-scan prune, selecting each voxel's value at its current
          eff-level node.

Evaluating all node levels up front (a (1 + 1/8 + …) ≈ 1.14× overhead)
decouples the hot kernel pass from pruning state entirely: the reference
updates a pruned leaf at its coarser node center (bgkoctomap.cpp:309-336
via the leaf iterator), and the light pass reproduces that exactly by
indexing the precomputed node values with the carried eff levels.  Per-scan
semantics — per-neighbor-model gating (``k̄ > 0``, bgkoctomap.cpp:332) and
prune-between-scans (:344-353) — are preserved bit-for-bit up to f32 sum
reassociation.
"""

from __future__ import annotations

import functools
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp

from la3dm_tpu.geometry import blocks as geo, device_ingest, preprocess
from la3dm_tpu.kernels import math as km
from la3dm_tpu.kernels import predict as kp
from la3dm_tpu.models import base, bucketing, ingest, posterior
from la3dm_tpu.utils.config import MapConfig

#: fixed entry-row width; per-block entry lists are cut into rows of W —
#: one executable for every workload size (totals are extremely skewed:
#: blocks near the sensor collect thousands of entries, the median a few
#: dozen, so per-block padding-to-max wastes >50× the kernel evals)
_ROW_W = 64
#: heavy-pass chunk: bounds the [chunk, Vall, W] kernel live set
_CHUNK = 64
#: max scans per device dispatch; batches are chunked to this and the
#: per-scan light pass padded to exactly this many steps (count-0 no-ops),
#: so a 12-scan demo, a 16-scan chunk of a 60-scan sequence, and a 15-scan
#: long-horizon config all share ONE executable (K=1 server calls keep
#: their own single-step executable)
_SCAN_BATCH = 16

# monotone pad sizes shared across map instances with the same config, so a
# fresh map starts at the converged shapes (and reuses executables)
_GLOBAL_PADS: dict = {}


def _intra(counts: np.ndarray) -> np.ndarray:
    """[sum(counts)] int64: 0..c−1 within each group, groups in order."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)


@functools.partial(
    jax.jit,
    static_argnames=("W", "chunk", "G", "sf2", "ell", "gate", "n",
                     "max_level", "segments", "state_fn", "do_prune",
                     "scan_bt"),
    donate_argnames=("A", "Bv", "touched", "eff"),
)
def _bgk_seq_step(A, Bv, touched, eff, all_nodes, node_idx_tab,
                  entries, labels, ids_flat, gslot_flat,
                  row_block, row_start, row_count,
                  slots_flat, centers_flat, scan_start, scan_count,
                  W: int, chunk: int, G: int, sf2: float, ell: float,
                  gate: float, n: int, max_level: int, segments: bool,
                  state_fn=None, do_prune: bool = False, scan_bt: int = 256):
    """K scans in one dispatch: flat heavy pass + per-scan light pass.

    Heavy: rows (fixed width W) over each (scan, test block)'s merged
    neighbor entry list; kernel K[Vall, W] at ALL node levels × one-hot
    slot RHS [W, 2G] → per-block (ȳ_g, k̄_g) accumulated at ``row_block``.
    Light: lax.scan over scans — per-model gate (kbar_g > gate), Beta
    deltas selected at each voxel's eff-level node, pool scatter, prune.

    Shapes: entries [Np,D] (all scans), ids_flat/gslot_flat [Fp] tile-major
    merged entry ids + their neighbor-slot, row_* [Rp] (count 0 ⇒ padding),
    slots_flat/centers_flat [Tp] stacked per-scan block lists (slot ==
    pool capacity ⇒ padding), scan_start/scan_count [K] segments into them.
    """
    F = ids_flat.shape[0]
    Rp = row_block.shape[0]
    Tp = slots_flat.shape[0]
    Vall = all_nodes.shape[0]
    V = node_idx_tab.shape[1]
    cap = eff.shape[0] - 1  # pool arrays are [capacity, V]; clamp gathers

    wcol = jnp.arange(W, dtype=jnp.int32)[None, :]

    # ---- heavy pass: all rows, chunked lax.scan carrying the accumulator
    acc = jnp.zeros((Tp, Vall, 2 * G), jnp.float32)

    def heavy_chunk(acc, xs):
        blk_c, st_c, ct_c = xs                                  # [c],[c],[c]
        fidx = jnp.minimum(st_c[:, None] + wcol, F - 1)         # [c,W]
        ids = ids_flat[fidx]
        gs = gslot_flat[fidx]
        val = wcol < ct_c[:, None]
        ent = entries[ids]                                      # [c,W,D]
        lab = labels[ids]
        ctr = centers_flat[jnp.minimum(blk_c, Tp - 1)]          # [c,3]
        vox = all_nodes[None] + ctr[:, None, :]                 # [c,Vall,3]

        def one(v, e, l, g, m):
            if segments:
                Km = km.cov_sparse_segment(v, e, sf2, ell, lv=False)
            else:
                Km = km.cov_sparse(v, e, sf2, ell)
            Km = jnp.where(m[None, :], Km, 0.0)                 # [Vall,W]
            rhs = kp._slot_rhs(l, g, m, G)                      # [W,2G]
            return jnp.dot(Km, rhs, precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)

        out = jax.vmap(one)(vox, ent, lab, gs, val)             # [c,Vall,2G]
        return acc.at[blk_c].add(out, mode="drop"), None

    nchunk = Rp // chunk

    def rc(x):
        return x.reshape(nchunk, chunk)

    acc, _ = jax.lax.scan(heavy_chunk, acc,
                          (rc(row_block), rc(row_start), rc(row_count)))

    # ---- light pass: per-scan gate + Beta update + prune
    vcol = jnp.arange(V, dtype=jnp.int32)
    brow = jnp.arange(scan_bt, dtype=jnp.int32)

    def light_step(carry, xs):
        A, Bv, touched, eff = carry
        start, count = xs
        bidx = jnp.minimum(start + brow, Tp - 1)
        mask = brow < count
        slots_k = jnp.where(mask, slots_flat[bidx], cap + 1)    # sentinel pad
        accb = acc[bidx]                                        # [Bt,Vall,2G]
        dAall, dBall, tchall = kp.beta_update(
            accb[..., :G], accb[..., G:], gate)                 # [Bt,Vall]
        eff_b = eff[jnp.minimum(slots_k, cap)]                  # [Bt,V]
        nidx = node_idx_tab[eff_b.astype(jnp.int32), vcol[None, :]]  # [Bt,V]
        dA = jnp.take_along_axis(dAall, nidx, axis=1)
        dB = jnp.take_along_axis(dBall, nidx, axis=1)
        tch = jnp.take_along_axis(tchall, nidx, axis=1)
        A = A.at[slots_k].add(dA, mode="drop")
        Bv = Bv.at[slots_k].add(dB, mode="drop")
        touched = touched.at[slots_k].max(tch, mode="drop")
        if do_prune:
            from la3dm_tpu.models import pruning

            safe = jnp.minimum(slots_k, cap)
            vals = {"A": A[safe], "B": Bv[safe],
                    "touched": touched[safe].astype(jnp.float32)}
            new_vals, new_eff = pruning.prune_blocks(
                vals, eff[safe], n=n, max_level=max_level, state_fn=state_fn)
            A = A.at[slots_k].set(new_vals["A"], mode="drop")
            Bv = Bv.at[slots_k].set(new_vals["B"], mode="drop")
            touched = touched.at[slots_k].set(new_vals["touched"] > 0, mode="drop")
            eff = eff.at[slots_k].set(new_eff, mode="drop")
        return (A, Bv, touched, eff), None

    (A, Bv, touched, eff), _ = jax.lax.scan(
        light_step, (A, Bv, touched, eff), (scan_start, scan_count))
    return A, Bv, touched, eff


def _select_eff(vals: jax.Array, eff_b: jax.Array, n: int, block_depth: int):
    """Select each voxel's value at its eff-level ancestor node — the
    gather-free form of ``node_idx_tab`` indexing.

    ``vals`` [Bt, Vall] is level-major (all_level_nodes order: level 0 in
    x-fastest raster, then level 1's (n/2)³ nodes, ...).  Each level's slab
    upsamples to base resolution by pure broadcast/reshape (ancestor ids are
    per-axis shifts in raster order), then ``eff_b`` [Bt, V] picks levels
    elementwise, in place of a per-element take_along_axis gather.
    """
    Bt = vals.shape[0]
    off = 0
    sel = None
    for L in range(block_depth):
        m = n >> L
        s = 1 << L
        lvl = vals[:, off:off + m ** 3].reshape(Bt, m, 1, m, 1, m, 1)
        up = jnp.broadcast_to(lvl, (Bt, m, s, m, s, m, s)).reshape(Bt, n ** 3)
        sel = up if sel is None else jnp.where(eff_b == L, up, sel)
        off += m ** 3
    return sel


def _aligned_heavy(acc, ext_nodes, ent_rel, labels, vmask, u_tgt,
                   Wa: int, chunk: int, G: int, sf2: float, ell: float,
                   segments: bool):
    """The aligned heavy pass: kernel rows × G shifted node tables →
    per-ENTRY-BLOCK accumulation into ``acc`` [Up+1, G·Vall·2].

    Each Wa-row's full [G, Vall, 2] output lands at ONE accumulator row
    (its entry block, ``u_tgt``) as one contiguous vector; rows of the same
    block are adjacent (the ingest sort), so the scatter-add degenerates to
    mostly-sequential whole-row read-modify-writes instead of per-(row,
    slot) fragments.  Shared by the sequence engine and the bench roofline
    microbench (bench.py) so the saturation numbers measure exactly the
    production computation.

    The dots run at ``Precision.HIGHEST``: the k̄ > gate test sits on the
    sparse kernel's clamp boundary, so reduced-precision (TF32) products
    would flip update gates, not just last bits."""
    GV, D = ext_nodes.shape[0], ent_rel.shape[-1]
    R2K = u_tgt.shape[0]
    nch = R2K // chunk

    def rc(x):
        return x.reshape((nch, chunk) + x.shape[1:])

    def heavy(acc, xs):
        e, l, m, tg = xs                        # [c,Wa,D],[c,Wa],[c,Wa],[c]

        def one(e_r, l_r, m_r):
            if segments:
                Km = km.cov_sparse_segment(ext_nodes, e_r, sf2, ell, lv=False)
            else:
                Km = km.cov_sparse(ext_nodes, e_r, sf2, ell)
            Km = jnp.where(m_r[None, :], Km, 0.0)            # [GV, Wa]
            # two [GV] matvecs, not one [GV,2] matmul: the batched [c,GV]
            # outputs keep the voxel axis minor (a minor dim of 2 would
            # not).  Same per-element f32 sums.
            yb = jnp.dot(Km, jnp.where(m_r, l_r, 0.0),
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
            kb = jnp.dot(Km, m_r.astype(jnp.float32),
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
            return yb, kb

        yb, kb = jax.vmap(one)(e, l, m)         # [c, GV] each
        out = jnp.concatenate([yb, kb], axis=1)  # [c, 2·GV]: [ȳ | k̄]
        return acc.at[tg].add(out, mode="drop"), None

    acc, _ = jax.lax.scan(
        heavy, acc,
        (rc(ent_rel.reshape(R2K, Wa, D)), rc(labels.reshape(R2K, Wa)),
         rc(vmask.reshape(R2K, Wa)), rc(u_tgt)))
    return acc


@functools.partial(
    jax.jit,
    static_argnames=("Wa", "chunk", "G", "Bu", "sf2", "ell", "gate", "n",
                     "max_level", "segments", "state_fn", "do_prune",
                     "scan_bt", "block_depth"),
    donate_argnames=("A", "Bv", "touched", "eff"),
)
def _bgk_seq_step_aligned(A, Bv, touched, eff, ext_nodes,
                          ent_rel, labels, vmask, u_tgt, tb_rows,
                          slots_flat, scan_start, scan_count,
                          Wa: int, chunk: int, G: int, Bu: int,
                          sf2: float, ell: float,
                          gate: float, n: int, max_level: int, segments: bool,
                          block_depth: int, state_fn=None,
                          do_prune: bool = False, scan_bt: int = 1024):
    """Gather-free sequence engine for the block-ALIGNED entry layout.

    The ingest pipeline (geometry/device_ingest.py) pads each block's
    sorted entries to a multiple of Wa, so the heavy pass consumes entries
    by ``lax.scan`` slicing — no id expansion, no entry gathers.  Each
    Wa-row belongs to ONE entry block u; its kernel matrix is evaluated
    against G *constant* shifted node tables at once:

      nodes(t) − e  =  all_nodes + center(t) − center(u) − ent_rel
                    =  (all_nodes − off_g·bs) − ent_rel          [t = u − off_g]

    so ``ext_nodes`` [G·Vall, 3] = all_nodes − off_g·bs is a per-config
    constant and per-row block centers never enter the engine.  The row's
    [G·Vall·2] (ȳ, k̄) output accumulates at its ENTRY block's row
    (``u_tgt`` into the [K·Bu+1, G·Vall·2] accumulator — whole-tile
    scatter rows, see ``_aligned_heavy``); the light pass gathers each
    (test row, slot)'s slice through ``tb_rows`` (device_ingest.u_targets)
    and applies the same per-scan gate + Beta update + prune as the
    reference loop (bgkoctomap.cpp:309-353), with the eff-level node
    selection done by broadcast (``_select_eff``).
    """
    GV = ext_nodes.shape[0]
    Vall = GV // G
    Up = scan_start.shape[0] * Bu
    Tp = slots_flat.shape[0]
    cap = eff.shape[0] - 1

    acc = jnp.zeros((Up + 1, 2 * GV), jnp.float32)
    acc = _aligned_heavy(acc, ext_nodes, ent_rel, labels, vmask, u_tgt,
                         Wa, chunk, G, sf2, ell, segments)
    acc4 = acc.reshape(Up + 1, 2, G, Vall)      # [ȳ | k̄] block layout
    ybar_all = acc4[:, 0]
    kbar_all = acc4[:, 1]

    brow = jnp.arange(scan_bt, dtype=jnp.int32)
    gidx = jnp.arange(G, dtype=jnp.int32)

    def light_step(carry, xs):
        A, Bv, touched, eff = carry
        start, count = xs
        bidx = jnp.minimum(start + brow, Tp - 1)
        mask = brow < count
        slots_k = jnp.where(mask, slots_flat[bidx], cap + 1)    # sentinel pad
        rows = tb_rows[bidx]
        vy = ybar_all[rows, gidx[None, :]]                      # [Bt,G,Vall]
        vk = kbar_all[rows, gidx[None, :]]
        dAall, dBall, tchall = kp.beta_update(
            jnp.moveaxis(vy, 1, -1),
            jnp.moveaxis(vk, 1, -1), gate)                      # [Bt,Vall]
        eff_b = eff[jnp.minimum(slots_k, cap)]                  # [Bt,V]
        dA = _select_eff(dAall, eff_b, n, block_depth)
        dB = _select_eff(dBall, eff_b, n, block_depth)
        tch = _select_eff(tchall, eff_b, n, block_depth)
        A = A.at[slots_k].add(dA, mode="drop")
        Bv = Bv.at[slots_k].add(dB, mode="drop")
        touched = touched.at[slots_k].max(tch, mode="drop")
        if do_prune:
            from la3dm_tpu.models import pruning

            safe = jnp.minimum(slots_k, cap)
            vals = {"A": A[safe], "B": Bv[safe],
                    "touched": touched[safe].astype(jnp.float32)}
            new_vals, new_eff = pruning.prune_blocks(
                vals, eff[safe], n=n, max_level=max_level, state_fn=state_fn)
            A = A.at[slots_k].set(new_vals["A"], mode="drop")
            Bv = Bv.at[slots_k].set(new_vals["B"], mode="drop")
            touched = touched.at[slots_k].set(new_vals["touched"] > 0, mode="drop")
            eff = eff.at[slots_k].set(new_eff, mode="drop")
        return (A, Bv, touched, eff), None

    (A, Bv, touched, eff), _ = jax.lax.scan(
        light_step, (A, Bv, touched, eff), (scan_start, scan_count))
    return A, Bv, touched, eff


class BGKOctoMap(ingest.DeviceIngestMixin, base.OccupancyMapBase):
    """BGK occupancy map (ctor params: bgkoctomap.cpp:31-56)."""

    SEGMENTS = False
    GATE = 0.0  # update gate: k̄ > 0 (bgkoctomap.cpp:332)
    SCAN_BATCH = _SCAN_BATCH

    # ------------------------------------------------ device-side ingestion

    def _ingest_enabled(self) -> bool:
        # BGK and BGKL ingest on device through this class; GP gates itself via
        # the mixin default (GPOctoMap does not inherit from BGKOctoMap), and
        # the LV family runs its own ray-shortening ingest (models/bgklv.py)
        return self.cfg.method in ("bgk", "bgkl") and super()._ingest_enabled()

    def _ingest_overflow_fallback(self, clouds, origins, ds, fr, mr) -> None:
        tables = []
        for c, o in zip(clouds, origins):
            t0 = time.perf_counter()
            t = self._scan_tables(c, o, ds, fr, mr)
            self.stats["host_s"] += time.perf_counter() - t0
            if t is not None:
                tables.append(t)
        self._integrate(tables)

    def _dispatch_ingest_chunk(self, out, fetched, slots, centers, spec,
                               K_pad: int, n_scans: int) -> None:
        """Aligned device tables → the gather-free sequence engine."""
        t0 = time.perf_counter()
        cfg = self.cfg
        G = self.num_slots
        Wa = spec.Wa
        T = spec.T
        Vall = self._all_nodes_host.shape[0]
        cts = fetched["counts"]
        n_mem = cts[:, 2]
        # live aligned rows: the sorted layout puts all real entries (plus
        # their block pads) in a prefix, so the engine only consumes a
        # monotone-padded slice of the static [M]-sized tables
        live_rows = -(-int(cts[:, 6].max(initial=0)) // Wa)
        # seeded to the measured cover of the bundled workloads (demo,
        # long-term, dense-jitter) so every chunk lands on ONE executable
        # and fresh processes hit the persistent compile cache
        pad = _GLOBAL_PADS.setdefault(
            ("ingest", type(self).__name__, cfg, K_pad),
            {"R2": 8192 if self.SEGMENTS else 2048})
        pad["R2"] = max(pad["R2"],
                        base.round_up(max(live_rows, _CHUNK), _CHUNK))
        R2p = min(pad["R2"], spec.R2)
        L = R2p * Wa

        ent_rel = out["ent_rel"][:, :L].reshape(K_pad * L, spec.D)
        lab = out["lab"][:, :L].reshape(-1)
        vmask = out["vmask"][:, :L].reshape(-1)
        u_tgt, tb_rows = device_ingest.u_targets(
            out["urank_rows"][:, :R2p], out["tb_u"], spec.Bu, G)
        ss = np.arange(K_pad, dtype=np.int32) * T
        sc = np.full(K_pad, T, np.int32)

        if not hasattr(self, "_ext_nodes_dev"):
            shifts = (-np.asarray(self._neighbor_offsets, np.float32)
                      * np.float32(self.block_size))             # [G,3]
            self._ext_nodes_dev = jnp.asarray(
                (self._all_nodes_host[None] + shifts[:, None, :])
                .reshape(-1, 3).astype(np.float32))
        self.stats["kernel_evals"] += int(n_mem.sum()) * G * Vall
        self.stats["scans"] += n_scans
        self.stats["host_s"] += time.perf_counter() - t0

        statics = dict(
            Wa=Wa, chunk=_CHUNK, G=G, Bu=spec.Bu, sf2=cfg.sf2, ell=cfg.ell,
            gate=self.GATE, n=self.n, max_level=cfg.block_depth - 1,
            segments=self.SEGMENTS, block_depth=cfg.block_depth,
            state_fn=self._state_fn, do_prune=cfg.block_depth > 1, scan_bt=T)
        (self.pool.fields["A"], self.pool.fields["B"], self.pool.touched,
         self.pool.eff_level) = _bgk_seq_step_aligned(
            self.pool.fields["A"], self.pool.fields["B"], self.pool.touched,
            self.pool.eff_level, self._ext_nodes_dev,
            ent_rel, lab, vmask, u_tgt, tb_rows,
            jnp.asarray(slots), jnp.asarray(ss), jnp.asarray(sc), **statics)

    def _field_fills(self):
        # prior pseudo-counts are the pool fill values (bgkoctree_node.h:33)
        return {"A": self.cfg.prior_A, "B": self.cfg.prior_B}

    @property
    def _all_nodes_host(self) -> np.ndarray:
        if not hasattr(self, "_node_tab_cache"):
            self._node_tab_cache = geo.all_level_nodes(
                self.cfg.resolution, self.cfg.block_depth)
        return self._node_tab_cache[0]

    @property
    def _node_idx_host(self) -> np.ndarray:
        if not hasattr(self, "_node_tab_cache"):
            self._node_tab_cache = geo.all_level_nodes(
                self.cfg.resolution, self.cfg.block_depth)
        return self._node_tab_cache[1]

    # ------------------------------------------------------------------ API

    def insert_pointcloud(self, cloud: np.ndarray, origin: np.ndarray,
                          ds_resolution: float | None = None,
                          free_resolution: float | None = None,
                          max_range: float | None = None) -> None:
        """Integrate one scan (reference insert_pointcloud, bgkoctomap.cpp:214)."""
        if self._insert_device([cloud], [origin], ds_resolution,
                               free_resolution, max_range):
            return
        t0 = time.perf_counter()
        t = self._scan_tables(cloud, origin, ds_resolution, free_resolution,
                              max_range)
        self.stats["host_s"] += time.perf_counter() - t0
        self._integrate([t] if t is not None else [])

    def insert_pointclouds(self, clouds, origins, ds_resolution=None,
                           free_resolution=None, max_range=None) -> None:
        """Integrate a scan *sequence*, ≤ _SCAN_BATCH scans per dispatch.

        Exact relative to the sequential loop (up to f32 sum reassociation):
        the light pass scans over the sequence on device, applying each
        scan's gate/update/prune in order; successive dispatches resume from
        the previous chunk's pool state exactly like successive scans do.

        On an accelerator the whole preprocessing pipeline runs on-device
        (geometry/device_ingest.py) — the host only pads raw clouds and
        allocates pool slots.  On the host path, chunks are STREAMED: scan
        preprocessing runs in a thread pool while earlier chunks' (async)
        device dispatches execute, so host table building and device compute
        overlap instead of serializing.  ``host_s`` counts main-thread host
        work + preprocessing stalls — the host side of the critical path.
        """
        if self._insert_device(clouds, origins, ds_resolution,
                               free_resolution, max_range):
            return
        with ThreadPoolExecutor(max_workers=min(8, max(len(clouds), 1))) as ex:
            futures = [ex.submit(self._scan_tables, c, o, ds_resolution,
                                 free_resolution, max_range)
                       for c, o in zip(clouds, origins)]
            buf = []
            for f in futures:
                t0 = time.perf_counter()
                t = f.result()
                self.stats["host_s"] += time.perf_counter() - t0
                if t is not None:
                    buf.append(t)
                if len(buf) == _SCAN_BATCH:
                    self._integrate(buf)
                    buf = []
            if buf:
                self._integrate(buf)

    def insert_training_data(self, points: np.ndarray, labels: np.ndarray) -> None:
        """Integrate pre-labeled training points (bgkoctomap.cpp:82-212)."""
        points = points.astype(np.float32)
        coords, idx = geo.point_block_memberships(points, self.block_size)
        t = bucketing.bucket_tables(
            coords, points[idx], labels.astype(np.float32)[idx],
            self._neighbor_offsets)
        self._integrate([t] if len(t.test_coords) else [])

    # ------------------------------------------------------------- internals

    def _scan_entries(self, cloud, origin, ds, fr, mr):
        """Scan → (block coords, entries [N,D], labels) or None if empty."""
        from la3dm_tpu.geometry import native

        td = native.bgk_training_data(cloud, origin, ds, fr, mr,
                                      free_label=0.0)
        if td is None:  # no native toolchain — numpy fallback
            td = preprocess.bgk_training_data(cloud, origin, ds, fr, mr,
                                              free_label=0.0)
        if len(td.points) == 0:
            return None
        points = td.points.astype(np.float32)
        coords, idx = geo.point_block_memberships(points, self.block_size)
        return coords, points[idx], td.labels.astype(np.float32)[idx]

    def _scan_tables(self, cloud, origin, ds_resolution, free_resolution,
                     max_range):
        cfg = self.cfg
        ds = cfg.ds_resolution if ds_resolution is None else ds_resolution
        fr = cfg.free_resolution if free_resolution is None else free_resolution
        mr = cfg.max_range if max_range is None else max_range
        if not self.SEGMENTS:
            # fused native path: training data + memberships + bucketing in
            # one C++ pass (bit-identical to the numpy pipeline below)
            from la3dm_tpu.geometry import native

            td = native.bgk_training_data(cloud, origin, ds, fr, mr,
                                          free_label=0.0)
            if td is not None:
                if len(td.points) == 0:
                    return None
                nt = native.scan_bucket_tables(
                    td.points, td.labels.astype(np.float32),
                    self.block_size, self._neighbor_offsets)
                if nt is not None:
                    if len(nt["test_coords"]) == 0:
                        return None
                    return bucketing.BucketTables(
                        test_coords=nt["test_coords"], entries=nt["entries"],
                        labels=nt["labels"], starts=nt["starts"],
                        counts=nt["counts"],
                        max_total=int(nt["counts"].sum(axis=1).max()))
        ent = self._scan_entries(cloud, origin, ds, fr, mr)
        if ent is None:
            return None
        coords, entries, labels = ent
        t = bucketing.bucket_tables(coords, entries, labels,
                                    self._neighbor_offsets)
        return t if len(t.test_coords) else None

    def _row_tables(self, t: bucketing.BucketTables):
        """Merged per-block entry id list + fixed-width rows (host numpy).

        ids: [F] — for each test block, its G neighbor segments concatenated
        (slot order; the reference trains one model per neighbor and updates
        sequentially — Beta updates are additive so order is free, but the
        per-model gate needs the slot id, carried in ``gslot``).
        """
        from la3dm_tpu.geometry import native

        nt = native.row_tables(t.starts, t.counts, _ROW_W)
        if nt is not None:  # fused C++ path, identical output
            ids, gslot, row_block, row_start, row_count, totals = nt
            return (ids.astype(np.int64), gslot, row_block.astype(np.int64),
                    row_start, row_count.astype(np.int64), totals)
        B, G = t.starts.shape
        totals = t.counts.sum(axis=1).astype(np.int64)
        F = int(totals.sum())
        mstart = np.concatenate([[0], np.cumsum(totals)[:-1]])
        lens = t.counts.reshape(-1).astype(np.int64)
        starts_flat = t.starts.reshape(-1).astype(np.int64)
        col_base = (mstart[:, None] + np.concatenate(
            [np.zeros((B, 1), np.int64),
             np.cumsum(t.counts, axis=1)[:, :-1]], axis=1)).reshape(-1)
        ids = np.empty(F, np.int64)
        gslot = np.empty(F, np.int8)
        if F:
            within = _intra(lens)
            dst = np.repeat(col_base, lens) + within
            ids[dst] = np.repeat(starts_flat, lens) + within
            gslot[dst] = np.repeat((np.arange(B * G) % G).astype(np.int8), lens)
        W = _ROW_W
        nrows = np.maximum((totals + W - 1) // W, 0)
        j = _intra(nrows)
        row_block = np.repeat(np.arange(B, dtype=np.int64), nrows)
        row_start = np.repeat(mstart, nrows) + j * W
        row_count = np.minimum(W, np.repeat(totals, nrows) - j * W)
        return ids, gslot, row_block, row_start.astype(np.int64), \
            row_count.astype(np.int64), totals

    # kept name from round 1 (bgkl.py calls it): single-table integration
    def _apply_tables(self, t: bucketing.BucketTables) -> None:
        self._integrate([t] if len(t.test_coords) else [])

    def _integrate(self, tables: list) -> None:
        """Integrate K ≤ _SCAN_BATCH scans' bucket tables in one dispatch."""
        if not tables:
            return
        if len(tables) > _SCAN_BATCH:
            for i in range(0, len(tables), _SCAN_BATCH):
                self._integrate(tables[i:i + _SCAN_BATCH])
            return
        t_host0 = time.perf_counter()
        cfg = self.cfg
        W = _ROW_W
        G = self.num_slots
        D = tables[0].entries.shape[1]
        Vall = self._all_nodes_host.shape[0]

        ent_parts, lab_parts = [], []
        ids_parts, gs_parts = [], []
        rb_parts, rs_parts, rn_parts = [], [], []
        slot_parts, ctr_parts, coord_parts = [], [], []
        scan_start, scan_count = [], []
        ent_off = 0
        id_off = 0
        blk_off = 0
        gen0 = self.pool.generation
        for t in tables:
            # entry totals weight the sharded pool's load-aware placement
            slots = self.pool.ensure(t.test_coords,
                                     weights=t.counts.sum(axis=1))
            coord_parts.append(t.test_coords)
            centers = self.block_centers(t.test_coords).astype(np.float32)
            ids, gslot, row_block, row_start, row_count, totals = \
                self._row_tables(t)
            ent_parts.append(t.entries)
            lab_parts.append(t.labels)
            ids_parts.append(ids + ent_off)
            gs_parts.append(gslot)
            rb_parts.append(row_block + blk_off)
            rs_parts.append(row_start + id_off)
            rn_parts.append(row_count)
            slot_parts.append(slots.astype(np.int32))
            ctr_parts.append(centers)
            scan_start.append(blk_off)
            scan_count.append(len(slots))
            ent_off += len(t.entries)
            id_off += len(ids)
            blk_off += len(slots)
            self.stats["kernel_evals"] += int(totals.sum()) * Vall
            self.stats["scans"] += 1

        entries = np.concatenate(ent_parts, axis=0)
        labels = np.concatenate(lab_parts)
        ids = np.concatenate(ids_parts)
        gslot = np.concatenate(gs_parts)
        row_block = np.concatenate(rb_parts)
        row_start = np.concatenate(rs_parts)
        row_count = np.concatenate(rn_parts)
        slots_flat = np.concatenate(slot_parts)
        if self.pool.generation != gen0:
            # sharded pool grew while later tables were ensured: earlier
            # tables' slot ids were remapped — re-resolve the whole batch
            slots_flat = self.pool.lookup(
                np.concatenate(coord_parts, axis=0)).astype(np.int32)
        centers_flat = np.concatenate(ctr_parts, axis=0)
        K_scans = len(tables)
        Bt_max = max(scan_count)

        # monotone pads (rows round to the chunk, blocks to 256) → stable
        # executables; K is static per call (12-scan batch vs 1-scan server)
        pad = _GLOBAL_PADS.setdefault(
            (type(self).__name__, cfg),
            {"N": 1024, "F": 4096, "R": _CHUNK * 4, "T": 256, "B": 256})
        pad["N"] = max(pad["N"], base.next_pow2(max(len(entries), 1024)))
        pad["F"] = max(pad["F"], base.next_pow2(max(len(ids), 4096)))
        pad["R"] = max(pad["R"], base.round_up(max(len(row_block), _CHUNK), _CHUNK))
        pad["T"] = max(pad["T"], base.round_up(max(len(slots_flat), 256), 256))
        pad["B"] = max(pad["B"], base.round_up(max(Bt_max, 256), 256))
        Np, Fp, Rp, Tp, Btp = pad["N"], pad["F"], pad["R"], pad["T"], pad["B"]

        ent_p = np.zeros((Np, D), np.float32)
        ent_p[:len(entries)] = entries
        lab_p = np.zeros(Np, np.float32)
        lab_p[:len(labels)] = labels
        ids_p = np.zeros(Fp, np.int32)
        ids_p[:len(ids)] = ids
        gs_p = np.zeros(Fp, np.int8)
        gs_p[:len(gslot)] = gslot
        rb_p = np.full(Rp, Tp - 1, np.int32)   # padding rows hit a dead slot
        rb_p[:len(row_block)] = row_block
        rs_p = np.zeros(Rp, np.int32)
        rs_p[:len(row_start)] = row_start
        rn_p = np.zeros(Rp, np.int32)          # count 0 ⇒ padding row
        rn_p[:len(row_count)] = row_count
        sl_p = np.full(Tp, self.pool.capacity, np.int32)
        sl_p[:len(slots_flat)] = slots_flat
        ct_p = np.zeros((Tp, 3), np.float32)
        ct_p[:len(centers_flat)] = centers_flat
        # pad K to the fixed batch size (count-0 steps are no-ops) so every
        # multi-scan chunk shares one executable; K=1 keeps its own
        K_pad = 1 if K_scans == 1 else _SCAN_BATCH
        ss = np.zeros(K_pad, np.int32)
        ss[:K_scans] = scan_start
        sc = np.zeros(K_pad, np.int32)
        sc[:K_scans] = scan_count

        if not hasattr(self, "_dev_consts"):
            self._dev_consts = (jnp.asarray(self._all_nodes_host),
                                jnp.asarray(self._node_idx_host))
        an_dev, ni_dev = self._dev_consts
        self.stats["host_s"] += time.perf_counter() - t_host0

        args = (self.pool.fields["A"], self.pool.fields["B"],
                self.pool.touched, self.pool.eff_level, an_dev, ni_dev,
                jnp.asarray(ent_p), jnp.asarray(lab_p),
                jnp.asarray(ids_p), jnp.asarray(gs_p),
                jnp.asarray(rb_p), jnp.asarray(rs_p), jnp.asarray(rn_p),
                jnp.asarray(sl_p), jnp.asarray(ct_p),
                jnp.asarray(ss), jnp.asarray(sc))
        statics = dict(
            W=W, chunk=_CHUNK, G=G, sf2=cfg.sf2, ell=cfg.ell,
            gate=self.GATE, n=self.n, max_level=cfg.block_depth - 1,
            segments=self.SEGMENTS, state_fn=self._state_fn,
            do_prune=cfg.block_depth > 1, scan_bt=Btp)
        (self.pool.fields["A"], self.pool.fields["B"], self.pool.touched,
         self.pool.eff_level) = _bgk_seq_step(*args, **statics)

    def _make_state_fn(self):
        cfg = self.cfg
        return posterior.BetaStateFn(cfg.var_thresh, cfg.free_thresh, cfg.occupied_thresh)

    def _posterior(self, fields: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        cfg = self.cfg
        A, B = fields["A"], fields["B"]
        prob = np.asarray(A / (A + B))
        var = np.asarray((A * B) / ((A + B) ** 2 * (A + B + 1.0)))
        st = np.where(prob > cfg.occupied_thresh, posterior.OCCUPIED,
                      np.where(prob < cfg.free_thresh, posterior.FREE, posterior.UNKNOWN))
        st = np.where(var > cfg.var_thresh, posterior.UNKNOWN, st)
        st = np.where(fields["touched"], st, posterior.UNKNOWN).astype(np.int8)
        return {"prob": prob, "var": var, "state": st, "A": np.asarray(A), "B": np.asarray(B)}
