"""GPOctoMap — per-block exact GP regression + BCM fusion.

Reference (``src/gpoctomap/gpoctomap.cpp``, ``gpregressor.h``,
``gpoctree_node.cpp``): each block with training points trains an exact GP
(Matérn-3/2 + Cholesky) on its own points; each test block queries the
models of its extended neighborhood and fuses them with the BCM
information-filter update ``ivar += 1/σ² − sf2; m_ivar += μ/σ²`` including
the order-dependent persistent ivar chop (gpoctree_node.cpp:36-49).
Free-space label is −1 (gpoctomap.cpp:399); there is no k̄ gate.

Device design — the same **two-pass sequence engine** as the BGK family
(models/bgk.py): the HEAVY pass trains every scan's models with a batched
Cholesky (chunked ``lax.scan`` bounding the [chunk, S, S] factor live set)
and predicts each model's G neighbor test blocks at ALL octree-level node
centers, scattering (mean, var) into a per-(scan, block, slot) table; the
LIGHT pass lax.scans over scans applying the order-dependent sequential
BCM fusion and the per-scan prune at each voxel's eff-level node.  Whole
scan sequences integrate in one heavy dispatch per size tier (usually one)
plus one light dispatch.

Size tiers: models are bucketed by point count into a base tier (S=128
covers the demo datasets entirely) and, only when a scan contains denser
blocks, one overflow tier at next-pow2(max count) — so a single 4,000-point
block costs one small [few, 4096, 4096] batch instead of padding every
model to 4096 (reference per-block sizes vary wildly, gpregressor.h:42-51).
"""

from __future__ import annotations

import functools
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp

from la3dm_tpu.geometry import blocks as geo, device_ingest, preprocess
from la3dm_tpu.kernels import gp as kgp
from la3dm_tpu.models import base, bucketing, ingest, posterior, pruning
from la3dm_tpu.utils.config import MapConfig

#: base tier size (point counts ≤ this go to the shared executable)
_TIER0 = 128
#: max scans per device dispatch; the light pass pads to exactly this many
#: steps so scan sequences of any length share one executable (see bgk.py)
_SCAN_BATCH = 16

# monotone pad sizes shared across map instances with the same config
_GLOBAL_PADS: dict = {}


def _chunk_for(S: int) -> int:
    """Model-chunk size bounding the [chunk, S, S] Cholesky workspace.

    Drops to 1 for very large S so the 2^24-element bound holds even for
    the overflow tier (S=4096 at chunk 8 would be two ~512 MiB factors)."""
    return max(1, min(256, (1 << 24) // max(S * S, 1)))


@functools.partial(
    jax.jit,
    static_argnames=("S", "chunk", "G", "sf2", "ell", "noise"),
    donate_argnames=("acc_mean", "acc_var", "present"),
)
def _gp_heavy(acc_mean, acc_var, present, all_nodes,
              pts_s, lab_s, starts, counts, nb_rows, centers_flat,
              S: int, chunk: int, G: int, sf2: float, ell: float, noise: float):
    """One tier's models: batched train + all-level predict + scatter.

    acc_mean/acc_var/present: [Tp·G, Vall] / [Tp·G, Vall] / [Tp·G] —
    per-(test block row, slot) prediction tables (Tp stacks every scan's
    block list).  nb_rows [M,G]: the block-list row model m serves at slot
    g (== Tp ⇒ padding).  counts 0 ⇒ padding model.
    """
    N = pts_s.shape[0]
    Vall = all_nodes.shape[0]
    Tp = centers_flat.shape[0]
    M = starts.shape[0]
    scol = jnp.arange(S, dtype=jnp.int32)[None, :]

    def model_chunk(carry, xs):
        acc_mean, acc_var, present = carry
        st, ct, nbt = xs                                    # [c],[c],[c,G]
        valid = scol < ct[:, None]                          # [c,S]
        idx = jnp.minimum(st[:, None] + scol, N - 1)
        pts = pts_s[idx]                                    # [c,S,3]
        y = jnp.where(valid, lab_s[idx], 0.0)
        L, alpha = kgp.gp_train_core(pts, y, valid, sf2, ell, noise)
        ctr = centers_flat[jnp.minimum(nbt, Tp - 1)]        # [c,G,3]
        xq = (all_nodes[None, None] + ctr[:, :, None, :]).reshape(
            -1, G * Vall, 3)                                # [c,G·Vall,3]
        mean, var = kgp.gp_predict_core(L, alpha, pts, valid, xq, sf2, ell)
        mean = mean.reshape(-1, G, Vall)
        var = var.reshape(-1, G, Vall)
        ok = ct > 0
        # flat (block row, slot) target; distinct models serve distinct
        # blocks at a fixed slot, so .set never collides
        flat = jnp.where(ok[:, None] & (nbt < Tp),
                         nbt * G + jnp.arange(G, dtype=jnp.int32)[None, :],
                         Tp * G).reshape(-1)
        acc_mean = acc_mean.at[flat].set(mean.reshape(-1, Vall), mode="drop")
        acc_var = acc_var.at[flat].set(var.reshape(-1, Vall), mode="drop")
        present = present.at[flat].set(
            jnp.broadcast_to(ok[:, None], nbt.shape).reshape(-1), mode="drop")
        return (acc_mean, acc_var, present), None

    nchunk = M // chunk

    def rc(x):
        return x.reshape(nchunk, chunk, *x.shape[1:])

    (acc_mean, acc_var, present), _ = jax.lax.scan(
        model_chunk, (acc_mean, acc_var, present),
        (rc(starts), rc(counts), rc(nb_rows)))
    return acc_mean, acc_var, present


@functools.partial(
    jax.jit,
    static_argnames=("G", "sf2", "min_known_ivar", "max_ivar", "n",
                     "max_level", "state_fn", "do_prune", "scan_bt"),
    # NOTE: the acc tables are NOT donated here — _gp_light has no output of
    # their shape to alias, so donating them is a per-call "not usable"
    # warning, not a saving (they die after their last read either way)
    donate_argnames=("m_ivar", "ivar", "touched", "eff"),
)
def _gp_light(m_ivar, ivar, touched, eff, node_idx_tab,
              acc_mean, acc_var, present, slots_flat, scan_start, scan_count,
              G: int, sf2: float, min_known_ivar: float, max_ivar: float,
              n: int, max_level: int, state_fn=None, do_prune: bool = False,
              scan_bt: int = 256):
    """Per-scan sequential BCM fusion + prune over the prediction tables."""
    Tp = slots_flat.shape[0]
    V = node_idx_tab.shape[1]
    cap = eff.shape[0] - 1
    vcol = jnp.arange(V, dtype=jnp.int32)
    brow = jnp.arange(scan_bt, dtype=jnp.int32)
    gcol = jnp.arange(G, dtype=jnp.int32)

    def light_step(carry, xs):
        m_ivar, ivar, touched, eff = carry
        start, count = xs
        bidx = jnp.minimum(start + brow, Tp - 1)
        mask = brow < count
        slots_k = jnp.where(mask, slots_flat[bidx], cap + 1)
        rows = bidx[:, None] * G + gcol[None, :]            # [Bt,G]
        mb = acc_mean[rows]                                 # [Bt,G,Vall]
        vb = acc_var[rows]
        pb = present[rows] & mask[:, None]                  # [Bt,G]
        eff_b = eff[jnp.minimum(slots_k, cap)]              # [Bt,V]
        nidx = node_idx_tab[eff_b.astype(jnp.int32), vcol[None, :]]  # [Bt,V]
        # per-voxel values at the current eff-level node, slot-major → [Bt,V,G]
        means = jnp.moveaxis(
            jnp.take_along_axis(mb, nidx[:, None, :], axis=2), 1, -1)
        vars_ = jnp.moveaxis(
            jnp.take_along_axis(vb, nidx[:, None, :], axis=2), 1, -1)
        vars_ = jnp.where(vars_ == 0.0, 1.0, vars_)         # padded-row guard
        cur_mi = m_ivar[jnp.minimum(slots_k, cap)]
        cur_iv = ivar[jnp.minimum(slots_k, cap)]
        new_mi, new_iv = kgp.bcm_update_sequential(
            cur_mi, cur_iv, means, vars_,
            jnp.broadcast_to(pb[:, None, :], means.shape),
            sf2, min_known_ivar, max_ivar)
        any_p = jnp.any(pb, axis=-1)[:, None]
        m_ivar = m_ivar.at[slots_k].set(
            jnp.where(any_p, new_mi, cur_mi), mode="drop")
        ivar = ivar.at[slots_k].set(
            jnp.where(any_p, new_iv, cur_iv), mode="drop")
        touched = touched.at[slots_k].max(
            jnp.broadcast_to(any_p, new_mi.shape), mode="drop")
        if do_prune:
            safe = jnp.minimum(slots_k, cap)
            vals = {"m_ivar": m_ivar[safe], "ivar": ivar[safe],
                    "touched": touched[safe].astype(jnp.float32)}
            new_vals, new_eff = pruning.prune_blocks(
                vals, eff[safe], n=n, max_level=max_level, state_fn=state_fn)
            m_ivar = m_ivar.at[slots_k].set(new_vals["m_ivar"], mode="drop")
            ivar = ivar.at[slots_k].set(new_vals["ivar"], mode="drop")
            touched = touched.at[slots_k].set(new_vals["touched"] > 0, mode="drop")
            eff = eff.at[slots_k].set(new_eff, mode="drop")
        return (m_ivar, ivar, touched, eff), None

    (m_ivar, ivar, touched, eff), _ = jax.lax.scan(
        light_step, (m_ivar, ivar, touched, eff), (scan_start, scan_count))
    return m_ivar, ivar, touched, eff


@functools.partial(jax.jit, static_argnames=("M", "T"))
def _gp_tier_gather(ustart, ucount, nb_row, sel, M: int, T: int):
    """Tier-selected model tables from the per-scan ingest outputs.

    ``sel`` [Mp] flat (scan·Bu + block) indices (−1 ⇒ padding model); adds
    the static per-scan offsets into the flattened point table ([K·M]) and
    test-block list ([K·T]).
    """
    K, Bu = ustart.shape
    ok = sel >= 0
    s = jnp.clip(sel, 0) // Bu
    b = jnp.clip(sel, 0) % Bu
    st = ustart[s, b] + s * M
    cn = jnp.where(ok, ucount[s, b], 0)
    nb = jnp.where(ok[:, None] & (nb_row[s, b] < T),
                   nb_row[s, b] + (s * T)[:, None], K * T)
    return st.astype(jnp.int32), cn.astype(jnp.int32), nb.astype(jnp.int32)


class GPOctoMap(ingest.DeviceIngestMixin, base.OccupancyMapBase):
    SCAN_BATCH = _SCAN_BATCH
    _INGEST_FETCH = ("ucount",)

    def __init__(self, cfg: MapConfig):
        # min_ivar = 1/max_var etc. (gpoctomap.cpp:39-41)
        self.min_ivar = 1.0 / cfg.max_var
        self.max_ivar = 1.0 / cfg.min_var
        self.min_known_ivar = 1.0 / cfg.max_known_var
        super().__init__(cfg)

    def _field_fills(self):
        return {"m_ivar": 0.0, "ivar": self.min_ivar}

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

    def insert_pointcloud(self, cloud, origin, ds_resolution=None,
                          free_resolution=None, max_range=None) -> None:
        if self._insert_device([cloud], [origin], ds_resolution,
                               free_resolution, max_range):
            return
        t0 = time.perf_counter()
        t = self._scan_model_tables(cloud, origin, ds_resolution,
                                    free_resolution, max_range)
        self.stats["host_s"] += time.perf_counter() - t0
        self._integrate([t] if t is not None else [])

    def insert_pointclouds(self, clouds, origins, ds_resolution=None,
                           free_resolution=None, max_range=None) -> None:
        """Integrate a scan sequence, ≤ _SCAN_BATCH scans per dispatch pair
        (one heavy dispatch per size tier — usually one — plus one light).
        On an accelerator the preprocessing pipeline runs on-device; on the host path
        chunks are streamed so preprocessing overlaps device compute
        (see bgk.py::insert_pointclouds)."""
        if self._insert_device(clouds, origins, ds_resolution,
                               free_resolution, max_range):
            return
        with ThreadPoolExecutor(max_workers=min(8, max(len(clouds), 1))) as ex:
            futures = [ex.submit(self._scan_model_tables, c, o, ds_resolution,
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
        t = self._model_tables(points.astype(np.float32),
                               labels.astype(np.float32))
        self._integrate([t] if t is not None else [])

    # ------------------------------------------------------------- internals

    def _scan_model_tables(self, cloud, origin, ds_resolution, free_resolution,
                           max_range):
        cfg = self.cfg
        from la3dm_tpu.geometry import native

        args = (cloud, origin,
                cfg.ds_resolution if ds_resolution is None else ds_resolution,
                cfg.free_resolution if free_resolution is None else free_resolution,
                cfg.max_range if max_range is None else max_range)
        td = native.bgk_training_data(*args, free_label=-1.0)  # gpoctomap.cpp:399
        if td is None:  # no native toolchain — numpy fallback
            td = preprocess.bgk_training_data(*args, free_label=-1.0)
        if len(td.points) == 0:
            return None
        return self._model_tables(td.points.astype(np.float32),
                                  td.labels.astype(np.float32))

    def _model_tables(self, points: np.ndarray, labels: np.ndarray):
        """One scan → (sorted points/labels, per-model segments, test-block
        coords, per-model target rows)."""
        from la3dm_tpu.geometry import native

        nt = native.scan_bucket_tables(points, labels, self.block_size,
                                       self._neighbor_offsets)
        if nt is not None:  # fused C++ path, bit-identical to the numpy one
            if len(nt["model_starts"]) == 0:
                return None
            return {"pts": nt["entries"], "lab": nt["labels"],
                    "starts": nt["model_starts"].astype(np.int64),
                    "counts": nt["model_counts"].astype(np.int64),
                    "nb_t": nt["nb_t"], "test_coords": nt["test_coords"]}
        coords, pidx = geo.point_block_memberships(points, self.block_size)
        order, ukeys, starts, counts = bucketing.group_by_block(coords)
        if len(ukeys) == 0:
            return None
        pts_s = points[pidx][order]
        lab_s = labels[pidx][order]
        model_coords = geo.unpack_key(ukeys)

        test_coords = bucketing.test_blocks_for(ukeys, self._neighbor_offsets)
        test_keys = geo.pack_key(test_coords)  # sorted (unique order)
        G = self.num_slots
        # model m at coord c serves test block c − off[s] at slot s
        nb_t = np.empty((len(ukeys), G), np.int32)
        for s, off in enumerate(self._neighbor_offsets):
            keys = geo.pack_key(model_coords - off[None, :])
            nb_t[:, s] = np.searchsorted(test_keys, keys)  # always present
        return {"pts": pts_s, "lab": lab_s,
                "starts": starts.astype(np.int64),
                "counts": counts.astype(np.int64),
                "nb_t": nb_t, "test_coords": test_coords}

    # ------------------------------------------------ device-side ingestion

    def _ingest_overflow_fallback(self, clouds, origins, ds, fr, mr) -> None:
        tables = []
        for c, o in zip(clouds, origins):
            t0 = time.perf_counter()
            t = self._scan_model_tables(c, o, ds, fr, mr)
            self.stats["host_s"] += time.perf_counter() - t0
            if t is not None:
                tables.append(t)
        self._integrate(tables)

    def _dispatch_ingest_chunk(self, out, fetched, slots, centers, spec,
                               K_pad: int, n_scans: int) -> None:
        """Device model tables → tiered heavy passes → BCM light pass."""
        t0 = time.perf_counter()
        cfg = self.cfg
        G = self.num_slots
        T = spec.T
        Vall = self._all_nodes_host.shape[0]
        Tp = K_pad * T
        ucount = fetched["ucount"]                           # [K,Bu]
        counts = ucount[ucount > 0]
        self.stats["kernel_evals"] += int(
            (counts.astype(np.int64) ** 2).sum()
            + counts.sum() * G * Vall)
        self.stats["scans"] += n_scans

        if not hasattr(self, "_dev_consts"):
            self._dev_consts = (jnp.asarray(self._all_nodes_host),
                                jnp.asarray(self._node_idx_host))
        an_dev, ni_dev = self._dev_consts
        pts_dev = out["ent"].reshape(K_pad * spec.M, 3)
        lab_dev = out["lab"].reshape(K_pad * spec.M)
        ctr_dev = jnp.asarray(centers)

        acc_mean = jnp.zeros((Tp * G, Vall), jnp.float32)
        acc_var = jnp.ones((Tp * G, Vall), jnp.float32)
        present = jnp.zeros((Tp * G,), bool)

        # tier selection over the fetched per-model counts (gp host path)
        flat_idx = np.nonzero(ucount.reshape(-1) > 0)[0].astype(np.int32)
        cflat = ucount.reshape(-1)[flat_idx]
        mx = int(cflat.max(initial=0))
        tier_caps = [_TIER0] if mx <= _TIER0 else [_TIER0, base.next_pow2(mx)]
        pad = _GLOBAL_PADS.setdefault(
            ("ingest", type(self).__name__, cfg, K_pad), {"tiers": {}})
        lo = 0
        for S in tier_caps:
            sel = flat_idx[(cflat > lo) & (cflat <= S)]
            lo = S
            if len(sel) == 0:
                continue
            chunk = _chunk_for(S)
            # base-tier seed covers the bundled workloads' model counts so
            # fresh processes land on one cached executable
            tp = pad["tiers"].setdefault(
                S, {"M": 2048 if S == _TIER0 else chunk})
            tp["M"] = max(tp["M"], base.round_up(max(len(sel), chunk), chunk))
            sel_p = np.full(tp["M"], -1, np.int32)
            sel_p[:len(sel)] = sel
            st_t, cn_t, nb_t = _gp_tier_gather(
                out["ustart"], out["ucount"], out["nb_row"],
                jnp.asarray(sel_p), M=spec.M, T=T)
            acc_mean, acc_var, present = _gp_heavy(
                acc_mean, acc_var, present, an_dev, pts_dev, lab_dev,
                st_t, cn_t, nb_t, ctr_dev,
                S=S, chunk=chunk, G=G, sf2=cfg.sf2, ell=cfg.ell,
                noise=cfg.noise)

        ss = np.arange(K_pad, dtype=np.int32) * T
        sc = np.full(K_pad, T, np.int32)
        self.stats["host_s"] += time.perf_counter() - t0
        (self.pool.fields["m_ivar"], self.pool.fields["ivar"],
         self.pool.touched, self.pool.eff_level) = _gp_light(
            self.pool.fields["m_ivar"], self.pool.fields["ivar"],
            self.pool.touched, self.pool.eff_level, ni_dev,
            acc_mean, acc_var, present,
            jnp.asarray(slots), jnp.asarray(ss), jnp.asarray(sc),
            G=G, sf2=cfg.sf2, min_known_ivar=self.min_known_ivar,
            max_ivar=self.max_ivar, n=self.n, max_level=cfg.block_depth - 1,
            state_fn=self._state_fn, do_prune=cfg.block_depth > 1,
            scan_bt=T)

    def _integrate(self, tables: list) -> None:
        if not tables:
            return
        if len(tables) > _SCAN_BATCH:
            for i in range(0, len(tables), _SCAN_BATCH):
                self._integrate(tables[i:i + _SCAN_BATCH])
            return
        t_host0 = time.perf_counter()
        cfg = self.cfg
        G = self.num_slots
        Vall = self._all_nodes_host.shape[0]

        pts_parts, lab_parts = [], []
        st_parts, ct_parts, nb_parts = [], [], []
        slot_parts, ctr_parts, coord_parts = [], [], []
        scan_start, scan_count = [], []
        pt_off = 0
        blk_off = 0
        gen0 = self.pool.generation
        for t in tables:
            # per-test-block training-point totals (summed over the G
            # neighbor models via nb_t) weight load-aware placement
            w = np.zeros(len(t["test_coords"]), np.float64)
            np.add.at(w, t["nb_t"].reshape(-1),
                      np.repeat(t["counts"], t["nb_t"].shape[1]))
            slots = self.pool.ensure(t["test_coords"], weights=w)
            coord_parts.append(t["test_coords"])
            pts_parts.append(t["pts"])
            lab_parts.append(t["lab"])
            st_parts.append(t["starts"] + pt_off)
            ct_parts.append(t["counts"])
            nb_parts.append(t["nb_t"] + blk_off)
            slot_parts.append(slots.astype(np.int32))
            ctr_parts.append(self.block_centers(t["test_coords"]).astype(np.float32))
            scan_start.append(blk_off)
            scan_count.append(len(slots))
            pt_off += len(t["pts"])
            blk_off += len(slots)
            self.stats["kernel_evals"] += int(
                (t["counts"] ** 2).sum() + t["counts"].sum() * G * Vall)
            self.stats["scans"] += 1

        pts_all = np.concatenate(pts_parts, axis=0)
        lab_all = np.concatenate(lab_parts)
        starts = np.concatenate(st_parts)
        counts = np.concatenate(ct_parts)
        nb_t = np.concatenate(nb_parts, axis=0)
        slots_flat = np.concatenate(slot_parts)
        if self.pool.generation != gen0:
            # sharded pool grew while later tables were ensured: earlier
            # tables' slot ids were remapped — re-resolve the whole batch
            slots_flat = self.pool.lookup(
                np.concatenate(coord_parts, axis=0)).astype(np.int32)
        centers_flat = np.concatenate(ctr_parts, axis=0)
        Bt_max = max(scan_count)

        pad = _GLOBAL_PADS.setdefault(
            (type(self).__name__, cfg),
            {"N": 1024, "T": 256, "B": 256, "tiers": {}})
        pad["N"] = max(pad["N"], base.next_pow2(max(len(pts_all), 1024)))
        pad["T"] = max(pad["T"], base.round_up(max(len(slots_flat), 256), 256))
        pad["B"] = max(pad["B"], base.round_up(max(Bt_max, 256), 256))
        Np, Tp, Btp = pad["N"], pad["T"], pad["B"]

        pts_p = np.zeros((Np, 3), np.float32)
        pts_p[:len(pts_all)] = pts_all
        lab_p = np.zeros(Np, np.float32)
        lab_p[:len(lab_all)] = lab_all
        sl_p = np.full(Tp, self.pool.capacity, np.int32)
        sl_p[:len(slots_flat)] = slots_flat
        ct_p = np.zeros((Tp, 3), np.float32)
        ct_p[:len(centers_flat)] = centers_flat
        # pad K to the fixed batch size (count-0 steps are no-ops; see bgk.py)
        K_scans = len(tables)
        K_pad = 1 if K_scans == 1 else _SCAN_BATCH
        ss = np.zeros(K_pad, np.int32)
        ss[:K_scans] = scan_start
        sc = np.zeros(K_pad, np.int32)
        sc[:K_scans] = scan_count

        if not hasattr(self, "_dev_consts"):
            self._dev_consts = (jnp.asarray(self._all_nodes_host),
                                jnp.asarray(self._node_idx_host))
        an_dev, ni_dev = self._dev_consts
        pts_dev = jnp.asarray(pts_p)
        lab_dev = jnp.asarray(lab_p)
        ctr_dev = jnp.asarray(ct_p)

        # prediction tables (double-buffer target of the heavy tiers)
        acc_mean = jnp.zeros((Tp * G, Vall), jnp.float32)
        acc_var = jnp.ones((Tp * G, Vall), jnp.float32)
        present = jnp.zeros((Tp * G,), bool)

        # size tiers: base tier _TIER0 + one overflow tier when needed
        mx = int(counts.max())
        tier_caps = [_TIER0] if mx <= _TIER0 else [_TIER0, base.next_pow2(mx)]
        lo = 0
        for S in tier_caps:
            sel = np.nonzero((counts > lo) & (counts <= S))[0]
            lo = S
            if len(sel) == 0:
                continue
            chunk = _chunk_for(S)
            tp = pad["tiers"].setdefault(S, {"M": chunk})
            tp["M"] = max(tp["M"], base.round_up(max(len(sel), chunk), chunk))
            Mp = tp["M"]
            st_t = np.zeros(Mp, np.int32)
            st_t[:len(sel)] = starts[sel]
            cn_t = np.zeros(Mp, np.int32)  # 0 ⇒ padding model
            cn_t[:len(sel)] = counts[sel]
            nb_p = np.full((Mp, G), Tp, np.int32)
            nb_p[:len(sel)] = nb_t[sel]
            acc_mean, acc_var, present = _gp_heavy(
                acc_mean, acc_var, present, an_dev,
                pts_dev, lab_dev,
                jnp.asarray(st_t), jnp.asarray(cn_t), jnp.asarray(nb_p),
                ctr_dev,
                S=S, chunk=chunk, G=G, sf2=cfg.sf2, ell=cfg.ell,
                noise=cfg.noise)

        self.stats["host_s"] += time.perf_counter() - t_host0
        (self.pool.fields["m_ivar"], self.pool.fields["ivar"],
         self.pool.touched, self.pool.eff_level) = _gp_light(
            self.pool.fields["m_ivar"], self.pool.fields["ivar"],
            self.pool.touched, self.pool.eff_level, ni_dev,
            acc_mean, acc_var, present,
            jnp.asarray(sl_p), jnp.asarray(ss), jnp.asarray(sc),
            G=G, sf2=cfg.sf2, min_known_ivar=self.min_known_ivar,
            max_ivar=self.max_ivar, n=self.n, max_level=cfg.block_depth - 1,
            state_fn=self._state_fn, do_prune=cfg.block_depth > 1,
            scan_bt=Btp)

    def _make_state_fn(self):
        cfg = self.cfg
        return posterior.GPStateFn(cfg.l, 1.0 / cfg.min_var, 1.0 / cfg.max_known_var,
                                   cfg.free_thresh, cfg.occupied_thresh)

    def _posterior(self, fields):
        cfg = self.cfg
        mi, iv = fields["m_ivar"], fields["ivar"]
        with np.errstate(over="ignore", divide="ignore"):
            prob = 1.0 / (1.0 + np.exp(-cfg.l * mi / self.max_ivar))
            var = 1.0 / iv
        st = np.where(prob > cfg.occupied_thresh, posterior.OCCUPIED,
                      np.where(prob < cfg.free_thresh, posterior.FREE, posterior.UNKNOWN))
        st = np.where(iv < self.min_known_ivar, posterior.UNKNOWN, st)
        st = np.where(fields["touched"], st, posterior.UNKNOWN).astype(np.int8)
        return {"prob": prob, "var": var, "state": st,
                "m_ivar": np.asarray(mi), "ivar": np.asarray(iv)}
