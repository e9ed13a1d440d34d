"""Shared device-ingestion plumbing for the map families.

:class:`DeviceIngestMixin` drives :mod:`la3dm_tpu.geometry.device_ingest`
for a scan sequence: pad raw clouds, enqueue the on-device preprocessing
batch, fetch the tiny test-block key table, allocate pool slots, and hand
the device-resident tables to the family's engine dispatch.  Families
implement ``_dispatch_ingest_chunk``; unsupported configs (or per-chunk
table overflows) fall back to the bit-exact host path chunk by chunk, and
each such chunk is counted in ``stats["host_fallback_chunks"]``.
"""

from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from la3dm_tpu.geometry import blocks as geo, device_ingest


class DeviceIngestMixin:
    """Chunked scan-sequence ingestion on the device (see module docstring)."""

    #: device arrays the family's dispatch needs fetched to host (small)
    _INGEST_FETCH: tuple = ()
    #: max scans per device dispatch (set by the family)
    SCAN_BATCH = 16
    #: whether ``device_ingest: auto`` picks device ingestion off the CPU; a
    #: family sets False where its host path measured faster on the GPU
    AUTO_DEVICE_INGEST = True

    def _ingest_enabled(self) -> bool:
        mode = getattr(self.cfg, "device_ingest", "auto")
        if mode == "on":
            return True
        if mode == "off":
            return False
        return self.AUTO_DEVICE_INGEST and jax.default_backend() != "cpu"

    #: hard caps for the monotone spec-dim ladder; a chunk that still
    #: overflows at these goes to the bit-exact host path (the [Bu·G, T]
    #: lookup matmuls grow quadratically past this)
    _DIM_CAPS = {"Ph": 16384, "Pf": 32768, "Bu": 2048, "T": 2048, "Rmax": 256}

    def _ingest_dims(self) -> dict:
        key = ("ingest_dims", type(self).__name__, self.cfg)
        return device_ingest._SPEC_PADS.setdefault(key, {})

    def _ingest_spec(self, ds: float, fr: float, mr: float,
                     max_pts: int) -> device_ingest.IngestSpec | None:
        import dataclasses

        dims = self._ingest_dims()
        P = max(dims.get("P", 4096),
                1 << int(np.ceil(np.log2(max(max_pts, 1)))))
        dims["P"] = P
        spec = device_ingest.spec_for(self.cfg, ds, fr, mr, P)
        if spec is None:
            return None
        grown = {k: max(getattr(spec, k), dims[k])
                 for k in ("Ph", "Pf", "Bu", "T", "Rmax") if k in dims}
        return dataclasses.replace(spec, **grown) if grown else spec

    @property
    def _off_keys_dev(self):
        if not hasattr(self, "_off_keys_cache"):
            self._off_keys_cache = jnp.asarray(
                device_ingest._pack_offsets(self._neighbor_offsets))
        return self._off_keys_cache

    def _insert_device(self, clouds, origins, ds_resolution, free_resolution,
                       max_range) -> bool:
        """Integrate the sequence via device-side ingestion.

        Returns False (nothing integrated) when the config does not support
        the static bounds; chunks whose tables overflow the static pads are
        integrated through the host path individually.
        """
        if not self._ingest_enabled() or not len(clouds):
            return bool(len(clouds) == 0 and self._ingest_enabled())
        cfg = self.cfg
        ds = cfg.ds_resolution if ds_resolution is None else ds_resolution
        fr = cfg.free_resolution if free_resolution is None else free_resolution
        mr = cfg.max_range if max_range is None else max_range
        spec = self._ingest_spec(ds, fr, mr, max(len(c) for c in clouds))
        K = self.SCAN_BATCH
        if spec is None:
            self.stats["host_fallback_chunks"] += -(-len(clouds) // K)
            return False
        # pipeline: keep LOOKAHEAD ingest batches in flight (dispatch + async
        # host copy of the small key tables) before finishing a chunk — the
        # per-chunk fetch of the key tables and the next batches' device
        # compute overlap instead of serializing
        LOOKAHEAD = 4
        pending: list = []
        starts = list(range(0, len(clouds), K))
        for i in starts:
            pending.append(self._ingest_dispatch(
                clouds[i:i + K], origins[i:i + K], spec))
            if len(pending) > LOOKAHEAD:
                self._finish_resynced(pending, ds, fr, mr)
        while pending:
            self._finish_resynced(pending, ds, fr, mr)
        return True

    def _finish_resynced(self, pending: list, ds, fr, mr) -> None:
        """Finish the oldest in-flight chunk, re-dispatching it first if an
        earlier chunk's overflow grew the spec-dim ladder past the spec this
        chunk was dispatched with — its stale tables would otherwise each pay
        a guaranteed-overflow round trip before retrying (advisor r4)."""
        rec = pending.pop(0)
        cur = self._ingest_spec(ds, fr, mr,
                                max(len(c) for c in rec["clouds"]))
        if cur is not None and cur != rec["spec"]:
            rec = self._ingest_dispatch(rec["clouds"], rec["origins"], cur)
        self._ingest_finish(rec, ds, fr, mr, rec["spec"])

    def _ingest_dispatch(self, clouds, origins,
                         spec: device_ingest.IngestSpec) -> dict:
        """Pad + enqueue one batch; start the async copy of the key tables."""
        t0 = time.perf_counter()
        n = len(clouds)
        K_pad = 1 if n == 1 else self.SCAN_BATCH
        cp = np.zeros((K_pad, spec.P, 3), np.float32)
        npts = np.zeros(K_pad, np.int32)
        op = np.zeros((K_pad, 3), np.float32)
        for s, (c, o) in enumerate(zip(clouds, origins)):
            cp[s, :len(c)] = c
            npts[s] = len(c)
            op[s] = np.asarray(o, np.float32).reshape(3)
        self.stats["host_s"] += time.perf_counter() - t0

        out = device_ingest.ingest_batch(
            jnp.asarray(cp), jnp.asarray(npts), jnp.asarray(op),
            self._off_keys_dev, spec)
        fetch_names = ("tkey", "bias", "counts") + tuple(self._INGEST_FETCH)
        for k in fetch_names:
            try:
                out[k].copy_to_host_async()
            except (AttributeError, NotImplementedError):
                break
        return {"out": out, "fetch_names": fetch_names, "K_pad": K_pad,
                "n": n, "clouds": clouds, "origins": origins, "spec": spec}

    def _ingest_finish(self, rec: dict, ds, fr, mr,
                       spec: device_ingest.IngestSpec) -> None:
        out = rec["out"]
        fetched = {k: np.asarray(out[k]) for k in rec["fetch_names"]}

        t0 = time.perf_counter()
        # [K,7]: hit_vox, free_vox, mem, ublk, test, ray uniques, aligned len
        cts = fetched["counts"]
        over = {"Ph": int(cts[:, 0].max(initial=0)),
                "Pf": int(cts[:, 1].max(initial=0)),
                "Bu": int(cts[:, 3].max(initial=0)),
                "T": int(cts[:, 4].max(initial=0))}
        if spec.segments:
            over["Rmax"] = int(cts[:, 5].max(initial=0))
        if any(v > getattr(spec, k) for k, v in over.items()):
            # static pads overflowed: grow the monotone dim ladder and retry
            # this chunk on device (one new executable, cached persistently);
            # past the hard caps, the bit-exact host path takes the chunk
            self.stats["host_s"] += time.perf_counter() - t0
            dims = self._ingest_dims()
            fits = True
            for k, v in over.items():
                if v > getattr(spec, k):
                    grown = 1 << int(np.ceil(np.log2(max(v, 2))))
                    if grown > self._DIM_CAPS[k]:
                        fits = False
                        break
                    dims[k] = max(dims.get(k, 0), grown)
            # counts measured under a too-small spec can themselves be
            # truncated (e.g. n_test only sees the first Bu unique blocks),
            # so growth may cascade — allow a few rounds before giving up
            if fits and rec.get("retries", 0) < 4:
                newspec = self._ingest_spec(
                    ds, fr, mr, max(len(c) for c in rec["clouds"]))
                if newspec is not None:
                    rec2 = self._ingest_dispatch(rec["clouds"],
                                                 rec["origins"], newspec)
                    rec2["retries"] = rec.get("retries", 0) + 1
                    self._ingest_finish(rec2, ds, fr, mr, newspec)
                    return
            self.stats["host_fallback_chunks"] += 1
            self._ingest_overflow_fallback(rec["clouds"], rec["origins"],
                                           ds, fr, mr)
            return
        slots, centers, coords = self._ingest_slots(fetched, spec)
        self.stats["host_s"] += time.perf_counter() - t0
        self._dispatch_ingest_chunk(out, fetched, slots, centers, spec,
                                    rec["K_pad"], rec["n"])

    def _ingest_slots(self, fetched: dict, spec):
        """Pool slots + world centers for the fetched test-block key table."""
        tkey, bias = fetched["tkey"], fetched["bias"]       # [K,T], [K,3]
        K, T = tkey.shape
        valid = tkey != device_ingest._SENT
        coords = np.zeros((K, T, 3), np.int64)
        for s in range(K):
            if valid[s].any():
                coords[s, valid[s]] = device_ingest.unpack_local_keys(
                    tkey[s, valid[s]], bias[s])
        keys = geo.pack_key(coords.reshape(-1, 3))
        flat_valid = valid.reshape(-1)
        uniq = np.unique(keys[flat_valid])
        slots_u = self.pool.ensure(geo.unpack_key(uniq))
        slots = np.full(K * T, self.pool.capacity, np.int32)
        if len(uniq):
            slots[flat_valid] = slots_u[np.searchsorted(uniq, keys[flat_valid])]
        centers = np.zeros((K * T, 3), np.float32)
        centers[flat_valid] = geo.block_center(
            coords.reshape(-1, 3)[flat_valid], self.block_size)
        return slots, centers, coords

    def _ingest_overflow_fallback(self, clouds, origins, ds, fr, mr) -> None:
        """Host-path integration for one chunk (family hook)."""
        raise NotImplementedError

    def _dispatch_ingest_chunk(self, out, fetched, slots, centers, spec,
                               K_pad: int, n_scans: int) -> None:
        """Feed the device-resident tables to the family engine (hook)."""
        raise NotImplementedError
