"""Parity checks shared by the gpu-marked tests and ``chip_smoke.py``.

Each check runs on JAX's default device, so the same code compares the
fast path with its references on the CPU here and on the GPU there:

* :data:`ORACLE_CASES` — the families against the numpy oracle at the sizes
  and tolerances of ``test_bgk_vs_oracle.py`` / ``test_families_vs_oracle.py``;
* :func:`ingest_on_off` — device ingestion against the host path, as
  ``test_device_ingest.py`` does;
* :func:`checkpoint_diff` — two saved maps (``OccupancyMapBase.save``)
  compared voxel by voxel in posterior space.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from la3dm_tpu.geometry import blocks as geo
from la3dm_tpu.models.bgk import BGKOctoMap
from la3dm_tpu.models.bgkl import BGKLOctoMap
from la3dm_tpu.models.bgklv import BGKLVOctoMap
from la3dm_tpu.models.gp import GPOctoMap
from tests.oracle.oracle_maps import OracleBGK, OracleBGKL, OracleBGKLV, OracleGP
from tests.test_bgk_vs_oracle import CFG, compare_maps, synthetic_scan
from tests.test_families_vs_oracle import BGKL_CFG, GP_CFG, LV_CFG

#: README's acceptance bound on the mean absolute posterior deviation
MAE_BOUND = 1e-2


def _oracle_case(cls, ocls, cfg, n, n_scans, step, axis, seed, **tol):
    """Insert ``n_scans`` synthetic scans into the fast map and the oracle,
    then ``compare_maps`` (raises AssertionError past the tolerance)."""
    rng = np.random.default_rng(seed)
    fast, om = cls(cfg), ocls(cfg)
    for i in range(n_scans):
        origin = np.array([0.1, -0.2, 0.3])
        origin[axis] += step * i
        cloud, o = synthetic_scan(rng, n=n, origin=tuple(origin))
        fast.insert_pointcloud(cloud, o)
        om.insert_pointcloud(cloud, o, cfg.ds_resolution, cfg.free_resolution,
                             cfg.max_range)
    return compare_maps(fast, om, **tol)


#: name → (map class, oracle class, config, points, scans, origin step,
#: step axis, tolerances) — the oracle tests' sizes and tolerances
ORACLE_CASES = {
    "bgk_single": (BGKOctoMap, OracleBGK, CFG, 120, 1, 0.0, 0, {}),
    "bgk_multi_pruned": (BGKOctoMap, OracleBGK, CFG, 100, 3, 0.3, 0,
                         {"atol": 5e-3}),
    "bgkl_single": (BGKLOctoMap, OracleBGKL, BGKL_CFG, 60, 1, 0.0, 1,
                    {"atol": 3e-3}),
    "bgkl_multi": (BGKLOctoMap, OracleBGKL, BGKL_CFG, 50, 2, 0.4, 1,
                   {"atol": 5e-3}),
    "bgklv_single": (BGKLVOctoMap, OracleBGKLV, LV_CFG, 60, 1, 0.0, 1,
                     {"atol": 3e-3, "touched_mass_tol": 5e-3}),
    "bgklv_multi": (BGKLVOctoMap, OracleBGKLV, LV_CFG, 40, 2, 0.4, 1,
                    {"atol": 5e-3, "touched_mass_tol": 5e-3}),
    "gp_single": (GPOctoMap, OracleGP, GP_CFG, 40, 1, 0.0, 1,
                  {"atol": 5e-2, "rtol": 0.02}),
    "gp_multi": (GPOctoMap, OracleGP, GP_CFG, 30, 2, 0.4, 1,
                 {"atol": 1e-1, "rtol": 0.05}),
}


def oracle_case(name: str, seed: int = 0) -> tuple[int, float]:
    """(voxels checked, max deviation) of one :data:`ORACLE_CASES` entry."""
    cls, ocls, cfg, n, n_scans, step, axis, tol = ORACLE_CASES[name]
    return _oracle_case(cls, ocls, cfg, n, n_scans, step, axis, seed, **tol)


#: the device-ingest comparison's families (LV has no device ingestion)
INGEST_FAMILIES = {"bgk": (BGKOctoMap, CFG), "bgkl": (BGKLOctoMap, BGKL_CFG),
                   "gp": (GPOctoMap, GP_CFG)}


def ingest_on_off(family: str, seed: int, max_range: float = 6.0) -> dict:
    """Device ingestion (``device_ingest="on"``, batched) against the host
    path (per scan) on three synthetic scans: ``test_device_ingest.py``'s
    comparison, returning its deviations instead of asserting them."""
    cls, cfg = INGEST_FAMILIES[family]
    rng = np.random.default_rng(seed)
    host = cls(dataclasses.replace(cfg, device_ingest="off"))
    dev = cls(dataclasses.replace(cfg, device_ingest="on"))
    scans = [synthetic_scan(rng, n=90, origin=(0.1, -0.2 + 0.3 * i, 0.3))
             for i in range(3)]
    for cloud, origin in scans:
        host.insert_pointcloud(cloud, origin, max_range=max_range)
    dev.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                           max_range=max_range)
    return map_diff(host, dev)


def _voxel_table(data: dict, m) -> tuple[np.ndarray, dict]:
    """Sorted global voxel keys + posterior arrays of a saved map."""
    coords = np.asarray(data["coords"]).reshape(-1, 3)
    V = m.V
    fields = {k[len("field_"):]: np.asarray(v) for k, v in data.items()
              if k.startswith("field_")}
    post = m._posterior({**fields, "touched": np.asarray(data["touched"])})
    keys = (geo.pack_key(coords).astype(np.int64)[:, None] * V
            + np.arange(V, dtype=np.int64)[None, :]).reshape(-1)
    order = np.argsort(keys)
    table = {"prob": post["prob"].reshape(-1)[order],
             "state": post["state"].reshape(-1)[order],
             "touched": np.asarray(data["touched"]).reshape(-1)[order]}
    for k, v in fields.items():
        table[k] = v.reshape(-1)[order]
    return keys[order], table


def _prior(m) -> dict:
    fills = {k: np.full((1, 1), v, np.float32) for k, v in m.FIELD_FILLS.items()}
    post = m._posterior({**fills, "touched": np.zeros((1, 1), bool)})
    return {"prob": post["prob"].reshape(-1)[0],
            "state": post["state"].reshape(-1)[0], "touched": False,
            **{k: np.float32(v) for k, v in m.FIELD_FILLS.items()}}


def table_diff(a: tuple, b: tuple, m) -> dict:
    """Compare two voxel tables; voxels of blocks one map lacks take the
    prior.  Statistics run over voxels touched in either map."""
    (ka, ta), (kb, tb) = a, b
    keys = np.union1d(ka, kb)
    prior = _prior(m)

    def spread(k, t, name):
        out = np.full(len(keys), prior[name], dtype=t[name].dtype)
        out[np.searchsorted(keys, k)] = t[name]
        return out

    touched = spread(ka, ta, "touched") | spread(kb, tb, "touched")
    pa, pb = spread(ka, ta, "prob")[touched], spread(kb, tb, "prob")[touched]
    both_nan = np.isnan(pa) & np.isnan(pb)
    d = np.where(both_nan, 0.0, np.abs(pa.astype(np.float64) - pb))
    d = np.where(np.isnan(d), 1.0, d)        # NaN against a number
    sa, sb = spread(ka, ta, "state")[touched], spread(kb, tb, "state")[touched]
    identical = (len(ka) == len(kb) and bool(np.array_equal(ka, kb))
                 and all(np.array_equal(ta[k], tb[k], equal_nan=True)
                         if ta[k].dtype.kind == "f" else
                         np.array_equal(ta[k], tb[k]) for k in ta))
    return {"touched": int(touched.sum()),
            "blocks_only_a": int(len(np.setdiff1d(ka // m.V, kb // m.V))),
            "blocks_only_b": int(len(np.setdiff1d(kb // m.V, ka // m.V))),
            "mae": float(d.mean()) if len(d) else 0.0,
            "max_abs": float(d.max()) if len(d) else 0.0,
            "state_differs": float((sa != sb).mean()) if len(sa) else 0.0,
            "bit_identical": identical}


def _saved(m) -> dict:
    buf = io.BytesIO()
    m.save(buf)
    buf.seek(0)
    with np.load(buf) as z:
        return dict(z)


def map_diff(a, b) -> dict:
    """:func:`table_diff` of two live maps of one family and config."""
    return table_diff(_voxel_table(_saved(a), a), _voxel_table(_saved(b), b), a)


def checkpoint_diff(path_a: str, path_b: str, m) -> dict:
    """:func:`table_diff` of two checkpoints saved by maps like ``m``."""
    with np.load(path_a) as da, np.load(path_b) as db:
        return table_diff(_voxel_table(dict(da), m), _voxel_table(dict(db), m), m)
