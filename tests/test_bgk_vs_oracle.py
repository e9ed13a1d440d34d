"""Golden tests: BGK fast path vs the literal-semantics numpy oracle."""

import numpy as np
import pytest

from la3dm_tpu.models.bgk import BGKOctoMap
from la3dm_tpu.utils.config import MapConfig
from tests.oracle.oracle_maps import OracleBGK


CFG = MapConfig(method="bgk", resolution=0.1, block_depth=3, sf2=1.0, ell=0.2,
                free_resolution=0.5, ds_resolution=0.1, free_thresh=0.3,
                occupied_thresh=0.7, var_thresh=100.0, prior_A=0.001, prior_B=0.001,
                max_range=8.0)


def synthetic_scan(rng, n=120, scale=2.0, origin=(0.1, -0.2, 0.3)):
    """A wall of hits in front of a sensor origin."""
    origin = np.array(origin, np.float32)
    y = rng.uniform(-scale, scale, n)
    z = rng.uniform(0.0, scale, n)
    x = 2.0 + 0.05 * rng.standard_normal(n)
    return np.stack([x, y, z], -1).astype(np.float32), origin


def compare_maps(fast, oracle_map, atol=2e-3, rtol=0.0, check_state=True,
                 touched_mass_tol=1e-5):
    """Compare every base voxel of the oracle against the fast map.

    ``touched_mass_tol``: touched-flag parity is only asserted when the added
    posterior mass exceeds this — update gates sit on float boundaries (the
    sparse kernel clamp for BGK/BGKL; cube-membership of beam samples for LV,
    where the device path evaluates the sample grid in closed form and can
    differ by 1 ulp from the reference's accumulated sample positions).
    """
    ours_n = fast.n
    oracle_voxels = oracle_map.base_voxel_dict()
    assert len(oracle_voxels) > 0
    # fast map lookup arrays, in RASTER voxel order (the LV family stores
    # its pool tile-major; _gather_rows converts through the map's hooks)
    nb = fast.pool.n_blocks
    coords = fast.pool.coords[:nb]
    slot_of = {tuple(c): i for i, c in enumerate(coords)}
    rows = np.arange(nb)
    fields = {k: fast._gather_rows(v, rows) for k, v in fast.pool.fields.items()}
    touched = fast._gather_rows(fast.pool.touched, rows)
    effs = fast._gather_rows(fast.pool.eff_level, rows)

    names = list(fields)
    prior = np.array([fast.FIELD_FILLS[names[0]], fast.FIELD_FILLS[names[1]]], np.float32)
    n_checked = 0
    max_dev = 0.0
    for (bc, v), leaf in oracle_voxels.items():
        assert bc in slot_of, f"oracle block {bc} missing in fast map"
        s = slot_of[bc]
        ours = np.array([fields[names[0]][s, v], fields[names[1]][s, v]])
        dev = (np.abs(ours - leaf.value) - rtol * np.abs(leaf.value)).max()
        max_dev = max(max_dev, float(dev))
        assert dev < atol, (
            f"block {bc} voxel {v}: ours={ours} oracle={leaf.value} "
            f"(classified={leaf.classified}, ours touched={touched[s, v]})")
        # The k̄>0 gate sits on the sparse kernel's clamp boundary where the
        # value is O(1e-8) and its sign depends on float summation order —
        # touched-flag parity is only well-defined away from that boundary.
        mass = max(np.abs(ours - prior).max(), np.abs(leaf.value - prior).max())
        if mass > touched_mass_tol:
            assert bool(touched[s, v]) == leaf.classified, (bc, v, leaf.value, ours)
        n_checked += 1
    # block sets must agree exactly
    extra = set(slot_of) - {bc for bc, _ in oracle_voxels}
    assert not extra, f"fast map has extra blocks: {sorted(extra)[:5]}"
    return n_checked, max_dev


def test_bgk_single_scan(rng):
    cloud, origin = synthetic_scan(rng)
    fast = BGKOctoMap(CFG)
    fast.insert_pointcloud(cloud, origin)
    oracle_map = OracleBGK(CFG)
    oracle_map.insert_pointcloud(cloud, origin, CFG.ds_resolution, CFG.free_resolution, CFG.max_range)
    n, dev = compare_maps(fast, oracle_map)
    assert n > 500


def test_bgk_multi_scan_with_pruning(rng):
    fast = BGKOctoMap(CFG)
    oracle_map = OracleBGK(CFG)
    for i in range(3):
        cloud, origin = synthetic_scan(rng, n=100, origin=(0.1 + 0.3 * i, -0.2, 0.3))
        fast.insert_pointcloud(cloud, origin)
        oracle_map.insert_pointcloud(cloud, origin, CFG.ds_resolution, CFG.free_resolution, CFG.max_range)
    n, dev = compare_maps(fast, oracle_map, atol=5e-3)
    # eff levels must match the oracle's collapsed leaves
    effs = np.asarray(fast.pool.eff_level[: fast.pool.n_blocks])
    slot_of = {tuple(c): i for i, c in enumerate(fast.pool.coords[: fast.pool.n_blocks])}
    n_pruned_oracle = 0
    for (bc, v), leaf in oracle_map.base_voxel_dict().items():
        L = oracle_map.depth - 1 - leaf.depth
        assert int(effs[slot_of[bc], v]) == L, (bc, v, L, int(effs[slot_of[bc], v]))
        n_pruned_oracle += L > 0
    assert n_pruned_oracle > 0, "test should exercise pruning"


def test_bgk_search_default_node():
    fast = BGKOctoMap(CFG)
    out = fast.search(np.array([[100.0, 100.0, 100.0]]))
    assert out["state"][0] == 2  # UNKNOWN
    assert out["A"][0] == pytest.approx(CFG.prior_A)


def test_bgk_insert_training_data(rng):
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    labels = (rng.uniform(size=50) > 0.5).astype(np.float32)
    fast = BGKOctoMap(CFG)
    fast.insert_training_data(pts, labels)
    oracle_map = OracleBGK(CFG)
    oracle_map.insert_training(pts, labels)
    n, _ = compare_maps(fast, oracle_map)
    assert n > 0
