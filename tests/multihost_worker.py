"""Worker for the 2-process jax.distributed test (see test_multihost.py).

Each process owns 2 virtual CPU devices; the block pools shard over the
4-device global mesh.  Scan ingestion is replicated (deterministic), so
both processes enqueue identical updates and GSPMD handles the cross-host
scatter.  Runs the production scan path (``insert_pointcloud``) for ALL
FOUR families — BGK and BGKL (pool [capacity, V] scatter, point and
segment entries), BGKLV (flat [capacity·V] scatter, the sharding-riskiest
pattern), and GP (double heavy/light pass + BCM scatter) — and saves each
map's full per-voxel state from process 0 for the test to compare.

Usage: python multihost_worker.py <coordinator> <num_procs> <proc_id> <out_dir>
"""

import os
import sys

# each worker owns 2 virtual CPU devices, whatever the environment selects
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from la3dm_tpu.utils.config import MapConfig

BGK_CFG = MapConfig(method="bgk", resolution=0.1, block_depth=3, sf2=1.0,
                    ell=0.2, free_resolution=0.5, ds_resolution=0.1,
                    free_thresh=0.3, occupied_thresh=0.7, var_thresh=100.0,
                    prior_A=0.001, prior_B=0.001, max_range=8.0)
BGKL_CFG = MapConfig(method="bgkl", resolution=0.1, block_depth=3, sf2=0.1,
                     ell=0.2, free_resolution=0.3, ds_resolution=0.1,
                     free_thresh=0.3, occupied_thresh=0.7, var_thresh=0.15,
                     prior_A=0.001, prior_B=0.001, max_range=8.0)
LV_CFG = MapConfig(method="bgklv", resolution=0.1, block_depth=3, sf2=0.1,
                   ell=0.2, free_resolution=0.1, ds_resolution=0.1,
                   free_thresh=0.3, occupied_thresh=0.7, var_thresh=0.2,
                   prior_A=0.001, prior_B=0.001, min_W=0.001, max_range=8.0)
GP_CFG = MapConfig(method="gp", resolution=0.1, block_depth=3, sf2=1.0,
                   ell=1.0, free_resolution=0.5, ds_resolution=0.1,
                   free_thresh=0.3, occupied_thresh=0.7, noise=0.01, l=100.0,
                   min_var=0.001, max_var=1000.0, max_known_var=0.02,
                   max_range=8.0)


def scan_stream():
    """Deterministic 2-scan stream (identical in every process)."""
    rng = np.random.default_rng(123)
    for i in range(2):
        n = 80
        y = rng.uniform(-1.5, 1.5, n)
        z = rng.uniform(0.0, 1.5, n)
        x = 2.0 + 0.05 * rng.standard_normal(n)
        cloud = np.stack([x, y, z], -1).astype(np.float32)
        origin = np.array([0.1, -0.2 + 0.3 * i, 0.3], np.float32)
        yield cloud, origin


def seed_tiny_pads():
    """Small pad ladders: fast CPU compiles in workers and reference alike."""
    from la3dm_tpu.models import bgk as Bm, bgklv as LVm

    for name in ("BGKOctoMap", "ShardedBGKOctoMap"):
        Bm._GLOBAL_PADS.setdefault(
            (name, BGK_CFG),
            {"N": 1024, "F": 4096, "R": Bm._CHUNK, "T": 256, "B": 256})
    for name in ("BGKLOctoMap", "ShardedBGKLOctoMap"):
        Bm._GLOBAL_PADS.setdefault(
            (name, BGKL_CFG),
            {"N": 1024, "F": 4096, "R": Bm._CHUNK, "T": 256, "B": 256})
    for name in ("BGKLVOctoMap", "ShardedBGKLVOctoMap"):
        LVm._GLOBAL_PADS.setdefault(
            (name, LV_CFG), {"E": 1024, "F": 8192, "R": LVm._CHUNK, "T": 256})


def main():
    coord, n_procs, pid, out_dir = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4])
    from la3dm_tpu.parallel import distributed
    from la3dm_tpu.parallel.sharded_map import (ShardedBGKLOctoMap,
                                                ShardedBGKLVOctoMap,
                                                ShardedBGKOctoMap,
                                                ShardedGPOctoMap)

    distributed.initialize(coord, n_procs, pid)
    assert len(jax.devices()) == 2 * n_procs, jax.devices()
    mesh = distributed.global_mesh()
    seed_tiny_pads()

    from la3dm_tpu.parallel import mesh as pm

    rep = pm.replicated(mesh)
    gather = jax.jit(lambda x: x, out_shardings=rep)  # all-gather over hosts
    for cls, cfg, name in [(ShardedBGKOctoMap, BGK_CFG, "bgk"),
                           (ShardedBGKLOctoMap, BGKL_CFG, "bgkl"),
                           (ShardedBGKLVOctoMap, LV_CFG, "bgklv"),
                           (ShardedGPOctoMap, GP_CFG, "gp")]:
        m = cls(cfg, mesh=mesh, capacity=2048)
        for cloud, origin in scan_stream():
            m.insert_pointcloud(cloud, origin)
        # cross-host shards are not host-addressable: all-gather to a
        # replicated copy first, then dump per-voxel state from process 0
        # (every process participates in the collective)
        slots = m.pool.active_slots()
        data = {"coords": m.pool.coords[slots]}
        for k, v in m.pool.fields.items():
            data[f"field_{k}"] = np.asarray(gather(v))[slots]
        data["touched"] = np.asarray(gather(m.pool.touched))[slots]
        data["eff_level"] = np.asarray(gather(m.pool.eff_level))[slots]
        if pid == 0:
            np.savez(os.path.join(out_dir, f"{name}_map.npz"), **data)
    if pid == 0:
        print("SAVED", flush=True)


if __name__ == "__main__":
    main()
