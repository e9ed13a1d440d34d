"""Two-process jax.distributed equivalence (SURVEY §4(c): multi-host on a
CPU mesh, no accelerator required).

Spawns 2 worker processes (2 virtual CPU devices each → a 4-device global
mesh), runs the production scan path on sharded maps of ALL FOUR families
with replicated scan ingestion, and compares the full per-voxel posterior
state against single-process maps on the identical stream.  BGK/BGKL/BGKLV
compare exactly per field; GP compares in posterior (probability/variance)
space — its BCM information-form update amplifies f32 reduction-order
drift without bound (see tests/test_sharded.py:44-54).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _load_state(path):
    data = np.load(path)
    coords = data["coords"]
    order = np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
    return {k: np.asarray(data[k])[order] for k in data.files if k != "config"}


def test_two_process_sharded_matches_single(tmp_path):
    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen([sys.executable, WORKER, coord, "2", str(pid),
                          str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    assert any("SAVED" in out for out, _ in outs)

    # single-process references on the identical stream, same tiny pads
    from tests import multihost_worker as w
    from la3dm_tpu.models.bgk import BGKOctoMap
    from la3dm_tpu.models.bgkl import BGKLOctoMap
    from la3dm_tpu.models.bgklv import BGKLVOctoMap
    from la3dm_tpu.models.gp import GPOctoMap

    w.seed_tiny_pads()
    for cls, cfg, name in [(BGKOctoMap, w.BGK_CFG, "bgk"),
                           (BGKLOctoMap, w.BGKL_CFG, "bgkl"),
                           (BGKLVOctoMap, w.LV_CFG, "bgklv"),
                           (GPOctoMap, w.GP_CFG, "gp")]:
        m = cls(cfg)
        for cloud, origin in w.scan_stream():
            m.insert_pointcloud(cloud, origin)
        ref_path = tmp_path / f"{name}_single.npz"
        m.save(str(ref_path))

        got = _load_state(tmp_path / f"{name}_map.npz")
        want = _load_state(ref_path)
        assert got["coords"].shape == want["coords"].shape, name
        np.testing.assert_array_equal(got["coords"], want["coords"], err_msg=name)
        if name == "gp":
            ivar0 = 1.0 / cfg.min_var
            p_got = 1.0 / (1.0 + np.exp(-cfg.l * got["field_m_ivar"] / ivar0))
            p_want = 1.0 / (1.0 + np.exp(-cfg.l * want["field_m_ivar"] / ivar0))
            np.testing.assert_allclose(p_got, p_want, atol=1e-3,
                                       err_msg="gp per-voxel probability")
            np.testing.assert_allclose(
                1.0 / got["field_ivar"], 1.0 / want["field_ivar"],
                atol=1e-3, rtol=1e-3, err_msg="gp per-voxel variance")
            continue
        for k in want:
            if k == "coords":
                continue
            np.testing.assert_allclose(
                got[k].astype(np.float64), want[k].astype(np.float64),
                atol=1e-5, rtol=1e-5,
                err_msg=f"{name} per-voxel field {k}")
