"""Parity of the four families on an NVIDIA GPU, and the parity helpers.

The ``gpu``-marked tests run the checks of ``tests/parity.py`` on the card:
the numpy oracle at the oracle tests' sizes and tolerances, device against
host ingestion, and a generated-scan map against the same run on the CPU
backend.  Whether a GPU is present is decided in the ``gpu`` fixture, so
every worker collects the same tests; on the CPU they skip.  Run them on a
card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/test_gpu_parity.py``.  The unmarked tests check the helpers on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import jax

from la3dm_tpu.io import synthetic
from la3dm_tpu.pipeline import build_map, run_static
from la3dm_tpu.utils.config import load_dataset_config, load_method_config
from tests import parity as P


@pytest.fixture
def gpu():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu "
                    "on a machine with a card)")
    return devs[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(P.ORACLE_CASES))
def test_oracle_parity_on_gpu(gpu, name):
    n, _ = P.oracle_case(name)
    assert n > 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("family", list(P.INGEST_FAMILIES))
def test_device_ingest_matches_host_on_gpu(gpu, family, seed):
    d = P.ingest_on_off(family, seed)
    assert d["touched"] > 0
    assert d["blocks_only_a"] == 0 and d["blocks_only_b"] == 0
    assert d["max_abs"] <= 1e-3, d


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["bgk", "bgkl", "bgklv", "gp"])
def test_gpu_map_matches_cpu_backend(gpu, family, tmp_path):
    kind = "unstructured" if family == "gp" else "structured"
    ds = load_dataset_config(synthetic.write_dataset(
        str(tmp_path), "g", kind, 3, seed=11))
    cfg = load_method_config(family)
    on_gpu = run_static(cfg, ds).map
    with jax.default_device(jax.devices("cpu")[0]):
        on_cpu = run_static(dataclasses.replace(cfg, device_ingest="off"),
                            ds).map
    d = P.map_diff(on_gpu, on_cpu)
    assert d["touched"] > 0
    assert d["mae"] <= P.MAE_BOUND, d


# ------------------------------------------------- the helpers, on the CPU


def _small_map(family, seed=3):
    from tests.test_bgk_vs_oracle import synthetic_scan

    cfg = {"bgk": P.CFG, "bgklv": P.LV_CFG}[family]
    m = build_map(cfg)
    m.insert_pointcloud(*synthetic_scan(np.random.default_rng(seed), n=40))
    return m


@pytest.mark.parametrize("family", ["bgk", "bgklv"])
def test_map_diff_of_a_map_with_itself_is_zero(family):
    m = _small_map(family)
    d = P.map_diff(m, m)
    assert d["touched"] > 0 and d["bit_identical"]
    assert d["mae"] == 0.0 and d["max_abs"] == 0.0 and d["state_differs"] == 0.0


def test_checkpoint_diff_sees_a_perturbed_voxel(tmp_path):
    m = _small_map("bgk")
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    m.save(a)
    with np.load(a) as z:
        data = dict(z)
    t = data["touched"]
    s, v = np.argwhere(t)[0]
    data["field_A"][s, v] += 10.0 * (data["field_A"][s, v] + data["field_B"][s, v])
    np.savez(b, **data)
    d = P.checkpoint_diff(a, b, m)
    assert not d["bit_identical"]
    assert d["max_abs"] > 0.1 and 0 < d["mae"] < d["max_abs"]
    assert P.checkpoint_diff(a, a, m)["bit_identical"]


def test_map_diff_counts_missing_blocks_as_prior():
    m = _small_map("bgk")
    empty = build_map(m.cfg)
    d = P.map_diff(m, empty)
    assert d["blocks_only_a"] == m.pool.n_blocks and d["blocks_only_b"] == 0
    assert d["touched"] > 0 and d["max_abs"] > 0
