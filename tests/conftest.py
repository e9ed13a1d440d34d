"""Test environment: an 8-device virtual CPU mesh before JAX initializes.

Sharding correctness is checked on the CPU with
``xla_force_host_platform_device_count`` (SURVEY.md §4).  Tests run on the
CPU unless ``JAX_PLATFORMS`` says otherwise: the ``gpu``-marked tests need a
card and skip without one, so run them there with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_parity.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# honour JAX_PLATFORMS also when jax was imported before this file ran
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one (decided in "
        "the `gpu` fixture of tests/test_gpu_parity.py)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


REFERENCE_DATA = "/root/reference/data"


def reference_scan(dataset="sim_structured", index=1):
    from la3dm_tpu.io.pcd import load_pcd

    path = f"{REFERENCE_DATA}/{dataset}/{dataset}_{index}.pcd"
    if not os.path.exists(path):
        pytest.skip(f"reference dataset not available at {path}")
    return load_pcd(path)
