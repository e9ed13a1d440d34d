"""la3dm_tpu — accelerator-resident Bayesian continuous-occupancy mapping.

A from-scratch JAX/XLA re-design of the LA3DM model family
(reference: RobustFieldAutonomyLab/la3dm, C++/ROS):

* ``BGKOctoMap``    — Bayesian generalized kernel inference, Beta posteriors
* ``BGKLOctoMap``   — BGK with free-space line-segment training data
* ``BGKLVOctoMap``  — BGK-L with evidence-mass occupancy + variance-aware
                      UNCERTAIN state and per-voxel region-of-influence inference
* ``GPOctoMap``     — per-block Gaussian-process regression (Matérn-3/2,
                      batched Cholesky) + Bayesian Committee Machine fusion

Instead of a hash map of pointer octrees (reference
``include/bgkoctomap/bgkoctomap.h:377``), the map is a **dense block pool**:
preallocated ``[capacity, n³]`` arrays of posterior state sharded over a
``jax.sharding.Mesh``.  Each scan update is one fused batched kernel
evaluation over (training-point × test-voxel) rows on the device.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def compile_cache_dir(environ=_os.environ) -> str | None:
    """Directory of the persistent XLA compilation cache, or None.

    ``JAX_COMPILATION_CACHE_DIR`` when set, else the fixed ``<repo>/.jax_cache``
    (a fixed path keeps the cache key stable across processes).  None when
    ``JAX_PLATFORMS`` names the CPU: CPU executables are pinned to the
    compiling host's machine features, which the cache key leaves out.
    """
    if "cpu" in environ.get("JAX_PLATFORMS", "").split(","):
        return None
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


if (_cache_dir := compile_cache_dir()) is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from la3dm_tpu.utils.config import MapConfig, DatasetConfig, load_method_config, load_dataset_config
from la3dm_tpu.models.bgk import BGKOctoMap
from la3dm_tpu.models.bgkl import BGKLOctoMap
from la3dm_tpu.models.bgklv import BGKLVOctoMap
from la3dm_tpu.models.gp import GPOctoMap
from la3dm_tpu.models.base import State

__all__ = [
    "BGKOctoMap",
    "BGKLOctoMap",
    "BGKLVOctoMap",
    "GPOctoMap",
    "State",
    "MapConfig",
    "DatasetConfig",
    "load_method_config",
    "load_dataset_config",
]
