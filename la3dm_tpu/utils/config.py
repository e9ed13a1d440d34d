"""Typed configuration replacing the reference's ROS parameter server.

The reference composes a method YAML + dataset YAML into a ROS private
namespace (``launch/la3dm_static.launch:36-39``) and each node pulls ~19
typed params via ``nh.param<T>`` (``src/bgkoctomap/bgkoctomap_static_node.cpp:43-62``).
Here the same keys load into frozen dataclasses with identical defaults.
"""

from __future__ import annotations

import dataclasses
import os
import re

_CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Method hyperparameters (reference ``config/methods/*.yaml``)."""

    method: str = "bgk"  # bgk | bgkl | bgklv | gp
    resolution: float = 0.1
    block_depth: int = 4
    sf2: float = 1.0
    ell: float = 1.0
    free_resolution: float = 0.5
    ds_resolution: float = 0.1
    free_thresh: float = 0.3
    occupied_thresh: float = 0.7
    # BGK family (bgkoctomap.yaml:18-23)
    var_thresh: float = 1.0
    prior_A: float = 1.0
    prior_B: float = 1.0
    # LV only (bgklvoctomap.yaml:24)
    min_W: float = 0.1
    # GP only (gpoctomap.yaml:20-25); note min_ivar = 1/max_var etc.
    # (src/gpoctomap/gpoctomap.cpp:39-41)
    noise: float = 0.01
    l: float = 100.0
    min_var: float = 0.001
    max_var: float = 1000.0
    max_known_var: float = 0.02
    # Large-map options
    original_size: bool = False
    max_range: float = -1.0
    min_z: float = 0.0
    max_z: float = 0.0
    # 27-neighbor extended blocks (reference -DPREDICT, CMakeLists.txt:19)
    predict: bool = False
    # Scan ingestion placement (geometry/device_ingest.py): "auto" runs the
    # whole preprocessing pipeline on-device when the backend is an
    # accelerator (not the CPU), the family measured faster there
    # (``AUTO_DEVICE_INGEST``: BGK and GP, not BGK-L) and the config is
    # statically boundable (max_range > 0), falling back to the bit-exact
    # host path otherwise; "on"/"off" force it.
    device_ingest: str = "auto"

    @property
    def cells_per_edge(self) -> int:
        """Voxels per block edge: 2^(block_depth-1) (bgkblock.cpp:105)."""
        return 1 << (self.block_depth - 1)

    @property
    def block_size(self) -> float:
        """World size of one block (bgkoctomap.cpp:41)."""
        return self.cells_per_edge * self.resolution

    @property
    def voxels_per_block(self) -> int:
        return self.cells_per_edge ** 3


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Dataset parameters (reference ``config/datasets/*.yaml``)."""

    name: str = "sim_structured"
    dir: str = ""
    prefix: str = ""
    scan_num: int = 12
    max_range: float = 8.0
    min_z: float = 0.0
    max_z: float = 4.3
    original_size: bool = False
    predict: bool = False


_INT = re.compile(r"[-+]?[0-9]+")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+]?[0-9]+)?")
_BOOL = {v: b for b in (True, False)
         for v in (str(b).lower(), str(b), str(b).upper())}


def _scalar(text: str):
    """One YAML scalar as PyYAML's ``safe_load`` reads the forms used in
    ``configs/``: ints, floats with a decimal point, true/false, null/~,
    quoted or plain strings."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    return text


_LINE = re.compile(r"""([^\s:#][^:]*?):(?:\s+('[^']*'|"[^"]*"|[^'"].*?)?)?"""
                   r"""\s*(?:\s#.*)?""")


def _load_yaml(path: str) -> dict:
    """Read a flat ``key: value`` YAML file (the format of ``configs/``)."""
    out = {}
    with open(path) as f:
        for n, line in enumerate(f, start=1):
            line = line.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            m = _LINE.fullmatch(line)
            if m is None:
                raise ValueError(f"{path}:{n}: expected 'key: value', "
                                 f"got {line!r}")
            out[m.group(1)] = _scalar(m.group(2) or "")
    return out


def _filter_fields(cls, raw: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


def load_method_config(name_or_path: str, **overrides) -> MapConfig:
    """Load a method config by name (``bgk``, ``gpoctomap`` …) or YAML path."""
    path = name_or_path
    if not os.path.exists(path):
        candidates = [
            os.path.join(_CONFIG_ROOT, "methods", f"{name_or_path}.yaml"),
            os.path.join(_CONFIG_ROOT, "methods", f"{name_or_path}octomap.yaml"),
        ]
        for c in candidates:
            if os.path.exists(c):
                path = c
                break
        else:
            raise FileNotFoundError(f"no method config for {name_or_path!r}")
    raw = _load_yaml(path)
    raw.update(overrides)
    raw.setdefault("method", os.path.basename(path).replace("octomap", "").replace(".yaml", "").replace("_large_map", ""))
    return MapConfig(**_filter_fields(MapConfig, raw))


def load_dataset_config(name_or_path: str, **overrides) -> DatasetConfig:
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_CONFIG_ROOT, "datasets", f"{name_or_path}.yaml")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no dataset config for {name_or_path!r}")
    raw = _load_yaml(path)
    raw.update(overrides)
    raw.setdefault("name", os.path.basename(path).replace(".yaml", ""))
    return DatasetConfig(**_filter_fields(DatasetConfig, raw))
