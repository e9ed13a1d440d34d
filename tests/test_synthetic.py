"""The seeded scan generator (la3dm_tpu/io/synthetic.py)."""

import os

import numpy as np
import pytest

from la3dm_tpu.io import synthetic
from la3dm_tpu.io.pcd import load_pcd
from la3dm_tpu.utils.config import load_dataset_config


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".pcd")}


@pytest.mark.parametrize("kind", synthetic.KINDS)
def test_same_seed_same_bytes(tmp_path, kind):
    a = synthetic.write_dataset(str(tmp_path / "a"), "s", kind, 2, seed=4,
                                n_az=20, n_el=12)
    synthetic.write_dataset(str(tmp_path / "b"), "s", kind, 2, seed=4,
                            n_az=20, n_el=12)
    synthetic.write_dataset(str(tmp_path / "c"), "s", kind, 2, seed=5,
                            n_az=20, n_el=12)
    fa, fb, fc = (_files(str(tmp_path / x)) for x in "abc")
    assert len(fa) == 2 and fa == fb
    assert fa != fc
    assert os.path.exists(a)


@pytest.mark.parametrize("kind,min_share", [("structured", 0.95),
                                            ("unstructured", 0.5)])
def test_beam_count_and_far_returns(kind, min_share):
    """~n_az·n_el beams per scan (a beam that hits nothing returns nothing),
    and some returns beyond the 8 m max range of the demo configs."""
    scans = synthetic.make_scans(kind, 3, seed=0)
    for pts, origin in scans:
        assert pts.dtype == np.float32 and origin.dtype == np.float32
        assert min_share * 3500 <= len(pts) <= 3500
        assert np.isfinite(pts).all()
        r = np.linalg.norm(pts - origin, axis=1)
        assert (r > 8.0).sum() > 50
        assert (r < 8.0).sum() > 500
    steps = [np.linalg.norm(b[1] - a[1]) for a, b in zip(scans, scans[1:])]
    assert min(steps) > 0.1   # the server's motion gate accepts every scan


def test_dataset_roundtrips_through_load_pcd(tmp_path):
    path = synthetic.write_dataset(str(tmp_path), "rt", "structured", 2,
                                   seed=9, n_az=12, n_el=8,
                                   original_size=True)
    ds = load_dataset_config(path)
    assert (ds.name, ds.prefix, ds.scan_num, ds.max_range) == ("rt", "rt", 2, 8.0)
    assert ds.original_size is True and ds.dir == str(tmp_path)
    for i, (pts, origin) in enumerate(
            synthetic.make_scans("structured", 2, seed=9, n_az=12, n_el=8),
            start=1):
        cloud, o = load_pcd(os.path.join(ds.dir, f"{ds.prefix}_{i}.pcd"))
        np.testing.assert_array_equal(cloud, pts)
        np.testing.assert_array_equal(o, origin)


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown scene kind"):
        synthetic.make_scans("forest", 1)
