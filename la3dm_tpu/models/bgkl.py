"""BGKLOctoMap — BGK with free-space line-segment training data.

Reference delta from BGK (``src/bgkloctomap/bgkloctomap.cpp``): training data
is (segment, label); free rays are deduplicated per block — a beam
contributes one segment to a block's model iff ≥1 of its R-tree proxy
samples lies in the block (``bgkloctomap.cpp:145-172``); occupied hits are
degenerate segments (:153-159); the update gate is k̄ > 0.001 (:231).
"""

from __future__ import annotations

import numpy as np

from la3dm_tpu.geometry import blocks as geo, preprocess
from la3dm_tpu.models import bucketing
from la3dm_tpu.models.bgk import BGKOctoMap
from la3dm_tpu.utils.config import MapConfig


def segment_block_entries(td: preprocess.SegmentTrainingData,
                          block_size: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten per-block training lists: (block coord, segment[6], label).

    Hits become degenerate segments in their own block; each ray is entered
    once per block containing ≥1 of its samples (per-block dedup).
    """
    h_coords, h_idx = geo.point_block_memberships(td.hits, block_size)
    h_entries = np.concatenate([td.hits[h_idx], td.hits[h_idx]], axis=1).astype(np.float32)

    s_coords, s_idx = geo.point_block_memberships(td.samples, block_size)
    s_keys = geo.pack_key(s_coords)
    s_rays = td.sample_ray[s_idx]
    # dedup (block, ray) pairs via lexsort — np.unique(axis=0)'s void-dtype
    # sort costs ~9× more on these ~100k-row tables
    order = np.lexsort((s_rays, s_keys))
    sk, sr = s_keys[order], s_rays[order]
    if len(sk):
        keep = np.empty(len(sk), bool)
        keep[0] = True
        keep[1:] = (sk[1:] != sk[:-1]) | (sr[1:] != sr[:-1])
        sk, sr = sk[keep], sr[keep]
    r_coords = geo.unpack_key(sk)
    r_entries = td.rays[sr].astype(np.float32)

    coords = np.concatenate([h_coords, r_coords], axis=0)
    entries = np.concatenate([h_entries, r_entries], axis=0)
    labels = np.concatenate([
        np.ones(len(h_coords), np.float32), np.zeros(len(r_coords), np.float32)])
    return coords, entries, labels


class BGKLOctoMap(BGKOctoMap):
    SEGMENTS = True
    GATE = 0.001  # bgkloctomap.cpp:231
    # on an H100 the batched device ingestion ran about 30 % below the host
    # path end to end, and tied it scan by scan (PERF.md, Findings)
    AUTO_DEVICE_INGEST = False

    def _scan_tables(self, cloud, origin, ds_resolution, free_resolution,
                     max_range):
        cfg = self.cfg
        ds = cfg.ds_resolution if ds_resolution is None else ds_resolution
        fr = cfg.free_resolution if free_resolution is None else free_resolution
        mr = cfg.max_range if max_range is None else max_range
        from la3dm_tpu.geometry import native

        td = native.bgkl_training_data(cloud, origin, ds, fr, mr)
        if td is not None:
            if len(td.hits) == 0 and len(td.rays) == 0:
                return None
            # fused native bucketing (bit-identical to the numpy pipeline)
            nt = native.bgkl_scan_tables(td.hits, td.rays, td.samples,
                                         td.sample_ray, self.block_size,
                                         self._neighbor_offsets)
            if nt is not None:
                if len(nt["test_coords"]) == 0:
                    return None
                return bucketing.BucketTables(
                    test_coords=nt["test_coords"], entries=nt["entries"],
                    labels=nt["labels"], starts=nt["starts"],
                    counts=nt["counts"],
                    max_total=int(nt["counts"].sum(axis=1).max()))
        return super()._scan_tables(cloud, origin, ds_resolution,
                                    free_resolution, max_range)

    def _scan_entries(self, cloud, origin, ds, fr, mr):
        from la3dm_tpu.geometry import native

        td = native.bgkl_training_data(cloud, origin, ds, fr, mr)
        if td is None:  # no native toolchain — numpy fallback
            td = preprocess.bgkl_training_data(cloud, origin, ds, fr, mr)
        if len(td.hits) == 0 and len(td.rays) == 0:
            return None
        return segment_block_entries(td, self.block_size)

    # The reference declares insert_training_data for BGKL but never
    # implemented it (bgkloctomap.h:89); here segment-level insertion works:
    def insert_training_data(self, segments: np.ndarray, labels: np.ndarray) -> None:
        """Insert raw (segment, label) rows; each segment is indexed by its
        start point's block (degenerate handling as in insert_pointcloud)."""
        coords = geo.point_to_block_coord(segments[:, :3], self.block_size)
        tables = bucketing.bucket_tables(
            coords, segments.astype(np.float32), labels.astype(np.float32),
            self._neighbor_offsets)
        self._apply_tables(tables)
