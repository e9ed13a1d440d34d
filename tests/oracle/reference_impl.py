"""Literal numpy re-implementation of the reference algorithms (the oracle).

This module mirrors the C++ reference *semantics-for-semantics* — per-block
octrees, extended-block neighbor models, per-model update gates, sequential
BCM chops, bottom-up pruning — using brute-force box queries in place of the
R-tree.  It is deliberately slow and scalar-ish; it exists only as ground
truth for golden tests of the fast path.

Citations are to the reference sources under /root/reference (structure
documented in SURVEY.md §2-3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

f32 = np.float32

# ----------------------------------------------------------------- kernels


def cov_sparse(x: np.ndarray, z: np.ndarray, sf2: float, ell: float) -> np.ndarray:
    """bgkinference.h:113-126 (float32, clamp negatives)."""
    x = x.astype(f32) / f32(ell)
    z = z.astype(f32) / f32(ell)
    d = np.linalg.norm(x[:, None, :] - z[None, :, :], axis=-1).astype(f32)
    tp = f32(2.0 * 3.1415926)
    k = ((2.0 + np.cos(tp * d)) * (1.0 - d) / 3.0 + np.sin(tp * d) / tp).astype(f32) * f32(sf2)
    return np.maximum(k, 0.0).astype(f32)


def cov_matern32(x: np.ndarray, z: np.ndarray, sf2: float, ell: float) -> np.ndarray:
    """gpregressor.h:114-117."""
    s = f32(1.73205) / f32(ell)
    d = np.linalg.norm((x.astype(f32) * s)[:, None, :] - (z.astype(f32) * s)[None, :, :], axis=-1).astype(f32)
    return ((1.0 + d) * np.exp(-d)).astype(f32) * f32(sf2)


def point_to_segment(p: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """bgklinference.h:106-141 (ε=1e-4; c1/c2 in double)."""
    out = np.zeros((len(p), len(seg)), f32)
    for i in range(len(p)):
        for j in range(len(seg)):
            p0, p1 = seg[j, :3].astype(f32), seg[j, 3:].astype(f32)
            u = p1 - p0
            ll = np.float32(np.linalg.norm(u))
            if ll < 1e-4:
                out[i, j] = np.linalg.norm(p[i] - p0)
                continue
            c1 = float(np.dot(p[i] - p0, u))
            c2 = float(np.dot(u, u))
            if c1 <= 0:
                out[i, j] = np.linalg.norm(p[i] - p0)
            elif c2 <= c1:
                out[i, j] = np.linalg.norm(p[i] - p1)
            else:
                near = p0 + u * f32(c1 / c2)
                out[i, j] = np.linalg.norm(p[i] - near)
    return out


def cov_sparse_line(p: np.ndarray, seg: np.ndarray, sf2: float, ell: float, lv: bool) -> np.ndarray:
    """bgklinference.h:183-197 (clamp output) / bgklvinference.h:143-157 (clamp r)."""
    r = (point_to_segment(p, seg) / f32(ell)).astype(f32)
    tp = f32(2.0 * 3.1415926)
    if lv:
        r = np.minimum(r, 1.0).astype(f32)
    k = ((2.0 + np.cos(tp * r)) * (1.0 - r) / 3.0 + np.sin(tp * r) / tp).astype(f32) * f32(sf2)
    if not lv:
        k = np.maximum(k, 0.0)
    return k.astype(f32)


# --------------------------------------------------------- preprocessing


def voxel_downsample(points, leaf):
    if leaf < 0 or len(points) == 0:
        return np.asarray(points, f32)
    pts = np.asarray(points, f32)
    ijk = np.floor(pts * f32(1.0 / leaf)).astype(np.int64)
    order = np.lexsort((ijk[:, 0], ijk[:, 1], ijk[:, 2]))
    ijk, pts = ijk[order], pts[order]
    change = np.any(ijk[1:] != ijk[:-1], axis=1)
    start = np.concatenate([[0], np.nonzero(change)[0] + 1])
    counts = np.diff(np.concatenate([start, [len(ijk)]]))
    sums = np.add.reduceat(pts.astype(np.float64), start, axis=0)
    return (sums / counts[:, None]).astype(f32)


def beam_sample_forward(hit, origin, fr):
    """bgkoctomap.cpp:433-458."""
    l = f32(np.sqrt(((hit - origin) ** 2).sum()))
    n = (hit - origin) / l
    out = []
    d = f32(fr)
    while d < l:
        out.append(origin + n * d)
        d = f32(d + fr)
    if l > fr:
        out.append(origin + n * f32(l - fr))
    return np.array(out, f32).reshape(-1, 3)


def beam_sample_backward(hit, origin, fr):
    """bgkloctomap.cpp:360-383."""
    l = f32(np.sqrt(((hit - origin) ** 2).sum()))
    if l <= 0:
        return np.zeros((0, 3), f32)
    n = (hit - origin) / l
    out = []
    d = f32(l - fr)
    while d > 0.0:
        out.append(origin + n * d)
        d = f32(d - fr)
    return np.array(out, f32).reshape(-1, 3)


# --------------------------------------------------------------- octree


def child_offsets(half):
    """Child-center offsets in the reference's BFS child order i=0..7
    (bgkblock.cpp:23-27: x←i&4, y←i&2, z←i&1; −half/2 when bit unset)."""
    offs = np.zeros((8, 3), f32)
    for i in range(8):
        offs[i] = [
            half * (0.5 if i & 4 else -0.5),
            half * (0.5 if i & 2 else -0.5),
            half * (0.5 if i & 1 else -0.5),
        ]
    return offs


@dataclasses.dataclass
class Leaf:
    depth: int
    index: int
    value: np.ndarray  # family-specific, shape [2]
    classified: bool
    state: int  # 0 FREE 1 OCCUPIED 2 UNKNOWN 3 UNCERTAIN


class OracleBlock:
    """Fixed-depth test-data octree (bgkoctree.cpp) as an explicit leaf dict."""

    def __init__(self, center, resolution, depth, default_value):
        self.center = np.asarray(center, f32)
        self.res = resolution
        self.depth = depth
        self.leaves: dict[tuple[int, int], Leaf] = {
            (depth - 1, i): Leaf(depth - 1, i, default_value.copy(), False, 2)
            for i in range(8 ** (depth - 1))
        }

    def node_center(self, depth, index):
        c = self.center.copy().astype(f32)
        path = []
        idx = index
        for d in range(depth, 0, -1):
            path.append(idx % 8)
            idx //= 8
        for d, child in enumerate(reversed(path)):
            half = f32(self.res * (2 ** (self.depth - d - 1)) * 0.5)
            c = c + child_offsets(half)[child]
        return c

    def node_size(self, depth):
        return self.res * 2 ** (self.depth - 1 - depth)

    def leaf_items(self):
        return sorted(self.leaves.items())

    def prune(self, classify):
        """bgkoctree.cpp:101-148 bottom-up; classify(value)→state for nodes
        (stored states are kept in Leaf.state already)."""
        for depth in range(self.depth - 1, 0, -1):
            parents = {}
            for (d, i), leaf in list(self.leaves.items()):
                if d == depth:
                    parents.setdefault(i // 8, []).append((i, leaf))
            for p, kids in parents.items():
                if len(kids) != 8:
                    continue
                kids.sort()
                st0 = kids[0][1].state
                if st0 == 2:  # UNKNOWN not collapsible
                    continue
                if any(k.state != st0 for _, k in kids):
                    continue
                child0 = kids[0][1]
                for i, _ in kids:
                    del self.leaves[(depth, i)]
                self.leaves[(depth - 1, p)] = Leaf(
                    depth - 1, p, child0.value.copy(), child0.classified, child0.state)


# ----------------------------------------------------------- base oracle map


class OracleMapBase:
    def __init__(self, cfg):
        self.cfg = cfg
        self.res = cfg.resolution
        self.depth = cfg.block_depth
        self.bs = f32(2 ** (cfg.block_depth - 1) * cfg.resolution)
        self.blocks: dict[tuple, OracleBlock] = {}

    def block_coord(self, p):
        return tuple(int(np.floor(float(c) / float(self.bs) + 0.5)) for c in p)

    def point_blocks(self, pts):
        """All blocks whose *closed* box contains ≥1 point.

        The candidate sweep (get_blocks_in_bbox) is a bbox superset; the
        test/model condition is the closed R-tree box query, under which a
        boundary point belongs to both adjacent blocks.
        """
        out = set()
        half = np.float32(self.bs) / np.float32(2.0)
        for p in np.asarray(pts, f32):
            base = self.block_coord(p)
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        c = (base[0] + dx, base[1] + dy, base[2] + dz)
                        ctr = self.block_center_of(c)
                        if np.all(p >= ctr - half) and np.all(p <= ctr + half):
                            out.add(c)
        return out

    def block_center_of(self, coord):
        return (np.array(coord, np.float64) * f32(self.bs)).astype(f32)

    def extended(self, coord):
        """ExtendedBlock order: self, +x, −x, +y, −y, +z, −z (bgkblock.cpp:114-130).

        With ``predict: true`` (-DPREDICT, bgkblock.h:22-26) the 27-cell
        ExtendedBlock27 is used instead — self first, then the remaining 26
        offsets in (dx, dy, dz) loop order, matching
        ``geometry.blocks.full_neighbor_offsets``.
        """
        if getattr(self.cfg, "predict", False):
            offs = [(0, 0, 0)] + [
                (dx, dy, dz)
                for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
                if (dx, dy, dz) != (0, 0, 0)]
        else:
            offs = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                    (0, 0, 1), (0, 0, -1)]
        return [tuple(np.add(coord, o)) for o in offs]

    def get_block(self, coord):
        if coord not in self.blocks:
            self.blocks[coord] = OracleBlock(
                self.block_center_of(coord), self.res, self.depth, self.default_value())
        return self.blocks[coord]

    def leaves(self):
        """(center[3], size, value, classified, state) over all blocks."""
        out = []
        for coord, blk in sorted(self.blocks.items()):
            for (d, i), leaf in blk.leaf_items():
                out.append((blk.node_center(d, i), blk.node_size(d), leaf.value,
                            leaf.classified, leaf.state))
        return out

    def base_voxel_dict(self):
        """{(block coord, voxel raster idx): value} expanding collapsed leaves."""
        n = 2 ** (self.depth - 1)
        out = {}
        for coord, blk in sorted(self.blocks.items()):
            for (d, i), leaf in blk.leaf_items():
                c = blk.node_center(d, i)
                m = 2 ** (self.depth - 1 - d)
                rel = np.round((c - blk.center) / self.res + n / 2.0 - m / 2.0).astype(int)
                for dz in range(m):
                    for dy in range(m):
                        for dx in range(m):
                            v = (rel[0] + dx) + (rel[1] + dy) * n + (rel[2] + dz) * n * n
                            out[(coord, v)] = leaf
        return out
