"""Seeded synthetic range scans: procedural scenes ray-cast from a trajectory.

The reference demos read simulated scans shipped with the upstream project
(``data/sim_structured``, ``data/sim_unstructured``: ~3,500 returns per scan,
8 m ``max_range``).  This module makes scans of the same shape from a seed,
with numpy alone, so every run, test and benchmark has data to map:

* ``structured``: a 20 m × 20 m room (floor, four 5 m walls, no ceiling) with
  axis-aligned boxes;
* ``unstructured``: undulating ground (a sum of sinusoids) with vertical
  cylinders of random radius and height, and no walls.

A forward-looking sensor on a seeded closed-loop trajectory casts a
``n_az × n_el`` beam grid (default 70 × 50 = 3,500 beams over a 60° × 40°
field of view, −25°…+15° in elevation, like a depth camera).  The field of
view is chosen to keep a scan's test blocks under device ingestion's static
caps (``DeviceIngestMixin._DIM_CAPS``, 2,048): a full 360° sweep of the same
scene gives about 5,000 and falls back to the host path.  Each beam
returns its first hit; beams that hit nothing within 40 m return nothing.  The
room is wider than ``2 · max_range``, so some returns lie beyond the 8 m limit
and exercise the max-range path.  :func:`write_dataset` writes the scans as
PCD files with the sensor origin in ``VIEWPOINT`` (``io/pcd.save_pcd``) plus a
dataset YAML, so ``load_pcd``, ``DatasetConfig`` and ``run_static`` read them
unchanged.  The same arguments give the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

from la3dm_tpu.io.pcd import save_pcd

KINDS = ("structured", "unstructured")
#: half-width of the scene [m]
HALF = 10.0
#: wall height of the structured room [m]
WALL_H = 5.0
#: beams that hit nothing closer than this return nothing
FAR = 40.0
#: sensor height above the floor [m]
SENSOR_Z = 1.0
#: horizontal field of view [rad]
FOV_AZ = np.pi / 3


def _scene(kind: str, rng: np.random.Generator) -> dict:
    if kind == "structured":
        n = 10
        lo = rng.uniform(-HALF + 0.5, HALF - 2.5, (n, 2))
        size = rng.uniform(0.5, 2.0, (n, 2))
        h = rng.uniform(0.5, 2.5, n)
        boxes_lo = np.concatenate([lo, np.zeros((n, 1))], axis=1)
        boxes_hi = np.concatenate([lo + size, h[:, None]], axis=1)
        # keep the trajectory's corridor (radius 3–5 m ring) free of boxes
        ctr = 0.5 * (boxes_lo[:, :2] + boxes_hi[:, :2])
        r = np.linalg.norm(ctr, axis=1)
        keep = (r < 1.5) | (r > 6.5)
        return {"boxes_lo": boxes_lo[keep], "boxes_hi": boxes_hi[keep]}
    if kind == "unstructured":
        n = 16
        ang = rng.uniform(0.0, 2.0 * np.pi, n)
        rad = np.where(rng.uniform(size=n) < 0.3, rng.uniform(0.0, 2.0, n),
                       rng.uniform(6.0, HALF, n))
        return {"cyl_xy": np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1),
                "cyl_r": rng.uniform(0.15, 0.5, n),
                "cyl_h": rng.uniform(2.0, 4.0, n),
                "waves": rng.uniform(0.5, 2.0, (3, 2)),   # spatial frequencies
                "phase": rng.uniform(0.0, 2.0 * np.pi, 3),
                "amp": rng.uniform(0.05, 0.15, 3)}
    raise ValueError(f"unknown scene kind {kind!r}; expected one of {KINDS}")


def _ground(scene: dict, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    z = np.zeros_like(x)
    for (fx, fy), ph, a in zip(scene["waves"], scene["phase"], scene["amp"]):
        z = z + a * np.sin(fx * x + fy * y + ph)
    return z


def _trajectory(n_scans: int, rng: np.random.Generator):
    """Sensor origins [n_scans, 3] on a jittered loop (radius ~4 m, one turn
    per 60 scans) and headings [n_scans] along it: steps of ~0.4 m, so the
    server's 0.1 m motion gate accepts every scan and consecutive scans
    overlap."""
    t = rng.uniform(0.0, 2.0 * np.pi) + 2.0 * np.pi * np.arange(n_scans) / 60
    r = 4.0 + rng.uniform(-0.3, 0.3, n_scans)
    xy = np.stack([r * np.cos(t), r * np.sin(t)], 1)
    z = SENSOR_Z + rng.uniform(-0.05, 0.05, n_scans)
    yaw = t + np.pi / 2 + rng.uniform(-0.3, 0.3, n_scans)
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32), yaw


def _directions(n_az: int, n_el: int, yaw: float) -> np.ndarray:
    az = yaw + FOV_AZ * (np.arange(n_az) / (n_az - 1) - 0.5)
    el = np.deg2rad(np.linspace(-25.0, 15.0, n_el))
    az, el = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1)
    return d.reshape(-1, 3)


def _ray_boxes(o, d, lo, hi):
    """[N] nearest entry distance of rays o + t·d into boxes (slab test)."""
    if len(lo) == 0:
        return np.full(len(d), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d                                      # [N,3]
        t0 = (lo[None] - o[None, None]) * inv[:, None]     # [N,nb,3]
        t1 = (hi[None] - o[None, None]) * inv[:, None]
    tmin = np.nanmax(np.minimum(t0, t1), axis=-1)
    tmax = np.nanmin(np.maximum(t0, t1), axis=-1)
    hit = (tmax >= tmin) & (tmin > 0)
    return np.where(hit, tmin, np.inf).min(axis=1)


def _ray_cylinders(o, d, scene, base_z):
    """[N] nearest hit of rays with vertical cylinders standing on the ground."""
    dx, dy = d[:, 0:1], d[:, 1:2]
    px = o[0] - scene["cyl_xy"][None, :, 0]
    py = o[1] - scene["cyl_xy"][None, :, 1]
    a = dx * dx + dy * dy
    b = 2.0 * (px * dx + py * dy)
    c = px * px + py * py - scene["cyl_r"][None] ** 2
    disc = b * b - 4.0 * a * c
    with np.errstate(invalid="ignore", divide="ignore"):
        t = (-b - np.sqrt(disc)) / (2.0 * a)
    z = o[2] + t * d[:, 2:3]
    ok = (disc >= 0) & (t > 0) & (z >= base_z[None]) \
        & (z <= base_z[None] + scene["cyl_h"][None])
    return np.where(ok, t, np.inf).min(axis=1)


def _ray_ground(o, d, scene):
    """[N] first crossing of rays below the heightfield (march + bisection)."""
    step, n_steps = 0.1, int(FAR / 0.1)
    t_hit = np.full(len(d), np.inf)
    down = d[:, 2] < 0.2       # rays rising faster never meet |ground| ≤ 0.45
    idx = np.flatnonzero(down)
    prev = np.zeros(len(idx))
    for k in range(1, n_steps + 1):
        if len(idx) == 0:
            break
        t = np.full(len(idx), k * step)
        p = o[None] + t[:, None] * d[idx]
        below = p[:, 2] < _ground(scene, p[:, 0], p[:, 1])
        if below.any():
            lo, hi = prev[below], t[below]
            dd = d[idx[below]]
            for _ in range(20):
                mid = 0.5 * (lo + hi)
                q = o[None] + mid[:, None] * dd
                under = q[:, 2] < _ground(scene, q[:, 0], q[:, 1])
                hi = np.where(under, mid, hi)
                lo = np.where(under, lo, mid)
            t_hit[idx[below]] = hi
        idx, prev = idx[~below], t[~below]
    return t_hit


def _cast(kind: str, scene: dict, o: np.ndarray, d: np.ndarray) -> np.ndarray:
    o = o.astype(np.float64)
    t = np.full(len(d), np.inf)
    if kind == "structured":
        with np.errstate(divide="ignore", invalid="ignore"):
            t_floor = np.where(d[:, 2] < 0, -o[2] / d[:, 2], np.inf)
            for ax in (0, 1):
                for wall in (-HALF, HALF):
                    tw = (wall - o[ax]) / d[:, ax]
                    z = o[2] + tw * d[:, 2]
                    t = np.where((tw > 0) & (z >= 0) & (z <= WALL_H),
                                 np.minimum(t, tw), t)
        t = np.minimum(t, t_floor)
        t = np.minimum(t, _ray_boxes(o, d, scene["boxes_lo"], scene["boxes_hi"]))
    else:
        t = np.minimum(t, _ray_ground(o, d, scene))
        base_z = _ground(scene, scene["cyl_xy"][:, 0], scene["cyl_xy"][:, 1])
        t = np.minimum(t, _ray_cylinders(o, d, scene, base_z))
    return np.where(t < FAR, t, np.inf)


def make_scans(kind: str, n_scans: int, seed: int = 0, n_az: int = 70,
               n_el: int = 50, noise: float = 0.01):
    """``n_scans`` scans of a ``kind`` scene as [(points [N,3] f32, origin [3]
    f32)], N ≤ n_az·n_el (beams that hit nothing return nothing).

    ``noise`` is the standard deviation of the range noise [m]."""
    rng = np.random.default_rng(seed)
    scene = _scene(kind, rng)
    origins, yaws = _trajectory(n_scans, rng)
    out = []
    for o, yaw in zip(origins, yaws):
        d = _directions(n_az, n_el, yaw)
        t = _cast(kind, scene, o, d)
        ok = np.isfinite(t)
        t = t[ok] + noise * rng.standard_normal(int(ok.sum()))
        pts = o.astype(np.float64)[None] + t[:, None] * d[ok]
        out.append((pts.astype(np.float32), o))
    return out


def write_dataset(out_dir: str, name: str, kind: str, n_scans: int,
                  seed: int = 0, max_range: float = 8.0,
                  original_size: bool = False, **scan_kw) -> str:
    """Write ``out_dir/name_{1..n}.pcd`` plus ``out_dir/name.yaml`` (the
    dataset config, as in ``configs/datasets``); returns the YAML path."""
    os.makedirs(out_dir, exist_ok=True)
    for i, (pts, origin) in enumerate(
            make_scans(kind, n_scans, seed=seed, **scan_kw), start=1):
        save_pcd(os.path.join(out_dir, f"{name}_{i}.pcd"), pts, origin)
    path = os.path.join(out_dir, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(f"# synthetic {kind} scans (la3dm_tpu.io.synthetic, seed {seed})\n"
                f"name: {name}\ndir: {os.path.abspath(out_dir)}\n"
                f"prefix: {name}\nscan_num: {n_scans}\nmax_range: {max_range:g}\n"
                f"min_z: 0\nmax_z: 4.3\n"
                f"original_size: {'true' if original_size else 'false'}\n"
                f"predict: false\n")
    return path
