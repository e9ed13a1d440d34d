"""la3dm_tpu command line — the reference's launch-file surface.

    python -m la3dm_tpu.cli static --method bgk --dataset sim_structured \
        --out /tmp/map

mirrors ``roslaunch la3dm la3dm_static.launch method:=X dataset:=Y``
(launch/la3dm_static.launch): method YAML + dataset YAML compose into one
run; the map is exported as PLY (occupied + free), CSV and an NPZ checkpoint
instead of RViz markers.

    python -m la3dm_tpu.cli server --method bgk --watch DIR

is the online-node equivalent (``la3dm_server.launch``): it watches a
directory for new ``*.pcd`` scans and integrates them as they appear.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from la3dm_tpu.pipeline import build_map, export_leaves, run_static
from la3dm_tpu.utils.config import load_dataset_config, load_method_config
from la3dm_tpu.viz import markers


def _add_overrides(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="override any method-config field (repeatable)")


def _parse_overrides(pairs):
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def cmd_static(args) -> int:
    cfg = load_method_config(args.method, **_parse_overrides(args.set))
    ds = load_dataset_config(args.dataset)
    if args.scan_num:
        ds = type(ds)(**{**ds.__dict__, "scan_num": args.scan_num})

    def progress(i, dt):
        print(f"Scan {i} done in {dt:.3f}s", flush=True)

    if args.profile_dir:
        from la3dm_tpu.utils.profiling import device_trace

        with device_trace(args.profile_dir):
            res = run_static(cfg, ds, progress=progress)
        print(f"Device trace written to {args.profile_dir} (TensorBoard)")
    else:
        res = run_static(cfg, ds, progress=progress)
    print(f"Mapping finished in {res.total_seconds:.3f}s "
          f"({res.scans_per_second:.2f} scans/s)")
    # machine-readable run summary (chip_smoke.py and scripts parse it)
    print("Map stats: " + json.dumps({
        "scans": ds.scan_num, "total_s": res.total_seconds,
        "scans_per_s": res.scans_per_second,
        "host_s": res.map.stats["host_s"],
        "host_fallback_chunks": res.map.stats["host_fallback_chunks"],
        "active_blocks": res.map.pool.n_blocks,
        "state_bytes": res.map.pool.nbytes}), flush=True)

    min_z, max_z = ds.min_z, ds.max_z
    # the LV static demo hides occupied voxels above z = 2.0
    # (bgklvoctomap_static_node.cpp:119-120); the other nodes don't
    ex = export_leaves(res.map, original_size=ds.original_size,
                       occupied_z_max=2.0 if cfg.method == "bgklv" else None)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        n_occ = markers.export_ply(args.out + "_occupied.ply", ex["occupied"],
                                   "occupied", cfg.resolution, min_z, max_z)
        n_free = markers.export_ply(args.out + "_free.ply", ex["free"],
                                    "free", cfg.resolution, min_z, max_z)
        markers.export_csv(args.out + "_occupied.csv", ex["occupied"])
        res.map.save(args.out + "_map.npz")
        from la3dm_tpu.io.octomap_bt import write_bt_from_map

        write_bt_from_map(args.out + "_map.bt", res.map)  # octovis-openable
        from la3dm_tpu.viz.html import export_html

        export_html(args.out + "_map.html", ex["all"], cfg.resolution,
                    title=f"{cfg.method} / {ds.name} ({ds.scan_num} scans)")
        print(f"Exported {n_occ} occupied + {n_free} free voxels to {args.out}_* "
              f"(open {args.out}_map.html to inspect)")
    else:
        print(f"{len(ex['occupied']['x'])} occupied, {len(ex['free']['x'])} free voxels")
    return 0


def cmd_server(args) -> int:
    cfg = load_method_config(args.method, **_parse_overrides(args.set))
    from la3dm_tpu.io.pcd import load_pcd_full
    from la3dm_tpu.pipeline import OnlineIntegrator

    m = build_map(cfg)
    online = OnlineIntegrator(m)  # motion gate + pre-downsample (server.cpp)
    seen = set()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    print(f"Watching {args.watch} for scans (Ctrl-C to stop)")
    try:
        while True:
            for path in sorted(glob.glob(os.path.join(args.watch, "*.pcd"))):
                if path in seen:
                    continue
                seen.add(path)
                cloud, origin, quat = load_pcd_full(path)
                t0 = time.perf_counter()
                if not online.offer(cloud, origin, quat):
                    print(f"Skipped {os.path.basename(path)} (motion gate)",
                          flush=True)
                    continue
                print(f"One cloud finished in {time.perf_counter() - t0:.3f}s "
                      f"({os.path.basename(path)}, {len(cloud)} pts)", flush=True)
                if args.out:
                    m.save(args.out + "_map.npz")
            if args.once:
                break
            time.sleep(args.poll)
    except KeyboardInterrupt:
        pass
    if args.out:
        ex = export_leaves(m, original_size=cfg.original_size)
        markers.export_ply(args.out + "_occupied.ply", ex["occupied"], "occupied",
                           cfg.resolution, cfg.min_z, cfg.max_z)
        m.save(args.out + "_map.npz")
        from la3dm_tpu.io.octomap_bt import write_bt_from_map

        write_bt_from_map(args.out + "_map.bt", m)
    return 0


def cmd_bag(args) -> int:
    """Replay a ROS bag through the online pipeline (the reference server's
    role: cloudHandler per message with a motion gate, bgkoctomap_server.cpp:44-89)."""
    from la3dm_tpu.io.rosbag import replay
    from la3dm_tpu.pipeline import OnlineIntegrator

    cfg = load_method_config(args.method, **_parse_overrides(args.set))
    m = build_map(cfg)
    online = OnlineIntegrator(m)  # motion gate + pre-downsample (server.cpp)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    t_all = time.perf_counter()
    for cloud, origin, quat in replay(args.bag, cloud_topic=args.cloud_topic,
                                      pose_topic=args.pose_topic,
                                      with_orientation=True):
        t0 = time.perf_counter()
        if not online.offer(cloud, origin, quat):
            continue
        print(f"One cloud finished in {time.perf_counter() - t0:.3f}s "
              f"({len(cloud)} pts)", flush=True)
    print(f"{online.n_integrated} clouds integrated "
          f"({online.n_skipped} gated) in {time.perf_counter() - t_all:.3f}s; "
          f"{m.pool.n_blocks} blocks")
    if args.out:
        ex = export_leaves(m, original_size=cfg.original_size)
        markers.export_ply(args.out + "_occupied.ply", ex["occupied"], "occupied",
                           cfg.resolution, cfg.min_z, cfg.max_z)
        m.save(args.out + "_map.npz")
        from la3dm_tpu.io.octomap_bt import write_bt_from_map

        write_bt_from_map(args.out + "_map.bt", m)
    return 0


def cmd_eval(args) -> int:
    """Score a map against the bundled OctoMap ground truth.

    The reference ships ``data/<ds>/map.bt`` (OctoMap binary, labeled) and
    ``data/sim_structured/sim_structured_octomap.csv`` (its unlabeled leaf
    dump) as evaluation artifacts no reference code reads (SURVEY.md §6).
    Builds the map with the static pipeline, expands the ground truth to
    base-resolution voxels, queries the posterior at each center, and
    reports occupancy agreement + an AUC threshold sweep (the papers'
    comparison style, README.md:48-101).
    """
    from la3dm_tpu.io.octomap_bt import expand_to_voxels, read_bt

    cfg = load_method_config(args.method, **_parse_overrides(args.set))
    ds = load_dataset_config(args.dataset)
    if args.scan_num:
        ds = type(ds)(**{**ds.__dict__, "scan_num": args.scan_num})
    bt_path = args.ground_truth or os.path.join(ds.dir, "map.bt")
    bt = read_bt(bt_path)
    gt = expand_to_voxels(bt)

    res = run_static(cfg, ds)
    m = res.map
    out = m.search(gt["centers"].astype(np.float32))
    know = out["touched"]
    y = gt["occupied"]
    p = out["prob"]

    # threshold sweep (AUC over the known voxels, trapezoidal).  ROC anchored
    # at (0,0)/(1,1) explicitly: LV's evidence-mass probabilities include
    # exact 0⁻/1 values (f32 rounding of W−A−B), so a [0,1] sweep alone never
    # predicts all-positive and would truncate the area.
    ths = np.linspace(0.0, 1.0, 201)
    tpr, fpr = [1.0], [1.0]
    yk, pk = y[know], p[know]
    P, N = max(int(yk.sum()), 1), max(int((~yk).sum()), 1)
    for t in ths:
        pred = pk > t
        tpr.append(float((pred & yk).sum()) / P)
        fpr.append(float((pred & ~yk).sum()) / N)
    tpr.append(0.0)
    fpr.append(0.0)
    auc = float(np.trapezoid(tpr[::-1], fpr[::-1]))

    pred_occ = pk > cfg.occupied_thresh
    acc = float((pred_occ == yk).mean())
    prec = float((pred_occ & yk).sum() / max(int(pred_occ.sum()), 1))
    rec = float((pred_occ & yk).sum() / P)
    report = {
        "method": cfg.method,
        "dataset": ds.name,
        "gt_voxels": int(len(y)),
        "known": int(know.sum()),
        "coverage": round(float(know.mean()), 4),
        "accuracy_at_thresh": round(acc, 4),
        "precision_occ": round(prec, 4),
        "recall_occ": round(rec, 4),
        "auc": round(auc, 4),
        "scans_per_s": round(res.scans_per_second, 2),
    }
    print(json.dumps(report))
    return 0


def cmd_query(args) -> int:
    """Load a checkpoint and query points (the search() API as a CLI)."""
    cfg = load_method_config(args.method, **_parse_overrides(args.set))
    m = build_map(cfg)
    m.load(args.checkpoint)
    pts = np.array([[float(x) for x in p.split(",")] for p in args.points])
    out = m.search(pts)
    for i, p in enumerate(pts):
        print(f"{p}: prob={out['prob'][i]:.4f} var={out['var'][i]:.4f} "
              f"state={int(out['state'][i])}")
    return 0


def cmd_raycast(args) -> int:
    """Cast rays through a saved map on device (the reference's commented-out
    raytracing demo, bgkloctomap_static_node.cpp:117-129)."""
    from la3dm_tpu.models.raycast import raycast_device

    cfg = load_method_config(args.method, **_parse_overrides(args.set))
    m = build_map(cfg)
    m.load(args.checkpoint)
    rays = np.array([[float(x) for x in r.split(",")] for r in args.rays])
    origins, targets = rays[:, :3], rays[:, 3:6]
    out = raycast_device(m, origins, targets - origins, max_range=args.max_range)
    for i in range(len(rays)):
        p = out["point"][i]
        print(f"ray {i}: hit={bool(out['hit'][i])} "
              f"dist={float(out['distance'][i]):.3f} "
              f"point=({p[0]:.2f},{p[1]:.2f},{p[2]:.2f}) "
              f"steps={int(out['steps'][i])}")
    return 0


def cmd_frontier(args) -> int:
    """Frontier extraction from a saved map (the reference's commented-out
    frontier demo, bgkloctomap_static_node.cpp:102-115)."""
    from la3dm_tpu.pipeline import frontier_leaves
    from la3dm_tpu.viz.markers import export_csv

    cfg = load_method_config(args.method, **_parse_overrides(args.set))
    m = build_map(cfg)
    m.load(args.checkpoint)
    f = frontier_leaves(m, var_min=args.var_min, prob_max=args.prob_max,
                        z_min=args.z_min, z_max=args.z_max)
    print(json.dumps({"frontier_voxels": int(len(f["x"]))}))
    if args.out:
        export_csv(args.out, f)
        print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    # honor JAX_PLATFORMS explicitly, also when jax was imported (and its
    # platform chosen) before the variable was set
    plat = os.environ.get("JAX_PLATFORMS")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)
    parser = argparse.ArgumentParser(prog="la3dm_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("static", help="offline scan-sequence mapping demo")
    p.add_argument("--method", default="bgklv", help="bgk|bgkl|bgklv|gp or YAML path")
    p.add_argument("--dataset", default="sim_structured")
    p.add_argument("--scan-num", type=int, default=0)
    p.add_argument("--out", default="")
    p.add_argument("--profile-dir", default="",
                   help="write a jax.profiler device trace here (TensorBoard)")
    _add_overrides(p)
    p.set_defaults(fn=cmd_static)

    p = sub.add_parser("server", help="online mapping: watch a directory for scans")
    p.add_argument("--method", default="bgklv")
    p.add_argument("--watch", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--poll", type=float, default=0.5)
    p.add_argument("--once", action="store_true")
    _add_overrides(p)
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser("bag", help="replay a ROS bag through the online pipeline")
    p.add_argument("--method", default="bgklv")
    p.add_argument("--bag", required=True)
    p.add_argument("--cloud-topic", default="/selected_pc2_map")
    p.add_argument("--pose-topic", default="/robot_pose")
    p.add_argument("--out", default="")
    _add_overrides(p)
    p.set_defaults(fn=cmd_bag)

    p = sub.add_parser("eval", help="score a map against the bundled OctoMap "
                                    "ground truth (map.bt)")
    p.add_argument("--method", default="bgklv")
    p.add_argument("--dataset", default="sim_structured")
    p.add_argument("--scan-num", type=int, default=0)
    p.add_argument("--ground-truth", default="",
                   help="path to a .bt file (default: <dataset dir>/map.bt)")
    _add_overrides(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("query", help="query a saved map checkpoint")
    p.add_argument("--method", default="bgklv")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("points", nargs="+", help="x,y,z")
    _add_overrides(p)
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("raycast", help="device-side ray casting through a "
                                       "saved map")
    p.add_argument("--method", default="bgklv")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--max-range", type=float, default=10.0)
    p.add_argument("rays", nargs="+", help="ox,oy,oz,tx,ty,tz (origin→target)")
    _add_overrides(p)
    p.set_defaults(fn=cmd_raycast)

    p = sub.add_parser("frontier", help="extract frontier voxels (high var, "
                                        "low prob) from a saved map")
    p.add_argument("--method", default="bgklv")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--var-min", type=float, default=0.02)
    p.add_argument("--prob-max", type=float, default=0.3)
    p.add_argument("--z-min", type=float, default=0.3)
    p.add_argument("--z-max", type=float, default=1.0)
    p.add_argument("--out", default="", help="optional CSV export path")
    _add_overrides(p)
    p.set_defaults(fn=cmd_frontier)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
