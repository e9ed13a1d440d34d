#!/usr/bin/env python
"""Smoke test of the mapping system on one NVIDIA GPU, end to end.

    python chip_smoke.py          # one card: phases 1-6 below
    python chip_smoke.py --four   # four cards: sharded maps vs one card

One process drives the card; it calls the CLI (``la3dm_tpu.cli.main``) in
process, as a user would from the shell:

1. generate seeded scans (``la3dm_tpu.io.synthetic``): structured 12 and 60,
   unstructured 12, ~3,500 beams each, 8 m max range;
2. ``cli static`` for bgk, bgkl, bgklv, gp on the 12-scan sets (gp on the
   unstructured one), cold then warm, with device ingestion forced on, plus
   the host-ingest path and the batched ``run_static`` path for the
   device-ingest decision;
3. ``cli static`` for the depth-6 LV large map on the 60-scan set;
4. ``cli server --once`` then ``query``, ``raycast`` and ``frontier``;
5. parity on the card: against the numpy oracle, against the same CLI run
   on the CPU backend, and device against host ingestion;
6. a short profiler trace of one warm BGK and one warm LV run, with the top
   device ops by time.

Per-phase lines, the card's name and power limit come first; the last line
is ``{"ok": true, "device": {...}}``.  The script exits non-zero without
that line when JAX finds no GPU, when a phase raises, or when a parity
check misses its tolerance.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FAMILIES = ("bgk", "bgkl", "bgklv", "gp")
INGEST_FAMILIES = ("bgk", "bgkl", "gp")   # LV has no device ingestion


class SmokeFailure(RuntimeError):
    """A check of the smoke test missed."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: ok ({time.perf_counter() - t0:.3f} s)")


def cli_run(*argv: str) -> str:
    """``la3dm_tpu.cli.main(argv)`` in this process; returns its stdout."""
    from la3dm_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    check(rc == 0, f"cli {' '.join(argv)} returned {rc}")
    return buf.getvalue()


def map_stats(out: str) -> dict:
    m = re.search(r"^Map stats: (\{.*\})$", out, re.M)
    check(m is not None, "cli static printed no 'Map stats' line")
    return json.loads(m.group(1))


def card_line() -> str:
    """The card's name and power limit, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def gen_scans(out: str, sizes: dict) -> dict:
    from la3dm_tpu.io import synthetic

    sets = {}
    for name, (kind, n, seed, original_size) in {
            "s12": ("structured", sizes["short"], 1, False),
            "s60": ("structured", sizes["long"], 2, True),
            "u12": ("unstructured", sizes["short"], 3, False)}.items():
        t0 = time.perf_counter()
        path = synthetic.write_dataset(
            os.path.join(out, "data", name), name, kind, n, seed=seed,
            original_size=original_size, n_az=sizes["n_az"],
            n_el=sizes["n_el"])
        sets[name] = path
        log(f"scans {name}: {kind} x{n} -> {path} "
            f"({time.perf_counter() - t0:.3f} s)")
    return sets


def static_runs(out: str, sets: dict) -> dict:
    """Phase 2: each family through ``cli static`` (scan by scan): run A
    (cold, compiles), then warm runs B1-B3, with device ingestion forced on
    whatever ``auto`` picks; for the device-ingest families also the
    host-ingest path (C cold, D1-D3 warm), and both paths through the
    batched ``run_static`` the bench uses, for the ingest decision."""
    import dataclasses
    import statistics

    from la3dm_tpu.geometry import native
    from la3dm_tpu.pipeline import build_map, run_static
    from la3dm_tpu.utils.config import load_dataset_config, load_method_config

    avail = native.available()
    log(f"native host library available: {avail}")
    check(avail, "native host preprocessing failed to build")
    res = {}
    for fam in FAMILIES:
        ds = sets["u12" if fam == "gp" else "s12"]
        runs = {}
        on, off = ("--set", "device_ingest=on"), ("--set", "device_ingest=off")
        if fam not in INGEST_FAMILIES:
            on = ()
        plan = [("A", on), ("B1", on), ("B2", on), ("B3", on)]
        if fam in INGEST_FAMILIES:
            plan += [("C", off), ("D1", off), ("D2", off), ("D3", off)]
        for tag, extra in plan:
            prefix = os.path.join(out, "static", f"{fam}_{tag}")
            st = map_stats(cli_run("static", "--method", fam, "--dataset", ds,
                                   "--out", prefix, *extra))
            st["npz"] = prefix + "_map.npz"
            runs[tag] = st
            host = " (host ingest)" if extra == off else ""
            log(f"static {fam} run {tag}{host}: "
                f"{st['scans_per_s']} scans/s, total {st['total_s']} s, "
                f"host {st['host_s']} s, host-fallback chunks "
                f"{st['host_fallback_chunks']}, blocks {st['active_blocks']}")
        for tag in ("A", "B1", "B2", "B3"):
            check(runs[tag]["host_fallback_chunks"] == 0,
                  f"{fam} run {tag}: {runs[tag]['host_fallback_chunks']} "
                  "chunks fell back to the host path")

        def med(prefix):
            return statistics.median(runs[f"{prefix}{i}"]["scans_per_s"]
                                     for i in (1, 2, 3))

        runs["B"], runs["D"] = runs["B1"], runs.get("D1")
        log(f"static {fam}: warm-up (compile) {runs['A']['total_s']} s, "
            f"warm median {med('B')} scans/s")
        if fam in INGEST_FAMILIES:
            cfg = load_method_config(fam)
            dcfg = load_dataset_config(ds)
            rates = {}
            for mode in ("on", "off"):
                mcfg = dataclasses.replace(cfg, device_ingest=mode)
                t0 = time.perf_counter()
                run_static(mcfg, dcfg)                       # cold: compiles
                cold = time.perf_counter() - t0
                warm = [run_static(mcfg, dcfg) for _ in range(3)]
                rates[mode] = statistics.median(r.scans_per_second
                                                for r in warm)
                r = warm[0]
                check(r.map.stats["host_fallback_chunks"] == 0 or mode == "off",
                      f"{fam} batched: chunks fell back to the host path")
                path = os.path.join(out, "static", f"{fam}_batched_{mode}.npz")
                r.map.save(path)
                runs[f"batched_{mode}"] = {"npz": path}
                log(f"batched {fam} ingest {mode}: cold {cold:.3f} s, warm "
                    f"{[w.scans_per_second for w in warm]} scans/s, host "
                    f"{r.map.stats['host_s']} s")
            log(f"ingest decision {fam}: cli scan-by-scan device {med('B')} "
                f"vs host {med('D')} scans/s; batched device {rates['on']} "
                f"vs host {rates['off']} scans/s (warm medians of 3); auto "
                f"picks {'device' if build_map(cfg)._ingest_enabled() else 'host'}")
        res[fam] = runs
    return res


def large_map(out: str, sets: dict, dev) -> None:
    """Phase 3: the depth-6 LV large map on the 60-scan set."""
    prefix = os.path.join(out, "large", "lv6")
    st = map_stats(cli_run("static", "--method", "bgklvoctomap_large_map",
                           "--dataset", sets["s60"], "--out", prefix))
    ms = dev.memory_stats() or {}
    log(f"large map bgklv depth 6 (V=32^3): {st['scans']} scans, "
        f"{st['scans_per_s']} scans/s, total {st['total_s']} s, "
        f"active_blocks {st['active_blocks']}, state_bytes "
        f"{st['state_bytes']}, peak_bytes_in_use "
        f"{ms.get('peak_bytes_in_use', 'not reported')}")
    check(st["active_blocks"] > 0, "large map has no blocks")


def server_and_queries(out: str, sets: dict) -> None:
    """Phase 4: online server over the 12-scan directory, then queries."""
    import numpy as np
    from la3dm_tpu.io.pcd import load_pcd

    watch = os.path.dirname(sets["s12"])
    prefix = os.path.join(out, "server", "lv")
    common = ("--method", "bgklv", "--set", "max_range=8")
    srv = cli_run("server", "--watch", watch, "--once", "--out", prefix,
                  *common)
    n_int = len(re.findall(r"^One cloud finished", srv, re.M))
    log(f"server: {n_int} clouds integrated, "
        f"{len(re.findall(r'^Skipped', srv, re.M))} gated")
    check(n_int > 0, "server integrated no cloud")
    ckpt = prefix + "_map.npz"

    cloud, origin = load_pcd(os.path.join(watch, "s12_1.pcd"))
    pts = cloud[:: max(len(cloud) // 8, 1)][:8]
    q = cli_run("query", "--checkpoint", ckpt, *common, "--",
                *[",".join(f"{v:.4f}" for v in p) for p in pts])
    probs = [float(x) for x in re.findall(r"prob=([-+0-9.eEna]+)", q)]
    log(f"query: {len(probs)} points, prob {probs}")
    check(len(probs) == len(pts) and np.all(np.isfinite(probs)),
          "query returned missing or non-finite probabilities")

    rays = [",".join(f"{v:.4f}" for v in (*origin, *p)) for p in pts]
    r = cli_run("raycast", "--checkpoint", ckpt, *common, "--", *rays)
    hits = re.findall(r"hit=(True|False)", r)
    log(f"raycast: {len(hits)} rays, {hits.count('True')} hits")
    check(len(hits) == len(rays), "raycast answered too few rays")

    f = cli_run("frontier", "--checkpoint", ckpt, *common)
    n_front = json.loads(f.strip().splitlines()[-1])["frontier_voxels"]
    log(f"frontier: {n_front} voxels")
    check(n_front >= 0, "frontier returned a negative count")


def parity(out: str, sets: dict, static: dict) -> None:
    """Phase 5: the card against the oracle, the CPU backend, and the host
    ingestion path; and the repeatability of phase 2's two runs."""
    import jax
    from la3dm_tpu.pipeline import build_map
    from la3dm_tpu.utils.config import load_method_config
    from tests import parity as P

    for name in P.ORACLE_CASES:
        n, dev_ = P.oracle_case(name)       # raises past the tolerance
        log(f"oracle {name}: {n} voxels, max deviation {dev_}")
    for fam in P.INGEST_FAMILIES:
        for seed in (0, 5):
            d = P.ingest_on_off(fam, seed)
            log(f"ingest on/off {fam} seed {seed}: {json.dumps(d)}")
            check(d["blocks_only_a"] == 0 and d["blocks_only_b"] == 0,
                  f"device ingestion changed {fam}'s block set")
            check(d["max_abs"] <= 1e-3, f"device ingestion moved {fam} by "
                  f"{d['max_abs']} (limit 1e-3)")

    cpu = jax.devices("cpu")[0]
    for fam in FAMILIES:
        ds = sets["u12" if fam == "gp" else "s12"]
        cfg = load_method_config(fam)
        ref = build_map(cfg)
        runs = static[fam]
        d = P.checkpoint_diff(runs["A"]["npz"], runs["B"]["npz"], ref)
        log(f"repeat {fam} A vs B: {json.dumps(d)}")
        check(d["mae"] <= P.MAE_BOUND, f"{fam}: two runs differ, MAE {d['mae']}")

        prefix = os.path.join(out, "cpu", fam)
        with jax.default_device(cpu):
            st = map_stats(cli_run("static", "--method", fam, "--dataset", ds,
                                   "--out", prefix,
                                   "--set", "device_ingest=off"))
        d = P.checkpoint_diff(runs["B"]["npz"], prefix + "_map.npz", ref)
        log(f"card vs cpu {fam}: {json.dumps(d)} (cpu {st['scans_per_s']} "
            "scans/s)")
        check(d["mae"] <= P.MAE_BOUND,
              f"{fam}: card vs CPU MAE {d['mae']} > {P.MAE_BOUND}")

        if fam in INGEST_FAMILIES:
            for tag_a, tag_b, what in (
                    ("B", "D", "cli scan-by-scan"),
                    ("batched_on", "D", "batched device vs cli host"),
                    ("batched_on", "batched_off", "batched")):
                d = P.checkpoint_diff(runs[tag_a]["npz"], runs[tag_b]["npz"],
                                      ref)
                log(f"card device vs host ingest {fam} ({what}): "
                    f"{json.dumps(d)}")
                check(d["mae"] <= P.MAE_BOUND,
                      f"{fam}: device vs host ingest ({what}) MAE {d['mae']}")


def _union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace_summary(trace_dir: str, k: int = 10) -> dict:
    """Top ``k`` device ops by summed duration [(name, µs, count)], and the
    device's busy time (union of its events on every stream) over the
    trace's window (first to last event on any plane)."""
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    check(bool(paths), f"no trace written under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    tot: dict = {}
    dev_iv, all_iv = [], []
    for plane in pd.planes:
        is_dev = "/device:" in plane.name
        lines = list(plane.lines)
        if is_dev:
            log(f"trace plane {plane.name}: lines {[ln.name for ln in lines]}")
        for line in lines:
            for ev in line.events:
                all_iv.append((ev.start_ns, ev.end_ns))
                if is_dev:
                    dev_iv.append((ev.start_ns, ev.end_ns))
                    t, c = tot.get(ev.name, (0.0, 0))
                    tot[ev.name] = (t + ev.duration_ns / 1e3, c + 1)
    window = (max(e for _, e in all_iv) - min(a for a, _ in all_iv)
              if all_iv else 0)
    tops = sorted(((n, t, c) for n, (t, c) in tot.items()),
                  key=lambda x: -x[1])[:k]
    return {"tops": tops, "busy_ns": _union_ns(dev_iv), "window_ns": window}


def traces(out: str, sets: dict) -> None:
    """Phase 6: one warm traced run each of BGK and LV."""
    for fam in ("bgk", "bgklv"):
        tdir = os.path.join(out, "trace", fam)
        cli_run("static", "--method", fam, "--dataset", sets["s12"],
                "--profile-dir", tdir)
        t = trace_summary(tdir)
        check(bool(t["tops"]), f"{fam} trace holds no device op")
        log(f"trace {fam} (cli static, 12 scans, warm): device busy "
            f"{t['busy_ns'] / 1e6:.3f} ms of a {t['window_ns'] / 1e6:.3f} ms "
            f"window (idle share "
            f"{1 - t['busy_ns'] / max(t['window_ns'], 1):.4f})")
        log(f"top device ops {fam}:")
        for name, us, count in t["tops"]:
            log(f"  {us:12.1f} us  {count:6d}x  {name[:100]}")


def four_cards(sets: dict) -> None:
    """--four: the Sharded*OctoMap classes on a 4-device block mesh, with
    device ingestion as on one card, against the single-card map."""
    import jax
    import numpy as np
    from la3dm_tpu.io.pcd import load_pcd
    from la3dm_tpu.parallel import mesh as pm
    from la3dm_tpu.parallel.sharded_map import (
        ShardedBGKLOctoMap, ShardedBGKLVOctoMap, ShardedBGKOctoMap,
        ShardedGPOctoMap)
    from la3dm_tpu.pipeline import MAP_CLASSES
    from la3dm_tpu.utils.config import load_dataset_config, load_method_config
    from tests import parity as P

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, JAX has "
          f"{len(jax.devices())}")
    mesh = pm.block_mesh(4)
    log(f"mesh: {[d.id for d in mesh.devices.flat]}")
    sharded = {"bgk": ShardedBGKOctoMap, "bgkl": ShardedBGKLOctoMap,
               "bgklv": ShardedBGKLVOctoMap, "gp": ShardedGPOctoMap}
    for fam in FAMILIES:
        ds = load_dataset_config(sets["u12" if fam == "gp" else "s12"])
        scans = [load_pcd(os.path.join(ds.dir, f"{ds.prefix}_{i}.pcd"))
                 for i in range(1, ds.scan_num + 1)]
        cfg = load_method_config(fam, device_ingest="on")
        kw = dict(ds_resolution=cfg.resolution,
                  free_resolution=cfg.free_resolution, max_range=ds.max_range)
        one = MAP_CLASSES[fam](cfg)
        many = sharded[fam](cfg, mesh=mesh)
        t0 = time.perf_counter()
        one.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                               **kw)
        for a in one.pool.fields.values():
            a.block_until_ready()
        t1 = time.perf_counter()
        many.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                                **kw)
        for a in many.pool.fields.values():
            a.block_until_ready()
        t2 = time.perf_counter()
        check(many.stats["host_fallback_chunks"] == 0,
              f"sharded {fam}: chunks fell back to the host path")
        d = P.map_diff(one, many)
        log(f"sharded {fam} vs one card: {json.dumps(d)} (one card "
            f"{t1 - t0:.3f} s, four {t2 - t1:.3f} s, cold)")
        check(d["blocks_only_a"] == 0 and d["blocks_only_b"] == 0,
              f"sharded {fam}: block sets differ")
        check(d["max_abs"] <= 1e-3, f"sharded {fam}: max |Δprob| "
              f"{d['max_abs']} > 1e-3")

        def skew(m):
            rep = pm.replicated(mesh)
            touched = np.asarray(jax.jit(lambda x: x, out_shardings=rep)(
                m.pool.touched)).reshape(4, -1)
            load = touched.sum(axis=1).astype(np.float64)
            return load.max() / max(load.mean(), 1e-9), load.astype(int).tolist()

        s0, l0 = skew(many)
        many.rebalance()
        s1, l1 = skew(many)
        d = P.map_diff(one, many)
        check(d["max_abs"] <= 1e-3, f"sharded {fam}: rebalance changed the map")
        log(f"placement skew {fam}: max/mean {s0:.3f} {l0} -> after "
            f"rebalance {s1:.3f} {l1}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"),
                    help="directory for scans, maps and traces")
    args = ap.parse_args(argv)

    # phase 5 compares with the CPU backend in this process
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    # the persistent cache keys CPU executables without the host's machine
    # features, so a process that compiles for the CPU keeps out of it
    jax.config.update("jax_enable_compilation_cache", False)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's default device is {dev}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import la3dm_tpu  # noqa: F401  (fails here when only this file is present)

    log(f"jax {jax.__version__}; devices {jax.devices()}")
    log(f"card: {card_line()}")
    out = os.path.abspath(args.out)
    sizes = {"short": 12, "long": 60, "n_az": 70, "n_el": 50}
    t0 = time.perf_counter()
    with phase("1 generate scans"):
        sets = gen_scans(out, sizes)
    if args.four:
        with phase("four-card sharded maps"):
            four_cards(sets)
    else:
        with phase("2 offline mapping (cli static)"):
            static = static_runs(out, sets)
        with phase("3 large map (depth 6, 60 scans)"):
            large_map(out, sets, dev)
        with phase("4 server and queries"):
            server_and_queries(out, sets)
        with phase("5 parity on the card"):
            parity(out, sets, static)
        with phase("6 trace"):
            traces(out, sets)
    log(f"all phases passed in {time.perf_counter() - t0:.3f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
