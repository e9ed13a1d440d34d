#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line for the driver.

Workloads (BASELINE.md):
* the reference demo configs (12 scans × 3500 pts) for all four methods —
  BGKLV is the launch-default method and the primary metric;
* the full 60-scan ``sim_structured_long_term`` sequence for every method
  (the 12-scan demo saturates in tens of ms for the cheap methods, where
  fixed per-run overhead — not the framework — dominates the ratio);
* a dense synthetic sequence (240 scans: the 60 long-term scans × 4
  jitter-replicated, σ=2 cm) so the cheapest method (BGK) runs ≥2 s;
* the reference ``bgklvoctomap_large_map`` config (block_depth **6** ⇒
  V=32³ voxels/block, widened keys in the reference) on real scans — the
  depth-6 feasibility workload.

Each method is run once to warm the jit cache (persistent-cached), then up
to STEADY_RUNS fresh runs; the reported number is the MEDIAN (min/max
spread included) — same policy for the C++ baselines, so neither side
benefits from best-of-N selection.

Per method the JSON also reports:
* ``host_s`` / ``device_s`` — wall split between host preprocessing/table
  building (measured inside the map classes) and everything else
  (dispatch + device compute + drain) for the median run;
* ``est_gflops_per_s`` / ``mfu_pct`` — estimated from kernel-eval counts ×
  per-method FLOP costs (documented below) against the device's published
  f32 peak (``PEAKS``); these pin WHERE the bottleneck is (host vs device)
  rather than claiming precision;
* ``online_scan_latency_ms`` — median single-scan ``insert_pointcloud``
  latency with a device barrier per scan (the server regime,
  ``bgkoctomap_server.cpp:85-89``), as opposed to the batched offline
  throughput.

vs_baseline: ratio against single-core C++ reference stand-ins
(native/baseline_*.cpp — faithful single-threaded implementations of the
reference hot paths with equal-or-faster spatial indexing; the ROS/PCL
upstream cannot build here).  Built and timed on this machine.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REF_DATA = "/root/reference/data"
PRIMARY = "bgklv"
STEADY_RUNS = 3       # median-of-N; spread reported alongside
STEADY_BUDGET_S = 120  # stop adding steady runs past this cumulative wall

# estimated f32 FLOPs per (training entry × voxel) kernel evaluation:
# point kernel: 3-axis diff/sq/acc + sqrt (~12) + sparse kernel (~12,
# plus 2 transcendentals) + (ȳ,k̄) matvec 2·2G with G=7 (~28) ≈ 50.
# segment kernel adds the point-to-segment projection (~45).  LV adds the
# per-(voxel,ray) interval-membership test (~35).  GP's count includes the
# per-block Cholesky/solve terms in its kernel_evals accounting (gp.py).
# The count excludes the aligned engine's row padding and the on-device
# ingestion pipeline (sorts, scans, lookups), so it counts useful FLOPs only.
FLOP_PER_EVAL = {"bgk": 50, "bgkl": 95, "bgklv": 130, "gp": 60}
# Published peaks per device_kind (NVIDIA H100 SXM data sheet: dense rates
# without sparsity, at the full 700 W power limit): f32 outside the tensor
# cores, TF32 and bf16 tensor-core rates, HBM bandwidth.  They hold at 700 W
# only: a card capped lower (the output's ``card`` line gives its limit)
# cannot reach them, so a share against them reads low there.  A device
# kind not listed here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def card_line() -> str | None:
    """``name, power.limit`` of the first GPU as nvidia-smi reports it, or
    None where there is no nvidia-smi.  Runs in a child process, so the
    caller stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_peaks(kind: str) -> dict:
    """Published peaks of ``kind`` (``jax.devices()[0].device_kind``)."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}: add "
                       "them to bench.PEAKS with their source")
    return PEAKS[kind]

DENSE_DIR = "/tmp/la3dm_dense960"
DENSE_N = 960  # sized so BGK (the cheapest method) runs ≥2 s device-visible

LM_DIR = "/tmp/la3dm_largemap540"
LM_TILES = 3       # 3×3 spatial tiling of the long-term environment
LM_SPACING = 24.0  # m between tile origins (> 2·max_range: tiles independent)
LM_N = 60 * LM_TILES * LM_TILES


def make_dense_dataset():
    """Jitter-replicated long-term scans (deterministic), as PCD files
    both sides read: scan i = long_term scan ((i-1) % 60) + 1 with N(0, 2cm)
    point jitter, seed = i."""
    sys.path.insert(0, REPO)
    import numpy as np
    from la3dm_tpu.io.pcd import load_pcd, save_pcd

    marker = os.path.join(DENSE_DIR, ".complete")
    if os.path.exists(marker):
        return
    os.makedirs(DENSE_DIR, exist_ok=True)
    src = f"{REF_DATA}/sim_structured_long_term"
    for i in range(1, DENSE_N + 1):
        j = (i - 1) % 60 + 1
        cloud, origin = load_pcd(f"{src}/sim_structured_long_term_{j}.pcd")
        rng = np.random.default_rng(i)
        pts = cloud + rng.normal(0.0, 0.02, cloud.shape).astype(np.float32)
        save_pcd(os.path.join(DENSE_DIR, f"dense960_{i}.pcd"), pts, origin)
    open(marker, "w").close()


def make_largemap_dataset():
    """540 scans: the 60 long-term scans replicated on a 3×3 spatial grid
    (24 m apart, so tiles are independent) — the large-map scale workload:
    thousands of active blocks, pool growth, hundreds of MB of map state at
    block_depth 6 (V=32³)."""
    sys.path.insert(0, REPO)
    import numpy as np
    from la3dm_tpu.io.pcd import load_pcd, save_pcd

    marker = os.path.join(LM_DIR, ".complete")
    if os.path.exists(marker):
        return
    os.makedirs(LM_DIR, exist_ok=True)
    src = f"{REF_DATA}/sim_structured_long_term"
    i = 0
    for ty in range(LM_TILES):
        for tx in range(LM_TILES):
            off = np.array([tx * LM_SPACING, ty * LM_SPACING, 0.0], np.float32)
            for j in range(1, 61):
                cloud, origin = load_pcd(
                    f"{src}/sim_structured_long_term_{j}.pcd")
                i += 1
                save_pcd(os.path.join(LM_DIR, f"largemap540_{i}.pcd"),
                         cloud + off, origin + off)
    open(marker, "w").close()


def _build(exe, src):
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(["g++", "-O3", "-march=native", "-ffast-math", "-o", exe, src],
                       check=True)


def cpp_baseline(method: str, data_dir: str, prefix: str, scan_num: int) -> dict:
    native = os.path.join(REPO, "native")
    if method == "bgk":
        exe = os.path.join(native, "baseline_bgk")
        _build(exe, exe + ".cpp")
        cmd = [exe, data_dir, prefix, str(scan_num), "--json"]
    elif method == "gp":
        exe = os.path.join(native, "baseline_gp")
        _build(exe, exe + ".cpp")
        cmd = [exe, data_dir, prefix, str(scan_num), "--json"]
    else:
        exe = os.path.join(native, "baseline_lv")
        _build(exe, exe + ".cpp")
        cmd = [exe, method, data_dir, prefix, str(scan_num), "--json"]
    runs, t0 = [], time.time()
    for _ in range(STEADY_RUNS):
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        runs.append(json.loads(out.stdout))
        if time.time() - t0 > STEADY_BUDGET_S:
            break
    runs.sort(key=lambda r: r["scans_per_s"])
    return runs[len(runs) // 2]  # median run


# key → (method config, dataset, scan_num override, baseline method or None,
#        measure online latency?).  The first five keys keep their r02 names.
CONFIGS = [
    {"key": "bgk", "method": "bgk", "dataset": "sim_structured",
     "baseline": "bgk", "online": True},
    {"key": "bgkl", "method": "bgkl", "dataset": "sim_structured",
     "baseline": "bgkl", "online": True},
    {"key": "bgklv", "method": "bgklv", "dataset": "sim_structured",
     "baseline": "bgklv", "online": True},
    {"key": "gp", "method": "gp", "dataset": "sim_unstructured",
     "baseline": "gp", "online": True},
    {"key": "bgklv_sim_structured_long_term", "method": "bgklv",
     "dataset": "sim_structured_long_term", "baseline": "bgklv"},
    # the full 60-scan long-horizon sequence for EVERY method
    {"key": "bgk_long60", "method": "bgk",
     "dataset": "sim_structured_long_term", "scan_num": 60, "baseline": "bgk"},
    {"key": "bgkl_long60", "method": "bgkl",
     "dataset": "sim_structured_long_term", "scan_num": 60, "baseline": "bgkl"},
    {"key": "gp_long60", "method": "gp",
     "dataset": "sim_structured_long_term", "scan_num": 60, "baseline": "gp"},
    {"key": "bgklv_long60", "method": "bgklv",
     "dataset": "sim_structured_long_term", "scan_num": 60, "baseline": "bgklv"},
    # dense synthetic: the cheapest method on a ≥2 s workload
    {"key": "bgk_dense960", "method": "bgk", "dataset": "@dense960",
     "baseline": "bgk"},
    # kernel-only device saturation (VERDICT r03 ask #2): tables pre-staged
    # on device, sweep row count — what the engines do when *fed*
    {"key": "kernel_roofline", "special": "roofline"},
    # depth-6 feasibility: reference bgklvoctomap_large_map.yaml (block_depth
    # 6 ⇒ V=32768).  No C++ ratio: the stand-ins run the demo configs.
    {"key": "bgklv_large_map_depth6", "method": "bgklvoctomap_large_map",
     "dataset": "sim_structured", "baseline": None},
    # large-map AT SCALE (VERDICT r03 ask #4): 540 spatially-tiled scans,
    # thousands of active depth-6 blocks, pool growth on device, peak HBM
    {"key": "bgklv_large_map_depth6_540", "method": "bgklvoctomap_large_map",
     "dataset": "@largemap540", "baseline": None, "runs": 1},
]


def _dataset(name: str, scan_num):
    from la3dm_tpu.utils.config import DatasetConfig, load_dataset_config

    if name == "@dense960":
        make_dense_dataset()
        ds = DatasetConfig(name="dense960", dir=DENSE_DIR, prefix="dense960",
                           scan_num=DENSE_N, max_range=8.0)
    elif name == "@largemap540":
        make_largemap_dataset()
        ds = DatasetConfig(name="largemap540", dir=LM_DIR,
                           prefix="largemap540", scan_num=LM_N, max_range=8.0)
    else:
        ds = load_dataset_config(name)
    if scan_num:
        ds = DatasetConfig(**{**ds.__dict__, "scan_num": scan_num})
    return ds


def run_roofline() -> dict:
    """Kernel-only device saturation: tables pre-staged on device, sweep the
    row count, report achieved GFLOP/s and MFU for (a) the aligned BGK/BGKL
    row contraction (``models/bgk.py::_aligned_heavy`` — the production
    heavy pass, scatter included; reference math bgkinference.h:73-126) and
    (b) GP's padded batched Cholesky + solves (``kernels/gp.py::
    gp_train_core``, reference gpregressor.h:42-92), plus (c) a dense bf16
    matmul anchor showing what this device's tensor cores yield under the
    same harness.  This is the roofline counterpart to the per-workload
    host/device split: what the engines do when *fed*.
    """
    import functools
    import numpy as np
    import jax
    import jax.numpy as jnp
    from la3dm_tpu.kernels import gp as kgp
    from la3dm_tpu.models import bgk as B

    kind = jax.devices()[0].device_kind
    peaks = device_peaks(kind)
    peak = peaks["f32"]
    out = {"device_kind": kind, "peak_f32_flops": peak}

    def best_s(fn, n=5):
        fn()  # warm/compile
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            np.asarray(fn())
            ts.append(time.perf_counter() - t0)
        return min(ts)

    # (c) anchor: one dense bf16 matmul
    N = 8192
    x = jnp.ones((N, N), jnp.bfloat16)
    mm = jax.jit(lambda a: (a @ a)[0, 0])
    t = best_s(lambda: mm(x))
    out["bf16_matmul_8192"] = {
        "gflops_per_s": round(2 * N ** 3 / t / 1e9, 1),
        "pct_of_bf16_peak": round(100 * 2 * N ** 3 / t / peaks["bf16"], 1)}

    # (a) aligned BGK row contraction at production shapes (entry-block
    # accumulator layout: SORTED row targets, as the ingest sort guarantees)
    rng = np.random.default_rng(0)
    G, Vall, Wa, chunk = 7, 585, 8, 64
    Up = 16 * 1024  # K=16 scans × Bu=1024 entry blocks (the production acc)
    FLOP_KERNEL = 34  # 3-axis diff/sq/acc + sqrt + sparse kernel + dot MAC

    @functools.partial(jax.jit, static_argnames=("Wa", "chunk", "G", "seg"))
    def heavy_only(ext, e, l, m, tg, Wa, chunk, G, seg):
        acc = jnp.zeros((Up + 1, G * Vall * 2), jnp.float32)
        return B._aligned_heavy(acc, ext, e, l, m, tg, Wa, chunk, G,
                                1.0, 0.2, seg)[0, 0]

    ext = jnp.asarray(rng.uniform(-1, 1, (G * Vall, 3)).astype(np.float32))
    for rows in (8192, 32768, 131072):
        e = jnp.asarray(rng.uniform(-1, 1, (rows * Wa, 3)).astype(np.float32))
        l = jnp.asarray((rng.random(rows * Wa) < 0.3).astype(np.float32))
        m = jnp.asarray(np.ones(rows * Wa, bool))
        tg = jnp.asarray(np.sort(rng.integers(0, Up, rows)).astype(np.int32))
        t = best_s(lambda: heavy_only(ext, e, l, m, tg, Wa, chunk, G, False))
        fl = rows * Wa * G * Vall * FLOP_KERNEL
        out[f"bgk_row_engine_rows{rows}"] = {
            "gflops_per_s": round(fl / t / 1e9, 1),
            "mfu_pct": round(100 * fl / t / peak, 2),
            "kernel_evals_per_s": round(rows * Wa * G * Vall / t / 1e9, 2)}

    # (b) GP batched Cholesky + triangular solves (both size tiers)
    for S, Bk in ((64, 2048), (256, 256)):
        pts = jnp.asarray(rng.uniform(-1, 1, (Bk, S, 3)).astype(np.float32))
        lab = jnp.asarray(rng.uniform(-1, 1, (Bk, S)).astype(np.float32))
        val = jnp.asarray(np.ones((Bk, S), bool))

        @jax.jit
        def gp_fn(p, y, q):
            L, alpha = kgp.gp_train_core(p, y, q, sf2=1.0, ell=1.0,
                                         noise=0.01)
            return L[0, 0, 0] + alpha[0, 0]

        t = best_s(lambda: gp_fn(pts, lab, val))
        fl = Bk * (20 * S * S + S ** 3 / 3.0 + 2 * S * S)
        out[f"gp_cholesky_S{S}_B{Bk}"] = {
            "gflops_per_s": round(fl / t / 1e9, 1),
            "mfu_pct": round(100 * fl / t / peak, 2)}
    return out


def run_one(spec: dict) -> dict:
    """One config's measurement (runs inside its own process)."""
    sys.path.insert(0, REPO)
    if spec.get("special") == "roofline":
        return run_roofline()
    from la3dm_tpu.pipeline import run_static
    from la3dm_tpu.utils.config import load_method_config

    # executable accounting (VERDICT r4 #7): count XLA compiles + wall spent
    # compiling over the whole config (warm + steady runs); persistent-cache
    # hits register sub-second durations
    compiles = {"n": 0, "s": 0.0}
    from jax._src import monitoring as _mon

    def _on_compile(event, duration, **kw):
        if event.endswith("backend_compile_duration"):
            compiles["n"] += 1
            compiles["s"] += duration

    _mon.register_event_duration_secs_listener(_on_compile)

    cfg = load_method_config(spec["method"])
    ds = _dataset(spec["dataset"], spec.get("scan_num"))
    t0 = time.time()
    run_static(cfg, ds)                 # warm: compiles (persistent-cached)
    warm_s = time.time() - t0
    runs = []                           # steady state, fresh map each time
    t0 = time.time()
    for _ in range(spec.get("runs", STEADY_RUNS)):
        runs.append(run_static(cfg, ds))
        if time.time() - t0 > STEADY_BUDGET_S:
            break
    runs.sort(key=lambda r: r.scans_per_second)
    med = runs[len(runs) // 2]
    rates = [r.scans_per_second for r in runs]
    host_s = float(med.map.stats.get("host_s", 0.0))
    device_s = max(med.total_seconds - host_s, 0.0)
    evals = med.map.stats["kernel_evals"]
    flops = evals * FLOP_PER_EVAL.get(spec["method"].split("_")[0],
                                      FLOP_PER_EVAL.get(cfg.method, 50))
    import jax

    dev = jax.devices()[0]
    peak = device_peaks(dev.device_kind)["f32"]
    pool = med.map.pool
    state_bytes = int(pool.nbytes)
    out = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "dataset": ds.name,
        "scan_num": ds.scan_num,
        "scans_per_s": round(med.scans_per_second, 3),      # median of N
        "scans_per_s_min": round(min(rates), 3),
        "scans_per_s_max": round(max(rates), 3),
        "total_s": round(med.total_seconds, 3),
        "warmup_s": round(warm_s, 1),
        "executables_compiled": compiles["n"],
        "compile_s": round(compiles["s"], 1),
        "kernel_evals_per_s": round(evals / med.total_seconds, 1),
        "host_s": round(host_s, 3),
        "device_s": round(device_s, 3),
        "host_frac": round(host_s / max(med.total_seconds, 1e-9), 3),
        "est_gflops_per_s": round(flops / max(device_s, 1e-9) / 1e9, 1),
        "mfu_pct": round(100.0 * flops / max(device_s, 1e-9) / peak, 3),
        "map_state_bytes": state_bytes,
        "active_blocks": int(pool.n_blocks),
    }
    try:
        ms = jax.local_devices()[0].memory_stats() or {}
        if "peak_bytes_in_use" in ms:
            out["peak_hbm_bytes"] = int(ms["peak_bytes_in_use"])
    except Exception:
        pass
    if spec.get("online"):
        # single-scan latency, device barrier per scan (server regime);
        # first scan compiles the K=1 executable — measured separately
        r = run_static(cfg, ds, block_per_scan=True, batch_scans=False)
        lat = sorted(r.per_scan_seconds[1:]) or r.per_scan_seconds
        out["online_scan_latency_ms"] = round(1e3 * lat[len(lat) // 2], 2)
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--spec":
        print(json.dumps(run_one(json.loads(sys.argv[2]))))
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--method":  # kept for hand runs
        spec = {"method": sys.argv[2], "dataset": sys.argv[3], "online": True}
        print(json.dumps(run_one(spec)))
        return 0

    # build the native host-preprocessing library + the dense dataset once up
    # front so no method's warmup pays for them
    try:
        sys.path.insert(0, REPO)
        from la3dm_tpu.geometry import native as _native

        _native.available()
        make_dense_dataset()
    except Exception as e:
        print(f"setup: {e}", file=sys.stderr)

    # each config in its own process, one after another (one process on the
    # card at a time; this parent never initializes a JAX backend): no
    # config inherits another's executables or pad ladders, and the
    # persistent compilation cache carries the executables across them
    results = {}
    for spec in CONFIGS:
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--spec",
                 json.dumps(spec)],
                capture_output=True, text=True, timeout=2400, check=True)
            r = json.loads(out.stdout.strip().splitlines()[-1])
        except Exception as e:
            tail = ""
            if isinstance(e, subprocess.CalledProcessError):
                tail = (e.stderr or "")[-500:]
            print(f"config {spec['key']} failed: {e}\n{tail}", file=sys.stderr)
            continue
        if spec.get("baseline"):
            if spec["dataset"] == "@dense960":
                bdir, bprefix, bn = DENSE_DIR, "dense960", DENSE_N
            else:
                bdir = f"{REF_DATA}/{spec['dataset']}"
                bprefix = spec["dataset"]
                bn = r["scan_num"]
            try:
                base_sps = cpp_baseline(spec["baseline"], bdir, bprefix,
                                        bn)["scans_per_s"]
                r["vs_baseline"] = round(r["scans_per_s"] / base_sps, 3)
                r["baseline_scans_per_s"] = round(base_sps, 3)
            except Exception as e:  # a failed stand-in gives no ratio
                print(f"baseline {spec['key']} failed: {e}", file=sys.stderr)
                r["vs_baseline"] = None
        else:
            r["vs_baseline"] = None
        results[spec["key"]] = r

    # the platform as the children reported it
    platform = next((r["platform"] for r in results.values()
                     if "platform" in r), "unknown")
    p = results.get(PRIMARY) or next(iter(results.values()))
    print(json.dumps({
        "metric": f"{PRIMARY}_scan_integration_throughput_sim_structured",
        "value": p["scans_per_s"],
        "unit": "scans/s",
        "vs_baseline": p["vs_baseline"],
        "device": platform,
        "card": card_line(),
        "methods": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
