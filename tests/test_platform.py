"""What the GPU port changed, checked on the CPU: the device-ingest gate,
pinned dot precision, the compile-cache location, the stdlib config reader,
the bench's peak table, fallback accounting and chip_smoke.py's refusal to
run without a GPU."""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import la3dm_tpu
from la3dm_tpu.geometry import device_ingest
from la3dm_tpu.kernels import gp as kgp
from la3dm_tpu.models import bgk as B, bgklv as LV
from la3dm_tpu.models.bgk import BGKOctoMap
from la3dm_tpu.utils import config as C
from tests.test_bgk_vs_oracle import CFG, synthetic_scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------- ingest gate


@pytest.mark.parametrize("backend,mode,want", [
    ("gpu", "auto", True), ("cpu", "auto", False),
    ("gpu", "off", False), ("cpu", "on", True)])
def test_ingest_gate_follows_backend(monkeypatch, backend, mode, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    m = BGKOctoMap(dataclasses.replace(CFG, device_ingest=mode))
    assert m._ingest_enabled() is want


@pytest.mark.parametrize("method,mode,want", [
    ("bgk", "auto", True), ("gp", "auto", True), ("bgkl", "auto", False),
    ("bgkl", "on", True), ("gp", "off", False)])
def test_ingest_gate_per_family_on_gpu(monkeypatch, method, mode, want):
    """Under ``auto`` on the GPU only the families whose device ingestion
    measured faster take it; "on" and "off" force it either way."""
    from la3dm_tpu.pipeline import build_map

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = C.load_method_config(method, device_ingest=mode)
    assert build_map(cfg)._ingest_enabled() is want


# ----------------------------------------------------------- dot precisions


def _dot_precisions(jaxpr) -> list:
    """precision params of every dot_general in a (closed) jaxpr, nested
    sub-jaxprs (scan/map/cond bodies, pjit) included."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _assert_all_highest(jaxpr, expect_at_least=1):
    precs = _dot_precisions(jaxpr)
    assert len(precs) >= expect_at_least, precs
    assert all(p == HIGHEST for p in precs), precs


def test_aligned_heavy_pass_dots_are_highest():
    G, Vall, Wa, chunk, R2K = 7, 16, 8, 2, 4
    acc = jnp.zeros((5, 2 * G * Vall), jnp.float32)
    jx = jax.make_jaxpr(
        lambda a, ext, e, l, m, tg: B._aligned_heavy(
            a, ext, e, l, m, tg, Wa, chunk, G, 1.0, 0.2, False))(
        acc, jnp.zeros((G * Vall, 3)), jnp.zeros((R2K * Wa, 3)),
        jnp.zeros(R2K * Wa), jnp.zeros(R2K * Wa, bool),
        jnp.zeros(R2K, jnp.int32))
    _assert_all_highest(jx, 2)


def test_host_path_heavy_dot_is_highest():
    m = BGKOctoMap(CFG)
    cfg = m.cfg
    G = m.num_slots
    an, ni = jnp.asarray(m._all_nodes_host), jnp.asarray(m._node_idx_host)
    pool = m.pool
    jx = jax.make_jaxpr(
        lambda *a: B._bgk_seq_step(
            *a, W=B._ROW_W, chunk=B._CHUNK, G=G, sf2=cfg.sf2, ell=cfg.ell,
            gate=0.0, n=m.n, max_level=cfg.block_depth - 1, segments=False,
            state_fn=m._state_fn, do_prune=False, scan_bt=256))(
        pool.fields["A"], pool.fields["B"], pool.touched, pool.eff_level,
        an, ni, jnp.zeros((64, 3)), jnp.zeros(64), jnp.zeros(128, jnp.int32),
        jnp.zeros(128, jnp.int8), jnp.zeros(B._CHUNK, jnp.int32),
        jnp.zeros(B._CHUNK, jnp.int32), jnp.zeros(B._CHUNK, jnp.int32),
        jnp.zeros(256, jnp.int32), jnp.zeros((256, 3)),
        jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32))
    _assert_all_highest(jx)


def test_lv_row_dot_is_highest():
    V, Vt, W, chunk, Rw, Tp = 64, 8, 4, 2, 4, 2
    cap = 2
    jx = jax.make_jaxpr(
        lambda *a: LV._lv_rows_step(
            *a, V=V, W=W, chunk=chunk, sf2=0.1, ell=0.2, free_res=0.1,
            gate=0.001))(
        jnp.zeros(cap * V), jnp.zeros(cap * V), jnp.zeros(cap * V, bool),
        jnp.zeros(cap * V, jnp.int8), jnp.zeros((V // Vt, Vt, 3)),
        jnp.zeros((16, 6)), jnp.zeros(16), jnp.zeros(32, jnp.int32),
        jnp.zeros(Rw, jnp.int32), jnp.zeros(Rw, jnp.int32),
        jnp.zeros(Rw, jnp.int32), jnp.zeros(Tp, jnp.int32),
        jnp.zeros(Tp, jnp.int32), jnp.zeros((Tp, 3)))
    _assert_all_highest(jx)


def test_gp_mean_dot_is_highest():
    Bk, S, M = 2, 4, 5
    jx = jax.make_jaxpr(
        lambda L, a, p, v, x: kgp.gp_predict_core(L, a, p, v, x, 1.0, 1.0))(
        jnp.ones((Bk, S, S)), jnp.zeros((Bk, S)), jnp.zeros((Bk, S, 3)),
        jnp.ones((Bk, S), bool), jnp.zeros((Bk, M, 3)))
    _assert_all_highest(jx)


def test_onehot_lookups_are_highest():
    spec = device_ingest.IngestSpec(
        P=16, Ph=8, Pf=8, Kf=2, Bu=8, T=8, ds=0.1, fr=0.5, mr=1.0,
        block_size=0.4, free_label=0.0)
    off = jnp.asarray(device_ingest._pack_offsets(
        np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0]])))
    jx = jax.make_jaxpr(
        lambda k, p: device_ingest._bucket_align(k, (p,), spec, off))(
        jnp.zeros(spec.Mraw, jnp.int32), jnp.zeros(spec.Mraw))
    _assert_all_highest(jx, 2)


# ------------------------------------------------------------- compile cache


@pytest.mark.parametrize("env,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/here"}, "/cache/here"),
    ({"JAX_COMPILATION_CACHE_DIR": "/c", "JAX_PLATFORMS": "cuda"}, "/c"),
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_PLATFORMS": "cuda,cpu"}, None),
    ({"JAX_PLATFORMS": "cpu"}, None),
])
def test_compile_cache_dir(env, want):
    assert la3dm_tpu.compile_cache_dir(env) == want


# ------------------------------------------------------------- config reader

CONFIG_FILES = sorted(glob.glob(os.path.join(C._CONFIG_ROOT, "*", "*.yaml")))


@pytest.mark.parametrize("path", CONFIG_FILES,
                         ids=[os.path.relpath(p, C._CONFIG_ROOT)
                              for p in CONFIG_FILES])
def test_config_reader_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        want = yaml.safe_load(f)
    got = C._load_yaml(path)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


def test_config_reader_scalars_and_errors(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("# head\na: 3  # tail\nb: -0.5\nc: true\nd: False\n"
                 "e: /x/y#z\nf: 'q # r'\ng: ~\nh: 1.\n")
    assert C._load_yaml(str(p)) == {"a": 3, "b": -0.5, "c": True, "d": False,
                                    "e": "/x/y#z", "f": "q # r", "g": None,
                                    "h": 1.0}
    p.write_text("a: 1\n  nested: 2\n")
    with pytest.raises(ValueError, match="key: value"):
        C._load_yaml(str(p))


def test_package_imports_without_pyyaml():
    code = ("import sys; sys.modules['yaml'] = None; import la3dm_tpu; "
            "from la3dm_tpu.utils.config import load_method_config; "
            "print(load_method_config('bgklvoctomap_large_map').block_depth)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "6"


# ------------------------------------------------------ fallback accounting


def test_host_fallback_chunks_are_counted(monkeypatch):
    """Chunks device ingestion cannot bound or fit go to the host path and
    are counted next to host_s (chip_smoke.py fails on a non-zero count)."""
    rng = np.random.default_rng(2)
    cloud, origin = synthetic_scan(rng, n=40)
    monkeypatch.setattr(device_ingest, "_SPEC_PADS", {})  # fresh dim ladder
    m = BGKOctoMap(dataclasses.replace(CFG, device_ingest="on"))
    m.insert_pointcloud(cloud, origin, max_range=-1.0)   # unbounded: host
    assert m.stats["host_fallback_chunks"] == 1
    # past the ladder caps: the overflowing chunk takes the host path
    real = device_ingest.spec_for
    monkeypatch.setattr(device_ingest, "spec_for", lambda *a: dataclasses.replace(
        real(*a), T=8, Bu=8))
    monkeypatch.setattr(BGKOctoMap, "_DIM_CAPS",
                        dict(BGKOctoMap._DIM_CAPS, T=8, Bu=8))
    m2 = BGKOctoMap(dataclasses.replace(CFG, device_ingest="on"))
    m2.insert_pointcloud(cloud, origin, max_range=6.0)
    assert m2.stats["host_fallback_chunks"] == 1
    assert m2.pool.n_blocks > 0


def test_pool_nbytes_counts_all_state():
    m = BGKOctoMap(CFG)
    p = m.pool
    assert p.nbytes == p.capacity * p.V * (4 + 4 + 1 + 1)


# ------------------------------------------------------------------- bench


def test_bench_peaks_are_keyed_by_device_kind():
    sys.path.insert(0, REPO)
    import bench

    assert bench.device_peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


def test_bench_card_line_without_nvidia_smi(monkeypatch):
    """With no nvidia-smi on PATH the bench records no card, and raises
    nothing."""
    sys.path.insert(0, REPO)
    import bench

    monkeypatch.setenv("PATH", "/nonexistent")
    assert bench.card_line() is None


# -------------------------------------------------------------- chip_smoke


def test_chip_smoke_refuses_the_cpu(tmp_path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                        "--out", str(tmp_path)],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_trace_reduction(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke._union_ns([(0, 10), (5, 20), (30, 40), (35, 36)]) == 30
    assert chip_smoke._union_ns([]) == 0
    jax.profiler.start_trace(str(tmp_path))
    x = jnp.ones((64, 64))
    (x @ x).block_until_ready()
    jax.profiler.stop_trace()
    t = chip_smoke.trace_summary(str(tmp_path))
    assert t["window_ns"] > 0
    # a CPU trace has no device plane: nothing busy, no device ops
    assert t["busy_ns"] == 0 and t["tops"] == []
