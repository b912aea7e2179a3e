"""Auxiliary-subsystem tests: mixed precision, residual history CSV,
phantom purge gate, profiler hook, env-var config overrides."""

import os

import numpy as np
import pytest

import chase_tpu
from chase_tpu.models import clement, clement_eigenvalues, random_pseudo_hermitian


def test_mixed_precision_filter_converges():
    """DP problem with the SP-filter path (P10): must still reach DP tol,
    and the reduced-precision shadow of H must actually have been built."""
    N, nev, nex = 256, 16, 12
    H = clement(N)
    op = chase_tpu.DenseOperator(H)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True, tol=1e-9)
    res = chase_tpu.solve(op, nev, nex, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-6)
    assert op._H_low is not None, "mixed precision path never engaged"
    assert op.H_low.dtype == np.float32


def test_mixed_precision_f32_ladder():
    """32-bit problems: the low phase drops matmul precision, convergence to
    SP tolerance must be unaffected."""
    N, nev, nex = 200, 12, 10
    H = clement(N).astype(np.float32)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True, tol=1e-4)
    res = chase_tpu.eigsh(H, nev, nex, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=5e-2)


def test_save_residuals_csv(tmp_path):
    p = str(tmp_path / "resid.csv")
    cfg = chase_tpu.ChaseConfig(save_residuals=p)
    res = chase_tpu.eigsh(clement(128), 8, 8, tol=1e-9, config=cfg)
    assert res.converged
    lines = open(p).read().strip().splitlines()
    assert lines[0] == "iteration,residual"
    assert len(lines) == 1 + res.iterations * 16   # 16 rows per iteration
    its = [int(l.split(",")[0]) for l in lines[1:]]
    assert max(its) == res.iterations - 1
    for l in lines[1:]:
        float(l.split(",")[1])                      # every row parses


def test_save_residuals_env_override(tmp_path):
    p = str(tmp_path / "resid_env.csv")
    os.environ["CHASE_SAVE_RESIDUALS"] = p
    try:
        chase_tpu.eigsh(clement(96), 6, 6, tol=1e-8)
    finally:
        del os.environ["CHASE_SAVE_RESIDUALS"]
    assert os.path.exists(p)


def test_phantom_purge_gate_runs():
    H = random_pseudo_hermitian(120, dtype=np.float64, seed=8)
    cfg = chase_tpu.ChaseConfig(phantom_purge=True, tol=1e-9)
    res = chase_tpu.eigsh_pseudo(H, 6, 6, config=cfg)
    assert res.converged


def test_profiler_trace(tmp_path):
    from chase_tpu.perf import profiler_trace
    d = str(tmp_path / "trace")
    with profiler_trace(d):
        chase_tpu.eigsh(clement(64), 4, 4, tol=1e-6)
    found = []
    for root, _, files in os.walk(d):
        found.extend(files)
    assert found, "profiler trace produced no files"


def test_env_cholqr_disable():
    os.environ["CHASE_DISABLE_CHOLQR"] = "1"
    try:
        res = chase_tpu.eigsh(clement(96), 6, 6, tol=1e-9)
    finally:
        del os.environ["CHASE_DISABLE_CHOLQR"]
    assert res.converged


def test_multihost_helpers_single_process():
    """Single-process behavior of the pod helpers (the multi-process path
    needs a real pod; SURVEY known gap)."""
    from chase_tpu.parallel import multihost
    assert not multihost.is_multihost()
    info = multihost.process_info()
    assert info["process_count"] == 1 and info["global_devices"] == 8
    grid = multihost.init_grid()
    assert grid.nprocs == 8


def test_logger_level_and_category_filters(capsys):
    import importlib
    import os
    import chase_tpu.logger as L
    os.environ["CHASE_LOG_LEVEL"] = "info"
    os.environ["CHASE_LOG_CATEGORIES"] = "linalg"
    try:
        importlib.reload(L)
        log = L.get_logger()
        log.info("visible-linalg", "linalg")
        log.info("hidden-interface", "interface")
        log.debug("hidden-debug", "linalg")
        out = capsys.readouterr()
        text = out.out + out.err
        assert "visible-linalg" in text
        assert "hidden-interface" not in text
        assert "hidden-debug" not in text
    finally:
        del os.environ["CHASE_LOG_LEVEL"]
        del os.environ["CHASE_LOG_CATEGORIES"]
        importlib.reload(L)


def test_eigh_polish_defaults_and_env(monkeypatch):
    """polish_passes(): 0 by default for SP and DP (LAPACK/cuSOLVER eigh
    vectors need no polish, and the polish costs DP orthogonality);
    eigh_polish and CHASE_EIGH_POLISH force a value."""
    import numpy as np
    import chase_tpu

    cfg = chase_tpu.ChaseConfig()
    r32 = cfg.resolve(np.dtype(np.float32))
    r64 = cfg.resolve(np.dtype(np.float64))
    assert r32.polish_passes() == 0 and r64.polish_passes() == 0
    rc = cfg.resolve(np.dtype(np.complex128))
    assert rc.polish_passes() == 0
    r2 = chase_tpu.ChaseConfig(eigh_polish=2).resolve(np.dtype(np.float64))
    assert r2.polish_passes() == 2
    monkeypatch.setenv("CHASE_EIGH_POLISH", "1")
    r = chase_tpu.ChaseConfig().resolve(np.dtype(np.float32))
    assert r.polish_passes() == 1
    monkeypatch.delenv("CHASE_EIGH_POLISH")
    r0 = chase_tpu.ChaseConfig(eigh_polish=0).resolve(np.dtype(np.float64))
    assert r0.polish_passes() == 0


def test_eigh_polish_zero_still_converges_sp():
    """A forced polish=0 Hermitian solve at SP tolerance must still work
    (the polish only matters near the backend-eigh vector floor)."""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    H = clement(256).astype(np.float32)
    res = chase_tpu.eigsh(H, 16, 12, tol=1e-3,
                          config=chase_tpu.ChaseConfig(eigh_polish=0))
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(256)[:16],
                               atol=1e-1)


def test_warmup_precompiles_and_solve_matches():
    """warmup() compiles the width-bucket programs best-effort (0 failures
    on CPU) and a subsequent solve converges to the exact spectrum."""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    N, nev, nex = 192, 12, 12
    op = chase_tpu.DenseOperator(clement(N))
    cfg = chase_tpu.ChaseConfig(col_block=8)
    info = chase_tpu.warmup(op, nev, nex, config=cfg)
    assert info["failed"] == 0
    assert info["widths"][0] == nev + nex       # full width present
    assert len(info["widths"]) >= 2             # shrunk buckets present
    res = chase_tpu.eigsh(op, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-7)


def test_warmup_memory_capped_workers(monkeypatch):
    """The warmup pool shrinks with problem size so concurrent job
    transients fit device memory: full width for small problems, fewer for
    an N=30000 problem on a 17 GB device, 1 once wide-f64 slices fill it,
    and no cap at that size with an H100's 63.76 GB limit."""
    import sys
    import numpy as np
    import chase_tpu
    from chase_tpu.warmup import _mem_capped_workers
    warmup_mod = sys.modules["chase_tpu.warmup"]

    op = chase_tpu.DenseOperator(np.eye(64, dtype=np.float32))
    assert _mem_capped_workers(8, op, 24, 16) == 8

    class FakeOp:
        N = 30000
        grid = None
        dtype = np.float32
        _H_wide = None

    class FakeWide(FakeOp):
        _H_wide = object()

    monkeypatch.setattr(warmup_mod, "memory_bytes", lambda: 17e9)
    assert _mem_capped_workers(8, FakeOp(), 3000, 3000) < 8
    assert _mem_capped_workers(8, FakeWide(), 3000, 3000) == 1
    monkeypatch.setattr(warmup_mod, "memory_bytes", lambda: 63.76e9)
    assert _mem_capped_workers(8, FakeWide(), 3000, 3000) == 8


def test_warmup_mixed_precision_paths():
    """warmup with the DP mixed-precision ladder warms the low/refine
    programs too, without failures."""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import clement

    op = chase_tpu.DenseOperator(clement(128).astype(np.float64))
    cfg = chase_tpu.ChaseConfig(mixed_precision=True, col_block=8)
    info = chase_tpu.warmup(op, 8, 8, config=cfg)
    assert info["failed"] == 0


def test_warmup_on_grid():
    """warmup on a device grid compiles the sharded programs (dummy block
    carries the canonical V sharding) and the grid solve then matches."""
    import jax
    import numpy as np
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    grid = chase_tpu.make_grid(jax.devices(), shape=(4, 2))
    op = chase_tpu.DenseOperator(clement(192), grid=grid)
    cfg = chase_tpu.ChaseConfig(col_block=8)
    info = chase_tpu.warmup(op, 10, 10, config=cfg)
    assert info["failed"] == 0
    res = chase_tpu.eigsh(op, 10, 10, tol=1e-10, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(192)[:10],
                               atol=1e-7)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_small_dense_auto_default_policy(monkeypatch, platform):
    """Out of the box small_dense_backend is 'auto' and resolves to the
    device eigensolver and QR on every supported platform; explicit
    settings pass through untouched for both phases."""
    import jax
    from chase_tpu import ChaseConfig
    from chase_tpu.solver import resolve_small_dense

    assert ChaseConfig().small_dense_backend == "auto"
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert resolve_small_dense("auto") == ("device", "device")
    assert resolve_small_dense("host") == ("host", "host")
    assert resolve_small_dense("device") == ("device", "device")


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_mixed_precision_auto_default_policy(monkeypatch, platform):
    """Out of the box mixed_precision is None = auto, which resolves to the
    native f64 filter on every supported platform; True/False/env force
    the DP ladder on or off."""
    import jax
    from chase_tpu import ChaseConfig

    assert ChaseConfig().mixed_precision is None
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    for dt in (np.float64, np.complex128, np.float32):
        assert ChaseConfig().resolve(dt).mixed_precision is False
    assert ChaseConfig(
        mixed_precision=True).resolve(np.float64).mixed_precision is True
    assert ChaseConfig(
        mixed_precision=False).resolve(np.float64).mixed_precision is False
    monkeypatch.setenv("CHASE_MIXED_PRECISION", "1")
    assert ChaseConfig().resolve(np.float64).mixed_precision is True
    monkeypatch.setenv("CHASE_MIXED_PRECISION", "0")
    assert ChaseConfig(
        mixed_precision=True).resolve(np.float64).mixed_precision is False


def test_perf_fraction_of_peak(monkeypatch):
    """perf.filter_mfu: the filter rate as a fraction of the published peak
    of the rung it ran in — H100 data-sheet peaks from device.PEAKS, and
    "peak not known for <kind>" (never an assumed rate) elsewhere."""
    import chase_tpu.device as device
    from chase_tpu.perf import PerfData

    p = PerfData()
    for ph in ("All", "Lanczos", "Filter", "Qr", "Rr", "Resids_Locking"):
        p.add_time(ph, 0.1)
    p.add_iter_blocksize(32)
    p.add_filtered_vecs(100, rung="fp64")
    # the CPU is not in the peak table
    assert p.filter_mfu(256, np.float64) == "peak not known for cpu"
    assert "peak not known for cpu" in p.report(256, 25, 4, np.float64)

    h100 = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(device, "identity", lambda: {
        "platform": "gpu", "kind": h100, "count": 1})
    frac, rung, peak_g = p.filter_mfu(4096, np.float64)
    assert rung == "fp64" and peak_g == 67e3
    eff = p.get_filter_flops(4096, np.float64) / 0.1
    assert abs(frac - eff / 67e3) < 1e-12
    assert "of the fp64 peak" in p.report(4096, 25, 4, np.float64)
    # the peak is the one of the rung MOST filter columns recorded
    p.add_filtered_vecs(200, rung="tf32", low=True)
    assert p.filter_mfu(4096, np.float32)[1:] == ("tf32", 495e3)
    p.add_filtered_vecs(300, rung="bf16", low=True)
    assert p.filter_mfu(4096, np.float32)[1:] == ("bf16", 989e3)
    # no filter column recorded: no fraction
    assert PerfData().filter_mfu(4096, np.float32) is None
    monkeypatch.setattr(device, "identity", lambda: {
        "platform": "gpu", "kind": "NVIDIA A100-SXM4-80GB", "count": 1})
    assert p.filter_mfu(4096, np.float32) == \
        "peak not known for NVIDIA A100-SXM4-80GB"


def test_eigh_polished_pin_cut_active_gap_floor():
    """With locked slots pinned to a huge diagonal value, the polish's
    cluster gap floor must come from the ACTIVE spectrum (pin_cut), not the
    pinned magnitude — otherwise gaps in [sqrt(eps)*|A|, 2*sqrt(k)*sqrt(eps)
    *|A|] are misclassified as clusters and never get the rotation
    correction."""
    import numpy as np
    import jax.numpy as jnp
    from chase_tpu.ops.rr import eigh_polished

    rng = np.random.default_rng(7)
    k, n_lock = 40, 8
    # active spectrum with a gap ~2e-7 (above sqrt(eps_f64)*|A| ~ 1.5e-8,
    # below the pinned-inflated floor ~ sqrt(2k)*that)
    lam = np.linspace(-1.0, 1.0, k - n_lock)
    lam[10] = lam[9] + 2e-7
    Qb, _ = np.linalg.qr(rng.standard_normal((k - n_lock, k - n_lock)))
    A_act = (Qb * lam) @ Qb.T
    big = 2 * np.linalg.norm(A_act) + 1
    A = np.zeros((k, k))
    A[: k - n_lock, : k - n_lock] = A_act
    A[np.arange(k - n_lock, k), np.arange(k - n_lock, k)] = big

    def max_resid(w, Z):
        R = A @ np.asarray(Z) - np.asarray(Z) * np.asarray(w)[None, :]
        act = np.asarray(w) < big / 2
        return float(np.abs(R[:, act]).max())

    w_cut, Z_cut = eigh_polished(jnp.asarray(A), passes=2, pin_cut=big / 2)
    assert max_resid(w_cut, Z_cut) < 5e-9


def test_warmup_fused_and_aux_jobs():
    """warmup(fused=True) compiles the fused cold+warm programs and the
    auxiliary programs (sym-check, permutes, DoS head injection) without
    failures; the subsequent fused solve reuses the cache and matches."""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    N = 96
    op = chase_tpu.DenseOperator(clement(N))
    cfg = chase_tpu.ChaseConfig(col_block=8)
    info = chase_tpu.warmup(op, 8, 8, config=cfg, fused=True)
    assert info["failed"] == 0
    res = chase_tpu.eigsh_fused(op, 8, 8, tol=1e-5, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:8],
                               atol=1e-4)


def test_sequence_auto_warmup():
    """eigsh_sequence warms up before member 0 by default and still
    produces warm-started members."""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import hermitian_sequence

    mats = hermitian_sequence(96, 3, dtype=np.float64, drift=1e-3, seed=0)
    results = list(chase_tpu.eigsh_sequence(
        mats, 6, 6, tol=1e-5, config=chase_tpu.ChaseConfig(col_block=8)))
    assert all(r.converged for r in results)
    assert results[1].iterations <= results[0].iterations


def test_warmup_pseudo():
    """warmup on a pseudo-Hermitian operator compiles the BSE phase
    programs (H2 filter buckets, S-QR, pencil RR, S-Lanczos) without
    failures, and the solve then matches the direct spectrum."""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import random_pseudo_hermitian

    N, nev, nex = 96, 6, 6
    H = np.asarray(random_pseudo_hermitian(N, dtype=np.float64, seed=5))
    op = chase_tpu.DenseOperator(H, pseudo_hermitian=True)
    info = chase_tpu.warmup(op, nev, nex,
                            config=chase_tpu.ChaseConfig(col_block=4))
    assert info["failed"] == 0
    res = chase_tpu.eigsh_pseudo(op, nev, nex, tol=1e-9,
                                 config=chase_tpu.ChaseConfig(col_block=4))
    assert res.converged
    full = np.sort(np.linalg.eigvals(H).real)
    np.testing.assert_allclose(np.asarray(res.ritzv),
                               full[full > 0][:nev], atol=1e-7)
