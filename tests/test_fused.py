"""Device-resident fused solver tests: must match the host-driven solver."""

import numpy as np
import pytest

import chase_tpu
from chase_tpu.models import clement, clement_eigenvalues, random_hermitian


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_fused_matches_exact_spectrum(dtype):
    dtype = np.dtype(dtype)
    N, nev, nex = 256, 24, 16
    if np.issubdtype(dtype, np.complexfloating):
        H = random_hermitian(N, dtype=dtype, seed=9)
        exact = np.linalg.eigvalsh(H)[:nev]
    else:
        H = clement(N).astype(dtype)
        exact = clement_eigenvalues(N)[:nev]
    res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, exact, atol=1e-7)
    V = np.asarray(res.V)[:, :nev]
    R = H @ V - V * res.ritzv[None, :].astype(V.dtype)
    assert np.linalg.norm(R, axis=0).max() < 1e-8 * N


@pytest.mark.quick
def test_fused_agrees_with_host_driver():
    N, nev, nex = 200, 16, 12
    H = random_hermitian(N, dtype=np.float64, seed=13)
    a = chase_tpu.eigsh(H, nev, nex, tol=1e-10)
    b = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-10)
    assert a.converged and b.converged
    np.testing.assert_allclose(a.ritzv, b.ritzv, atol=1e-8)


def test_fused_single_dispatch_f32():
    N, nev, nex = 192, 12, 12
    H = clement(N).astype(np.float32)
    res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-4)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-1)


def test_fused_on_grid():
    import jax
    N, nev, nex = 128, 8, 8
    grid = chase_tpu.make_grid(jax.devices()[:4], shape=(2, 2))
    H = clement(N)
    res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-9, grid=grid)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-6)


def test_fused_bf16_rung():
    """Fused solver with the bf16 storage rung: f32 problem converges and
    matches the exact spectrum at SP accuracy."""
    N, nev, nex = 192, 12, 12
    H = clement(N).astype(np.float32)
    cfg = chase_tpu.ChaseConfig(bf16_filter=True)
    res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-4, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-1)


def test_fused_perf_and_residual_history(tmp_path):
    """In-graph observability: FLOP counters + CHASE_SAVE_RESIDUALS parity
    for the single-dispatch solver."""
    N, nev, nex = 128, 8, 8
    H = clement(N)
    csv = str(tmp_path / "hist.csv")
    cfg = chase_tpu.ChaseConfig(save_residuals=csv)
    res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-9, config=cfg,
                                collect_perf=True)
    assert res.converged
    assert res.perf is not None
    assert res.perf.filtered_vecs > 0
    assert res.perf.iter_count == res.iterations
    assert len(res.perf.iter_blocksizes) == res.iterations
    # FLOP model produces a positive GFLOPS(all)
    assert res.perf.get_flops(N, 25, 4, H.dtype) > 0
    lines = open(csv).read().strip().splitlines()
    assert lines[0] == "iteration,residual"
    assert len(lines) == 1 + res.iterations * (nev + nex)
    # final iteration contains residuals at/below the converged scale
    import numpy as _np
    last = _np.array([float(l.split(",")[1]) for l in lines[1:]
                      if l.startswith(f"{res.iterations-1},")])
    active_last = last[last >= 0]
    assert active_last.min() < 1e-8 * N


def test_fused_largest_mode():
    N, nev = 200, 10
    res = chase_tpu.eigsh_fused(clement(N), nev, 10, tol=1e-9, largest=True)
    assert res.converged
    exact = clement_eigenvalues(N)[-nev:]       # top end, ascending
    np.testing.assert_allclose(res.ritzv, exact, atol=1e-6)


def test_fused_warm_start_converges_faster():
    """v0 warm start (inject_dos=False — the mode='A' analogue): a second
    solve of a correlated problem from the previous eigenvectors must not
    clobber them with DoS vectors and should converge in fewer iterations."""
    from chase_tpu.models import hermitian_sequence
    H1, H2 = hermitian_sequence(256, 2, dtype=np.float64, seed=4)
    r1 = chase_tpu.eigsh_fused(H1, 16, 16, tol=1e-9)
    assert r1.converged
    cold = chase_tpu.eigsh_fused(H2, 16, 16, tol=1e-9)
    warm = chase_tpu.eigsh_fused(H2, 16, 16, tol=1e-9, v0=np.asarray(r1.V))
    assert warm.converged
    assert warm.iterations <= cold.iterations
    exact = np.linalg.eigvalsh(np.asarray(H2, np.float64))[:16]
    np.testing.assert_allclose(warm.ritzv, exact, atol=1e-6)


def test_fused_host_small_dense():
    """pure_callback host eigh inside the fused while loop (CPU backend
    supports host callbacks; some PJRT backends don't — 'auto' guards)."""
    N, nev, nex = 160, 8, 8
    cfg = chase_tpu.ChaseConfig(small_dense_backend="host")
    res = chase_tpu.eigsh_fused(clement(N), nev, nex, tol=1e-9, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-6)


def test_fused_warm_start_survives_spectral_drift():
    """Regression (found by the sequence benchmark): warm-started solves
    must re-estimate bounds from FRESH random Lanczos probes.  Probing
    with the previous eigenvectors underestimates the drifted spectral
    top and the filter then amplifies the unwanted end — members 4+ of a
    10-long drifting sequence diverged (residuals ~40)."""
    N, nev, nex = 200, 10, 10
    rng = np.random.default_rng(7)
    H = np.asarray(random_hermitian(N, dtype=np.float64, seed=7))
    v0 = None
    for i in range(8):
        if i:
            E = rng.standard_normal((N, N))
            H = H + (2e-3 / np.sqrt(N)) * (E + E.T)
        res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-8, v0=v0)
        assert res.converged, f"member {i} diverged"
        exact = np.linalg.eigvalsh(H)[:nev]
        np.testing.assert_allclose(res.ritzv, exact, atol=1e-5,
                                   err_msg=f"member {i}")
        v0 = np.asarray(res.V)


def test_fused_early_lock_reporting():
    """Stagnation-locked residuals surface in result.early_locked (the
    reference perf table's early-lock statistics)."""
    # tol just below the f32 floor: pairs stagnate inside 100*tol and
    # early-lock instead of converging outright
    N, nev, nex = 160, 8, 8
    H = clement(N).astype(np.float32)
    res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-5)
    assert res.converged
    assert res.early_locked is not None and len(res.early_locked) > 0
    assert all(r > 1e-5 for r in res.early_locked)


def test_fused_tiny_block_smaller_than_num_lanczos():
    """Regression: nev+nex < num_lanczos must not crash the probe scan."""
    N = 64
    res = chase_tpu.eigsh_fused(clement(N), 2, 1, tol=1e-9)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:2],
                               atol=1e-7)


@pytest.mark.quick
def test_fused_refine_ladder_dp():
    """Fused DP 1e-10 solve with the in-graph refinement ladder: the filter
    FLOPs stay in f32 (deviation recurrence) while true residuals reach
    the DP tolerance — mirrors test_ladder for the serving path (reference
    runtime-tolerance serving parity,
    chase_c_interface.h:38-41)."""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import clement

    N, nev, nex = 256, 24, 16
    rng = np.random.default_rng(0)
    E = rng.standard_normal((N, N))
    H = (clement(N) + 1e-6 * (E + E.T) / 2).astype(np.float64)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True)
    res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    V = np.asarray(res.V)[:, :nev]
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 5e-9
    exact = np.linalg.eigvalsh(H)[:nev]
    np.testing.assert_allclose(res.ritzv, exact, atol=1e-9)
    # parity: same tolerance WITHOUT the ladder (pure f64 filter)
    res_f64 = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-10,
                                    config=chase_tpu.ChaseConfig())
    assert abs(res.iterations - res_f64.iterations) <= 2


@pytest.mark.parametrize("entry", ["eigsh_fused", "eigsh_pseudo_fused"])
def test_fused_compile_failure_falls_back_to_host(monkeypatch, entry):
    """A runtime or compile error in the one-dispatch program propagates
    to the caller (an out-of-memory error must not look like a success):
    eigsh_fused and eigsh_pseudo_fused no longer re-solve through the host
    driver behind the caller's back."""
    import jax
    import chase_tpu.fused as fused_mod
    import chase_tpu.fused_pseudo as fused_pseudo_mod
    from chase_tpu.models import random_pseudo_hermitian

    def boom(*a, **k):
        raise jax.errors.JaxRuntimeError("simulated RESOURCE_EXHAUSTED")

    monkeypatch.setattr(fused_mod, "solve_fused", boom)
    monkeypatch.setattr(fused_pseudo_mod, "solve_pseudo_fused", boom)
    if entry == "eigsh_fused":
        H = clement(192).astype(np.float64)
    else:
        H = np.asarray(random_pseudo_hermitian(64, dtype=np.float64, seed=1))
    with pytest.raises(jax.errors.JaxRuntimeError, match="RESOURCE"):
        getattr(chase_tpu, entry)(H, 8, 8, tol=1e-10)


@pytest.mark.quick
def test_fused_phase_tiers_match_full_width():
    """phase_tiers>1 (static in-graph phase windows, the fused P12) must
    converge to the same spectrum as the classic full-width body, while
    actually spanning several tiers as columns lock."""
    import jax
    import jax.numpy as jnp
    from chase_tpu.fused import solve_fused, _tier_offsets

    N, nev, nex = 200, 24, 8
    k = nev + nex
    assert _tier_offsets(k, 4) == [0, 8, 16, 24]
    assert _tier_offsets(k, 1) == [0]
    H = jnp.asarray(clement(N), jnp.float64)
    V0 = jax.random.normal(jax.random.key(0), (N, k), dtype=jnp.float64)
    exact = clement_eigenvalues(N)[:nev]
    ritz = {}
    for tiers in (1, 4):
        out = solve_fused(H, jnp.array(V0, copy=True), nev=nev, nex=nex,
                          tol=1e-10, deg0=20, max_deg=36,
                          phase_tiers=tiers)
        assert int(out["locked"]) >= nev, tiers
        ritz[tiers] = np.asarray(out["ritzv"])[:nev]
        np.testing.assert_allclose(ritz[tiers], exact, atol=1e-8)
        # true residuals of the tiered result against the exact operator
        V = np.asarray(out["V"])[:, :nev]
        R = np.asarray(H) @ V - V * ritz[tiers][None, :]
        assert np.linalg.norm(R, axis=0).max() < 1e-8
    np.testing.assert_allclose(ritz[1], ritz[4], atol=1e-9)


def test_fused_wide_rr_dp_no_f64_dots():
    """wide_rr mode: the one-dispatch DP program must converge to 1e-10
    with NO f64 dot/eigh/cholesky in the lowered HLO (every
    full-precision contraction on the int8-slice GEMM, factorizations in
    f32 + wide Newton-Schulz / OA polish) — the one-dispatch program with
    no f64 dot in the graph (wide_f64='on')."""
    import re
    import jax
    import jax.numpy as jnp
    from chase_tpu.fused import solve_fused
    from chase_tpu.ops.wide import presplit_and_shadow

    N, nev, nex = 256, 20, 12
    H = jnp.asarray(clement(N), jnp.float64)
    slices, sa, low, s, L = presplit_and_shadow(H, scheme="i8")
    V0 = jax.random.normal(jax.random.key(0), (N, nev + nex),
                           dtype=jnp.float64)

    kwargs = dict(nev=nev, nex=nex, tol=1e-10, deg0=20, max_deg=36,
                  H_wide=(slices, sa), wide_rr=True, wide_s=s, wide_L=L,
                  refine_filter=True)
    lowered = solve_fused.lower(low, V0, **kwargs)
    hlo = lowered.as_text()
    bad = [ln.strip() for ln in hlo.splitlines()
           if re.search(r"(dot_general|dot\()", ln)
           and "f64" in ln.split("=", 1)[0]]
    assert not bad, f"f64 contractions in the wide_rr graph:\n" + \
        "\n".join(bad[:8])
    # no f64 eigh / cholesky custom calls either
    for op in ("Eigh", "cholesky", "potrf", "syevd"):
        for ln in hlo.splitlines():
            if op.lower() in ln.lower() and "f64" in ln.split("=", 1)[0]:
                raise AssertionError(f"f64 {op} in wide_rr graph: "
                                     f"{ln.strip()[:160]}")

    out = solve_fused(low, V0, **kwargs)
    assert int(out["locked"]) >= nev
    ritz = np.asarray(out["ritzv"])[:nev]
    exact = clement_eigenvalues(N)[:nev]
    np.testing.assert_allclose(ritz, exact, atol=1e-9)
    V = np.asarray(out["V"])[:, :nev]
    R = np.asarray(H) @ V - V * ritz[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-9
