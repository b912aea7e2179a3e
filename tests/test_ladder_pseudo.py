"""DP-tolerance (1e-10) mixed-precision ladder tests for the pseudo (BSE)
path.

The reference's default DP tolerance is 1e-10 and applies to Solve_pseudo
too (algorithm/configuration.hpp:53-62; algorithm.inc:1834-2220); its
mixed-precision mode hands the H² filter back to the problem dtype below
resid 1e-3 — on an accelerator that is the emulated-f64 path.  chase_tpu
instead keeps the H² recurrence in the fast dtype forever via the
deviation-form refinement (ops/pseudo.chebyshev_filter_refine_h2), seeded
by f64 H²-residuals r2 = (H + θ)·r built from the pencil-RR residual
vectors.  These tests assert 1e-10 BSE convergence with >=80% of the FLOPs
in reduced precision, the exact algebraic equivalence of the deviation
form, the ring-schedule variants on 1D/2D grids, and the wide-f64 pseudo
RR/QR path.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import chase_tpu
from chase_tpu.models import random_pseudo_hermitian
from chase_tpu.ops import filter as filt
from chase_tpu.ops import pseudo as ps


def _true_pseudo_residuals(H, res, nev):
    V = np.asarray(res.V)[:, :nev]
    R = H.astype(V.dtype) @ V - V * res.ritzv[None, :].astype(V.dtype)
    return np.linalg.norm(R, axis=0)


@pytest.mark.quick
def test_refine_h2_algebraic_equivalence():
    """Deviation form on H² must reproduce the direct H² filter exactly in
    f64 (same polynomial, differently factored)."""
    rng = np.random.default_rng(3)
    N, w = 128, 8
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=3)
    V = rng.standard_normal((N, w))
    V /= np.linalg.norm(V, axis=0)
    theta = rng.uniform(0.5, 3.0, w)              # arbitrary expansion points
    H2V = H @ (H @ V)
    R2 = H2V - V * (theta ** 2)[None, :]
    degrees = np.array([4, 6, 8, 8, 10, 12, 0, 8], np.int32)
    lam1, lo, up = 0.8, 3.0, 30.0                 # H²-space interval
    a1e, al, be, inj, pf = filt.refine_tables(theta ** 2, degrees, lam1,
                                              lo, up, 36)
    Yr = ps.chebyshev_filter_refine_h2(
        jnp.asarray(H), jnp.asarray(V), jnp.asarray(R2),
        jnp.asarray(degrees), a1e, al, be, inj, pf, (up + lo) / 2.0,
        int(degrees.max()), precision="highest")
    Yd = ps.chebyshev_filter_h2(
        jnp.asarray(H), jnp.asarray(V), jnp.asarray(degrees), lam1, lo, up,
        int(degrees.max()), precision="highest")
    nrm = np.linalg.norm(np.asarray(Yd), axis=0)
    err = np.abs(np.asarray(Yd) - np.asarray(Yr)).max(axis=0)
    assert (err / np.maximum(nrm, 1e-30)).max() < 1e-12
    np.testing.assert_array_equal(np.asarray(Yr)[:, 6], V[:, 6])


def test_h2_residual_factorization():
    """r2 = (H + θ)·r must equal H²v − θ²v when r = Hv − θv."""
    rng = np.random.default_rng(5)
    N, w = 96, 5
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=5)
    V = rng.standard_normal((N, w))
    theta = rng.uniform(0.5, 2.0, w)
    R = H @ V - V * theta[None, :]
    R2 = np.asarray(ps.h2_residual(jnp.asarray(H), jnp.asarray(R),
                                   jnp.asarray(theta)))
    R2_direct = H @ (H @ V) - V * (theta ** 2)[None, :]
    np.testing.assert_allclose(R2, R2_direct, atol=1e-10)


def test_pseudo_ladder_reaches_1e10_with_low_precision_flops():
    """tol=1e-10 BSE solve with mixed_precision: converges with >=80% of
    the analytic FLOPs in f32 (the deviation-form H² refinement)."""
    N, nev, nex = 256, 24, 16
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=11)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True)
    res = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10, config=cfg,
                                 collect_perf=True)
    assert res.converged
    assert res.resid.max() <= 1e-9
    tr = _true_pseudo_residuals(H, res, nev)
    assert tr.max() < 5e-9
    ev = np.linalg.eigvals(H)
    exact = np.sort(ev.real[ev.real > 0])[:nev]
    np.testing.assert_allclose(res.ritzv, exact, atol=1e-8)
    rcfg = cfg.resolve(np.dtype(np.float64))
    frac = res.perf.low_flop_fraction(N, rcfg.lanczos_iter, 4, np.float64)
    assert frac >= 0.80, f"only {frac:.0%} of FLOPs were low-precision"


def test_pseudo_ladder_matches_pure_f64_iterations():
    """The H² refinement ladder must not pay recovery iterations."""
    N, nev, nex = 256, 24, 16
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=13)
    r64 = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10)
    rlad = chase_tpu.eigsh_pseudo(
        H, nev, nex, tol=1e-10,
        config=chase_tpu.ChaseConfig(mixed_precision=True))
    assert r64.converged and rlad.converged
    assert rlad.iterations <= r64.iterations + 1


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)], ids=["ring1d", "ring2d"])
def test_pseudo_ladder_on_grid(shape):
    """The BSE DP ladder composes with the H² ring schedules (the refine
    recurrence runs as the ring collective matmul on eligible grids)."""
    N, nev, nex = 256, 16, 8
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=17)
    grid = chase_tpu.make_grid(jax.devices(), shape=shape)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True)
    res = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10, config=cfg,
                                 grid=grid)
    assert res.converged
    tr = _true_pseudo_residuals(H, res, nev)
    assert tr.max() < 5e-9
    r0 = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10, config=cfg)
    np.testing.assert_allclose(res.ritzv, r0.ritzv, atol=1e-9)


def test_pseudo_wide_rr_qr():
    """wide_f64='on': the pencil RR + S-QR run on the exact-bf16 slice GEMM
    and still deliver the 1e-10 BSE solve (CPU check of the on-chip path)."""
    N, nev, nex = 192, 12, 8
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=19)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True, wide_f64="on")
    res = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    tr = _true_pseudo_residuals(H, res, nev)
    assert tr.max() < 5e-9
    ev = np.linalg.eigvals(H)
    exact = np.sort(ev.real[ev.real > 0])[:nev]
    np.testing.assert_allclose(res.ritzv, exact, atol=1e-8)


def test_pseudo_ladder_complex128_real_pair():
    """z-dtype BSE at 1e-10 through the real-pair embedding × the H² ladder
    (the composition the accelerator serves)."""
    N, nev, nex = 128, 10, 6
    H = random_pseudo_hermitian(N, dtype=np.complex128, seed=23)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True,
                                complex_backend="real_pair")
    res = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    V = np.asarray(res.V)[:, :nev]
    R = H @ V - V * res.ritzv[None, :].astype(V.dtype)
    assert np.linalg.norm(R, axis=0).max() < 5e-9
    ev = np.linalg.eigvals(H)
    exact = np.sort(ev.real[ev.real > 0])[:nev]
    np.testing.assert_allclose(res.ritzv, exact, atol=1e-8)


@pytest.mark.quick
def test_iter0_degree_cap_math():
    """The iteration-0 H² degree cap: rho1^cap must stay ~within the
    1e6 dynamic-range budget, even + >=8, and a no-op when the filter
    interval gives no amplification headroom."""
    from chase_tpu.solver_pseudo import _iter0_degree_cap
    from chase_tpu.solver import _rho

    lam1, lower, b_sup = 1.0, 25.0, 400.0
    cap = _iter0_degree_cap(lam1, lower, b_sup, 36)
    assert 8 <= cap <= 36 and cap % 2 == 0
    rho1 = _rho((lam1 - (b_sup + lower) / 2) / ((b_sup - lower) / 2))
    assert rho1 ** cap <= 1e6 * rho1 ** 2        # within an even step
    # cap respects deg0 when amplification is mild (μ₁ barely outside a
    # wide interval: rho1 ≈ 1)
    assert _iter0_degree_cap(24.9, 25.0, 1000.0, 20) == 20
    # degenerate interval: no-op
    assert _iter0_degree_cap(30.0, 25.0, 20.0, 20) == 20


def test_pseudo_ladder_iter0_cap_avoids_qr_rescue():
    """With the cap, the DP BSE ladder's first S-QR must survive on the
    CholQR chain (no TSQR/full-block rescue warning) and still converge
    to 1e-10 (the structural iteration-0 breakdown).  A wide-gap
    spectrum maximizes rho1, the breakdown regime."""
    from chase_tpu.logger import get_logger

    N, nev, nex = 256, 16, 8
    # gap + spread -> large rho1 in squared space
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=23,
                                gap=4.0, spread=0.5)
    warns = []
    log = get_logger()
    orig_warn = log.warn
    try:
        log.warn = lambda msg, *a, **k: warns.append(str(msg))
        cfg = chase_tpu.ChaseConfig(mixed_precision=True)
        res = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10, config=cfg)
    finally:
        log.warn = orig_warn
    assert res.converged
    tr = _true_pseudo_residuals(H, res, nev)
    assert tr.max() < 5e-9
    rescue = [w for w in warns if "falling back" in w or "TSQR" in w]
    assert not rescue, rescue
