"""CholQR / orthonormalization tests.

Mirrors tests/linalg/internal/*/cholqr.cpp: orthonormality after CholQR1/2
and shifted CholQR2 on increasingly ill-conditioned bases, Householder
fallback on Cholesky breakdown, and locked-column preservation.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from chase_tpu.config import ChaseConfig
from chase_tpu.ops.qr import cholqr, householder_qr, orthonormalize, tsqr
from chase_tpu.parallel.mesh import make_grid
from conftest import ALL_DTYPES, kernel_tol


def _make_cond(N, k, cond, dtype, seed=0):
    """Random N×k basis with prescribed condition number."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, k))
    B = rng.standard_normal((k, k))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.standard_normal((N, k))
        B = B + 1j * rng.standard_normal((k, k))
    Q, _ = np.linalg.qr(A)
    P, _ = np.linalg.qr(B)
    s = np.logspace(0, -np.log10(cond), k)
    return (Q * s) @ P.conj().T


def _ortho_err(V):
    V = np.asarray(V)
    G = V.conj().T @ V
    return np.max(np.abs(G - np.eye(V.shape[1])))


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=["f32", "f64", "c64", "c128"])
@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.quick
def test_cholqr_orthonormalizes(dtype, passes):
    # CholQR squares the condition number: keep cond(V) well inside
    # 1/sqrt(eps) for the raw kernel (the solver upcasts SP via qr_hi_prec —
    # the QR_DOUBLE_PRECISION analogue — before pushing harder cases here).
    sp = np.dtype(dtype).itemsize <= 8
    cond = 10.0 if passes == 1 else (3e2 if sp else 1e4)
    V = _make_cond(200, 16, cond, dtype).astype(dtype)
    Q, ok = cholqr(jnp.asarray(V), passes=passes)
    assert bool(ok)
    assert _ortho_err(Q) < kernel_tol(dtype) * 10


@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=["f64", "c128"])
@pytest.mark.quick
def test_shifted_cholqr_ill_conditioned(dtype):
    # cond ~1e9: plain CholQR1's Gram is numerically singular in DP
    V = _make_cond(400, 24, 1e9, dtype).astype(dtype)
    Q, ok = cholqr(jnp.asarray(V), passes=3, shifted=True)
    assert bool(ok)
    assert _ortho_err(Q) < 1e-10


@pytest.mark.quick
def test_cholqr_detects_breakdown():
    # exactly rank-deficient basis → Cholesky must fail, flag must report it
    V = np.zeros((100, 8))
    V[:, :4] = np.random.default_rng(0).standard_normal((100, 4))
    V[:, 4:] = V[:, :4]
    _, ok = cholqr(jnp.asarray(V), passes=1)
    assert not bool(ok)


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=["f32", "f64", "c64", "c128"])
@pytest.mark.quick
def test_householder_qr(dtype):
    V = _make_cond(150, 12, 1e6, dtype).astype(dtype)
    Q = householder_qr(jnp.asarray(V))
    tol = kernel_tol(dtype)
    assert _ortho_err(Q) < tol


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=["f32", "f64", "c64", "c128"])
def test_tsqr_distributed_matches_householder(dtype):
    """Distributed TSQR on the 8-device mesh: orthonormal and span-preserving.

    JAX analogue of the reference's distributed Householder QR tests
    (tests/linalg/internal/mpi/householder_qr.cpp on 4 MPI ranks)."""
    grid = make_grid()  # 8 virtual devices
    p = grid.shape["r"]
    N, k = 64 * p, 12
    V = _make_cond(N, k, 1e6, dtype).astype(dtype)
    Q = np.asarray(tsqr(jnp.asarray(V), grid=grid))
    assert _ortho_err(Q) < kernel_tol(dtype)
    # same column space: V must be exactly reconstructible from Q
    resid = V - Q @ (Q.conj().T @ V)
    assert np.max(np.abs(resid)) < kernel_tol(dtype) * np.max(np.abs(V))


def test_tsqr_ill_conditioned_rescues_cholqr_regime():
    # cond ~1e14: every CholQR variant breaks down in DP; TSQR must not.
    grid = make_grid()
    p = grid.shape["r"]
    V = _make_cond(32 * p, 16, 1e14, np.float64)
    _, ok = cholqr(jnp.asarray(V), passes=3, shifted=True)
    Q = np.asarray(tsqr(jnp.asarray(V), grid=grid))
    assert _ortho_err(Q) < 1e-12


def test_tsqr_short_shard_fallback():
    # N/p < k: per-shard QR would be rank-deficient — must fall back to
    # the dense path and still orthonormalize.  Derive k from the actual
    # 'r' axis size so the fallback branch genuinely triggers.
    grid = make_grid()
    p = grid.shape["r"]
    N = 8 * p
    k = N // p + 4          # strictly more columns than any shard has rows
    V = _make_cond(N, k, 1e3, np.float64)
    Q = np.asarray(tsqr(jnp.asarray(V), grid=grid))
    assert _ortho_err(Q) < 1e-12


def test_tsqr_indivisible_n_fallback():
    # N % p != 0 also routes to the dense path
    grid = make_grid()
    p = grid.shape["r"]
    N = 16 * p + 1
    V = _make_cond(N, 8, 1e3, np.float64)
    Q = np.asarray(tsqr(jnp.asarray(V), grid=grid))
    assert _ortho_err(Q) < 1e-12


def test_orthonormalize_grid_fallback_path():
    # rank-deficient block on the mesh: CholQR fails, TSQR rescues, locked
    # columns preserved.
    grid = make_grid()
    p = grid.shape["r"]
    rng = np.random.default_rng(3)
    N, k = 16 * p, 8
    V = rng.standard_normal((N, k))
    V[:, 4:] = V[:, :4]
    rcfg = ChaseConfig().resolve(np.float64)
    import jax
    Vd = jax.device_put(jnp.asarray(V), grid.sharding("r", None))
    out = np.asarray(orthonormalize(Vd, 0, 10.0, rcfg, grid))
    assert _ortho_err(out) < 1e-10


def test_orthonormalize_preserves_locked_and_orthogonalizes_rest():
    rng = np.random.default_rng(1)
    N, k, locked = 120, 10, 4
    Qfull, _ = np.linalg.qr(rng.standard_normal((N, k)))
    V = np.concatenate(
        [Qfull[:, :locked], rng.standard_normal((N, k - locked))], axis=1)
    rcfg = ChaseConfig().resolve(np.float64)
    out = np.asarray(orthonormalize(jnp.asarray(V), locked, 50.0, rcfg))
    # locked columns bit-identical
    np.testing.assert_array_equal(out[:, :locked], V[:, :locked])
    assert _ortho_err(out) < 1e-10


def test_orthonormalize_falls_back_to_householder():
    # rank-deficient active block: CholQR fails, Householder must rescue
    rng = np.random.default_rng(2)
    N, k = 80, 6
    V = rng.standard_normal((N, k))
    V[:, 3:] = V[:, :3]
    rcfg = ChaseConfig().resolve(np.float64)
    out = np.asarray(orthonormalize(jnp.asarray(V), 0, 10.0, rcfg))
    assert _ortho_err(out) < 1e-10


def test_cholqr_hostchol_matches_device():
    """Host-factorized CholQR (split-sync potrf+trtri on host, device apply)
    must orthonormalize as well as the device path."""
    from chase_tpu.ops.qr import cholqr_hostchol
    for dtype in [np.float64, np.complex128]:
        V = _make_cond(300, 20, 1e4, dtype).astype(dtype)
        Q, ok = cholqr_hostchol(jnp.asarray(V), passes=2)
        assert ok
        assert _ortho_err(Q) < 1e-12
    # breakdown detection on a rank-deficient block
    V = np.zeros((100, 8))
    V[:, :4] = np.random.default_rng(0).standard_normal((100, 4))
    V[:, 4:] = V[:, :4]
    _, ok = cholqr_hostchol(jnp.asarray(V), passes=1)
    assert not ok


def test_solver_host_qr_and_rr_e2e():
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues
    cfg = ChaseConfig(small_dense_backend="host")
    res = chase_tpu.eigsh(clement(200), 12, 12, tol=1e-10, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(200)[:12],
                               atol=1e-7)


def test_qr_check_ortho_knob(caplog, capsys):
    """CHASE_QR_CHECK_ORTHO analogue: validation runs without affecting
    the result."""
    import dataclasses
    rng = np.random.default_rng(4)
    V = rng.standard_normal((100, 8))
    rcfg = ChaseConfig(qr_check_ortho=True).resolve(np.float64)
    out = np.asarray(orthonormalize(jnp.asarray(V), 0, 10.0, rcfg))
    assert _ortho_err(out) < 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_mgs_cholqr(dtype):
    """Panelized Gram-Schmidt CholQR (reference modifiedGramSchmidtCholQR
    analogue): orthonormal output and span preservation across panels."""
    from chase_tpu.ops.qr import mgs_cholqr
    # well-conditioned tall block (the variant's target regime — the
    # reference also runs CholQR1 per panel, so orthogonality scales as
    # eps*cond(panel)^2)
    V = _make_cond(400, 30, 1e2, dtype).astype(dtype)
    Q, ok = mgs_cholqr(jnp.asarray(V), n_panels=6)
    assert bool(ok)
    assert _ortho_err(Q) < 1e-11
    resid = V - np.asarray(Q) @ (np.asarray(Q).conj().T @ V)
    assert np.max(np.abs(resid)) < 1e-9 * np.max(np.abs(V))
    # moderately ill-conditioned input still produces a usable basis
    V = _make_cond(400, 30, 1e5, dtype).astype(dtype)
    Q, ok = mgs_cholqr(jnp.asarray(V), n_panels=6)
    assert bool(ok)
    assert _ortho_err(Q) < 1e-6


def test_orthonormalize_mgs_threshold():
    """mgs_qr_min_n routes large-N unshifted CholQR through MGS."""
    import dataclasses
    rng = np.random.default_rng(6)
    V = rng.standard_normal((300, 16))
    rcfg = ChaseConfig(mgs_qr_min_n=200).resolve(np.float64)
    out = np.asarray(orthonormalize(jnp.asarray(V), 0, 50.0, rcfg))
    assert _ortho_err(out) < 1e-11


def test_mgs_cholqr_target_regime_tall_block():
    """MGS-CholQR in its actual auto-trigger regime (N >= 1e5, the
    reference's MINIMAL_N_INVOKE_MODIFIED_GRAM_SCHMIDT_QR_GPU_NCCL
    constant): orthonormality and span preservation on a genuinely tall
    ill-scaled block."""
    import jax.numpy as jnp
    from chase_tpu.ops.qr import mgs_cholqr, orthonormalize
    from chase_tpu.config import ChaseConfig

    N, k = 120_000, 24
    rng = np.random.default_rng(11)
    V = rng.standard_normal((N, k))
    # ill-scaled columns (cond ~ 1e6) stress the Gram accumulation
    V *= np.logspace(0, -6, k)[None, :]
    Q, ok = mgs_cholqr(jnp.asarray(V), precision="highest")
    assert bool(ok)
    Q = np.asarray(Q)
    assert np.abs(Q.T @ Q - np.eye(k)).max() < 5e-13
    # span preserved: projecting V onto Q loses nothing
    resid = V - Q @ (Q.T @ V)
    assert np.linalg.norm(resid) / np.linalg.norm(V) < 1e-10

    # the driver auto-routes to MGS at this N (chase_tpu extension; the
    # reference defines the constant but never calls the kernel)
    rcfg = ChaseConfig().resolve(np.float64)
    Q2 = np.asarray(orthonormalize(jnp.asarray(V), 0, 5.0, rcfg))
    assert np.abs(Q2.T @ Q2 - np.eye(k)).max() < 5e-13
