"""Rayleigh–Ritz + residual kernel tests (mirrors */rayleighRitz.cpp and
*/residuals.cpp), including the masked-locked-columns static-shape scheme."""

import numpy as np
import jax.numpy as jnp
import pytest

from chase_tpu.models import clement, random_hermitian
from chase_tpu.ops.rr import rayleigh_ritz_residuals
from chase_tpu.ops.residuals import residuals
from conftest import ALL_DTYPES, kernel_tol


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=["f32", "f64", "c64", "c128"])
@pytest.mark.quick
def test_rr_recovers_eigenpairs_from_exact_subspace(dtype):
    dtype = np.dtype(dtype)
    N, k = 150, 12
    if np.issubdtype(dtype, np.complexfloating):
        H = random_hermitian(N, dtype=dtype, seed=5)
    else:
        H = clement(N).astype(dtype)
    wide = np.complex128 if np.issubdtype(dtype, np.complexfloating) else np.float64
    evals, evecs = np.linalg.eigh(H.astype(wide))
    # subspace spanning the k lowest eigenvectors, randomly rotated
    rng = np.random.default_rng(0)
    R = rng.standard_normal((k, k))
    Q, _ = np.linalg.qr(evecs[:, :k] @ R)
    V = Q.astype(dtype)

    V_out, ritz, resid = rayleigh_ritz_residuals(
        jnp.asarray(H), jnp.asarray(V), jnp.int32(0))
    tol = kernel_tol(dtype)
    np.testing.assert_allclose(np.asarray(ritz), evals[:k], rtol=0,
                               atol=tol * max(1.0, abs(evals[0])))
    assert np.all(np.asarray(resid) < tol * 50 * max(1.0, abs(evals[0])))


@pytest.mark.quick
def test_rr_locked_columns_untouched_and_consistent():
    N, k, locked = 100, 10, 4
    H = clement(N)
    evals, evecs = np.linalg.eigh(H)
    # locked = exact lowest eigenvectors; active = rotated span of the next 6
    rng = np.random.default_rng(1)
    act = evecs[:, locked:k] @ rng.standard_normal((k - locked, k - locked))
    act, _ = np.linalg.qr(act)
    V = np.concatenate([evecs[:, :locked], act], axis=1)

    V_out, ritz, resid = rayleigh_ritz_residuals(
        jnp.asarray(H), jnp.asarray(V), jnp.int32(locked))
    V_out = np.asarray(V_out)
    np.testing.assert_array_equal(V_out[:, :locked], V[:, :locked])
    np.testing.assert_allclose(np.asarray(ritz)[locked:], evals[locked:k],
                               atol=1e-8)
    assert np.all(np.asarray(resid)[locked:] < 1e-8 * N)


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=["f32", "f64", "c64", "c128"])
@pytest.mark.quick
def test_standalone_residuals(dtype):
    dtype = np.dtype(dtype)
    N, k = 80, 6
    H = (random_hermitian(N, dtype=np.complex128, seed=7)
         if np.issubdtype(dtype, np.complexfloating) else clement(N))
    wide = np.complex128 if np.issubdtype(dtype, np.complexfloating) else np.float64
    evals, evecs = np.linalg.eigh(H.astype(wide))
    r = residuals(jnp.asarray(H.astype(dtype)),
                  jnp.asarray(evecs[:, :k].astype(dtype)),
                  jnp.asarray(evals[:k].astype(np.float64 if dtype.itemsize >= 8
                                               else np.float32)))
    scale = max(1.0, float(abs(evals).max()))
    assert np.all(np.asarray(r) < kernel_tol(dtype) * scale)


def test_rr_host_small_dense_matches_device():
    """small_dense='host' (pure_callback LAPACK eigh, P8 redundant-heevd
    analogue) must agree with the device path."""
    import numpy as np
    import jax.numpy as jnp
    from chase_tpu.ops.rr import rayleigh_ritz_residuals

    rng = np.random.default_rng(11)
    N, k = 96, 10
    A = rng.standard_normal((N, N))
    H = jnp.asarray((A + A.T) / 2)
    Q, _ = np.linalg.qr(rng.standard_normal((N, k)))
    V = jnp.asarray(Q)
    Vd, rd, sd_ = rayleigh_ritz_residuals(H, V, jnp.int32(0))
    Vh, rh, sh_ = rayleigh_ritz_residuals(H, V, jnp.int32(0),
                                          small_dense="host")
    np.testing.assert_allclose(np.asarray(rd), np.asarray(rh), atol=1e-10)
    np.testing.assert_allclose(np.asarray(sd_), np.asarray(sh_), atol=1e-8)


def test_solver_host_small_dense_e2e():
    import numpy as np
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues
    cfg = chase_tpu.ChaseConfig(small_dense_backend="host")
    res = chase_tpu.eigsh(clement(160), 10, 10, tol=1e-10, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(160)[:10],
                               atol=1e-7)


def test_rr_immune_to_column_norm_deficit():
    """A basis column with ||q||^2 = 1 - eta yields a Rayleigh quotient
    biased by lambda*eta unless RR renormalizes.  A QR chain with an f32
    factorization can leave eta ~ eps_f32, which would freeze DP solves at
    1e-7*||H|| residuals.  RR must be immune."""
    import numpy as np
    import jax.numpy as jnp
    from chase_tpu.ops.rr import rayleigh_ritz_residuals

    rng = np.random.default_rng(0)
    N, k = 256, 12
    lam = np.linspace(-200.0, 200.0, N)
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    H = (Q * lam) @ Q.T
    V = Q[:, :k] * (1.0 - 1.2e-7)          # denormalized exact eigenvectors
    _, ritz, resid = rayleigh_ritz_residuals(
        jnp.asarray(H), jnp.asarray(V), jnp.int32(0))
    # without renormalization the bias would be |lam|*1.2e-7 ~ 2.4e-5
    assert np.abs(np.asarray(ritz) - lam[:k]).max() < 1e-9
    assert np.asarray(resid).max() < 1e-9


def test_solver_wide_f64_path():
    """wide_f64='on': the solve routes RR/QR through the exact-bf16-slice
    GEMM and still reaches DP tolerances (parity with the default path)."""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    N, nev, nex = 192, 10, 10
    H = clement(N).astype(np.float64)
    cfg = chase_tpu.ChaseConfig(wide_f64="on")
    res = chase_tpu.eigsh(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-8)
    V = np.asarray(res.V)[:, :nev]
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-8


@pytest.mark.parametrize("wide_f64,dtype,engaged", [
    ("auto", np.float64, False), ("off", np.float64, False),
    ("on", np.float64, True), ("on", np.complex128, False),
    ("on", np.float32, False)])
def test_resolve_wide_policy(wide_f64, dtype, engaged):
    """solver.resolve_wide: the exact-slice GEMM engages only on an
    explicit wide_f64='on' for a real f64 operator ('auto' is the native
    f64 GEMM at every N), and then pairs with the host eigh and the wide
    QR backend."""
    import chase_tpu
    from chase_tpu.solver import resolve_wide

    class FakeOp:
        N = 100_000
    FakeOp.dtype = np.dtype(dtype)
    rcfg = chase_tpu.ChaseConfig(wide_f64=wide_f64).resolve(dtype)
    is_sp = dtype == np.float32
    use, sd, qr = resolve_wide(rcfg, FakeOp(), is_sp, "device", "device")
    assert use is engaged
    assert (sd, qr) == (("host", "wide") if engaged else ("device", "device"))


def test_solver_wide_f64_sharded():
    """wide_f64='on' on an 8-device grid: the slice stack is grid-sharded
    and the wide RR/QR GEMMs run under GSPMD — the multi-chip DP path."""
    import numpy as np
    import jax
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues
    from chase_tpu.parallel.operator import DenseOperator

    N, nev, nex = 192, 10, 10
    grid = chase_tpu.make_grid(jax.devices(), shape=(2, 4))
    H = clement(N).astype(np.float64)
    op = DenseOperator(H, grid=grid)
    cfg = chase_tpu.ChaseConfig(wide_f64="on", mixed_precision=True)
    res = chase_tpu.eigsh(op, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-8)
    # slice stack actually sharded over the mesh (not replicated)
    slices, sa, s, L = op._H_wide
    assert not slices[0].sharding.is_fully_replicated


def test_engage_wide_drops_f64_and_rematerializes():
    """operator.engage_wide releases the device f64 buffer after the one
    donating slice+shadow program; op.H re-uploads lazily from the host
    source on later access."""
    import numpy as np
    import chase_tpu
    from chase_tpu.parallel.operator import DenseOperator
    from chase_tpu.models import clement, clement_eigenvalues

    N = 192
    H = np.asarray(clement(N), np.float64)
    op = DenseOperator(H)
    op.engage_wide()
    assert op._H_dev is None              # dropped after donation
    assert op._H_wide is not None and op._H_low is not None
    # a wide refine-ladder solve runs entirely without the f64 buffer
    cfg = chase_tpu.ChaseConfig(wide_f64="on", mixed_precision=True)
    res = chase_tpu.eigsh(op, 10, 10, tol=1e-10, config=cfg)
    assert res.converged and op._H_dev is None
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:10],
                               atol=1e-8)
    # lazy re-materialization for any later f64 access
    np.testing.assert_array_equal(np.asarray(op.H), H)


def test_wide_matmul_accuracy():
    """ops/wide: f64-level accuracy from exact bf16 slice products."""
    import numpy as np
    import jax.numpy as jnp
    from chase_tpu.ops.wide import wide_matmul, presplit, wide_matmul_sliced

    rng = np.random.default_rng(0)
    N, k = 512, 64
    A = rng.standard_normal((N, N)) * np.exp(rng.standard_normal((N, 1)) * 3)
    B = rng.standard_normal((N, k))
    C_ref = A @ B
    C = np.asarray(wide_matmul(jnp.asarray(A), jnp.asarray(B)))
    assert np.abs(C - C_ref).max() / np.abs(C_ref).max() < 1e-13
    Cs = np.asarray(wide_matmul_sliced(presplit(jnp.asarray(A)),
                                       jnp.asarray(B)))
    assert np.abs(Cs - C_ref).max() / np.abs(C_ref).max() < 1e-13


def test_presplit_chunked_matches_oneshot():
    """presplit_and_shadow_chunked (the N=16384 HBM path: row-block
    slicing from the host source) is bit-identical to the one-shot
    program — per-row 2^e scaling makes slicing row-separable, including
    a ragged tail chunk."""
    import numpy as np
    import jax.numpy as jnp
    from chase_tpu.ops.wide import (presplit_and_shadow,
                                    presplit_and_shadow_chunked)

    rng = np.random.default_rng(1)
    N, n = 101, 96
    H = rng.standard_normal((N, n)) * np.exp(rng.standard_normal((N, 1)) * 4)
    sl0, sa0, low0, s0, L0 = presplit_and_shadow(jnp.asarray(H))
    sl1, sa1, low1, s1, L1 = presplit_and_shadow_chunked(H, row_chunk=32)
    assert (s0, L0) == (s1, L1) and len(sl0) == len(sl1)
    for a, b in zip(sl0, sl1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(sa0), np.asarray(sa1))
    np.testing.assert_array_equal(np.asarray(low0), np.asarray(low1))


def test_engage_wide_chunked_threshold(monkeypatch):
    """Operators above the 1 GB f64 threshold take the chunked host-source
    slicing path (and still drop the device buffer); small ones keep the
    one-shot donating program."""
    import numpy as np
    import chase_tpu.parallel.operator as op_mod
    import chase_tpu.ops.wide as wide_mod
    from chase_tpu.parallel.operator import DenseOperator
    from chase_tpu.models import clement

    calls = {"chunked": 0, "oneshot": 0}
    real_chunked = wide_mod.presplit_and_shadow_chunked
    real_oneshot = wide_mod.presplit_and_shadow

    def spy_chunked(H, **kw):
        calls["chunked"] += 1
        return real_chunked(H, **kw)

    def spy_oneshot(H, **kw):
        calls["oneshot"] += 1
        return real_oneshot(H, **kw)

    monkeypatch.setattr(wide_mod, "presplit_and_shadow_chunked", spy_chunked)
    monkeypatch.setattr(wide_mod, "presplit_and_shadow", spy_oneshot)
    H = np.asarray(clement(128), np.float64)
    op = DenseOperator(H)
    # fake the size gate: pretend the operator crosses 1 GB
    monkeypatch.setattr(op, "_N", 1 << 14)
    try:
        op.engage_wide()
    finally:
        op._N = 128
    assert calls == {"chunked": 1, "oneshot": 0}
    assert op._H_dev is None and op._H_wide is not None
    op2 = DenseOperator(H)
    op2.engage_wide()
    assert calls == {"chunked": 1, "oneshot": 1}


@pytest.mark.quick
def test_wide_i8_scheme_accuracy_and_parity():
    """The int8 Ozaki scheme (int32-exact accumulation, 1 byte/slice)
    must deliver the same ~1e-15 f64 GEMM accuracy as the bf16 scheme,
    through both the dynamic and the pre-sliced (H_wide) entry points."""
    import jax.numpy as jnp
    from chase_tpu.ops import wide

    rng = np.random.default_rng(31)
    n = 700
    A = rng.standard_normal((256, n)) * np.exp(
        rng.uniform(-8, 8, (256, 1)))          # wide row dynamic range
    B = rng.standard_normal((n, 48))
    C = A @ B
    den = (np.linalg.norm(A, axis=1)[:, None]
           * np.linalg.norm(B, axis=0)[None, :])
    for scheme, tol in (("bf16", 5e-14), ("i8", 1e-12)):
        # i8 carries 48 operand bits (√n·2^-48 truncation — sized for the
        # 1e-10 solver target with int8 headroom for noisy device round)
        W = np.asarray(wide.wide_matmul(jnp.asarray(A), jnp.asarray(B),
                                        scheme=scheme))
        rel = (np.abs(W - C) / den).max()
        assert rel < tol, (scheme, rel)
    # pre-sliced (operator) path, i8: slices really are int8
    sl = wide.presplit(jnp.asarray(A), scheme="i8")
    assert sl[0][0].dtype == jnp.int8
    W2 = np.asarray(wide.wide_matmul_sliced(sl, jnp.asarray(B)))
    assert (np.abs(W2 - C) / den).max() < 1e-12
    # auto resolves to i8 within the exactness window, bf16 past it
    assert wide.wide_scheme_auto(8192) == "i8"
    assert wide.wide_scheme_auto(600000) == "bf16"


def test_wide_i8_end_to_end_dp_solve():
    """wide_f64='on' with the (default) int8 scheme: full 1e-10 DP solve
    through the sliced RR/QR path."""
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    N, nev, nex = 192, 12, 8
    H = clement(N)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True, wide_f64="on")
    res = chase_tpu.eigsh(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    exact = clement_eigenvalues(N)[:nev]
    np.testing.assert_allclose(res.ritzv, exact, atol=1e-8)
    V = np.asarray(res.V)[:, :nev]
    assert np.linalg.norm(H @ V - V * res.ritzv, axis=0).max() < 1e-9


@pytest.mark.quick
def test_rr_wide_lowmem_parity(monkeypatch):
    """The split/donating low-mem wide RR chain (engaged when the single
    wide RR program would not fit the device) must match
    the fused wide path bit-for-... well, to f64 roundoff."""
    import jax.numpy as jnp
    from chase_tpu.ops import rr as rrops
    from chase_tpu.ops import wide

    rng = np.random.default_rng(7)
    N, k, locked = 300, 24, 5
    H = rng.standard_normal((N, N))
    H = (H + H.T) / 2
    V, _ = np.linalg.qr(rng.standard_normal((N, k)))
    sl = wide.presplit(jnp.asarray(H), scheme="i8")
    slices, sa, s, L = sl
    Vd = jnp.asarray(V)

    monkeypatch.setattr(rrops, "_wide_rr_lowmem", lambda *a: False)
    out_f = rrops.rayleigh_ritz_residuals(
        None, Vd, jnp.int32(locked), want_vectors=True, H_wide=sl)
    monkeypatch.setattr(rrops, "_wide_rr_lowmem", lambda *a: True)
    out_l = rrops.rayleigh_ritz_residuals(
        None, Vd, jnp.int32(locked), want_vectors=True, H_wide=sl)

    act = np.arange(k) >= locked
    for a, b, name in zip(out_f, out_l, ("V", "ritz", "resid", "R")):
        a, b = np.asarray(a), np.asarray(b)
        if a.ndim == 1:
            np.testing.assert_allclose(a[act], b[act], rtol=0, atol=1e-10,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a[:, act], b[:, act], rtol=0,
                                       atol=1e-10, err_msg=name)
    # and against a dense f64 reference RR on the active columns
    ritz_l = np.asarray(out_l[1])[locked:]
    Q = V[:, act]
    Aref = Q.T @ H @ Q
    w = np.linalg.eigvalsh(Aref)
    np.testing.assert_allclose(ritz_l, w, atol=1e-9)
