"""Real-pair complex mode (ops/realpair.py + api complex_backend).

Complex Hermitian solves on real-only accelerators run the real symplectic
embedding J = [[Hr,-Hi],[Hi,Hr]]; these tests force the mode ON CPU and
check parity against native complex and numpy (reference 4-dtype e2e
matrix: tests/chase_serial_solve.cpp:23-120)."""

import numpy as np
import pytest

import chase_tpu
from chase_tpu import ChaseConfig
from chase_tpu.ops.realpair import embed_real, embed_block, extract_pairs


def _complex_hermitian(N, seed=0, dtype=np.complex128, spectrum=None):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    Q, _ = np.linalg.qr(A)
    lam = (np.linspace(-1.0, 1.0, N) if spectrum is None
           else np.asarray(spectrum, np.float64))
    return ((Q * lam) @ Q.conj().T).astype(dtype), np.sort(lam)


def test_embed_real_spectrum_doubles():
    H, lam = _complex_hermitian(24, seed=1)
    J = embed_real(H)
    assert J.dtype == np.float64 and J.shape == (48, 48)
    np.testing.assert_allclose(J, J.T, atol=1e-14)
    wJ = np.linalg.eigvalsh(J)
    np.testing.assert_allclose(wJ, np.repeat(lam, 2), atol=1e-12)


def test_real_pair_e2e_matches_native_and_numpy():
    N, nev, nex = 96, 10, 10
    H, lam = _complex_hermitian(N, seed=2)
    cfg = ChaseConfig(complex_backend="real_pair")
    res = chase_tpu.eigsh(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, lam[:nev], atol=1e-9)
    V = np.asarray(res.V)[:, :nev]
    assert V.dtype == np.complex128 and V.shape == (N, nev)
    # true complex residuals + orthonormality
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-8
    G = V.conj().T @ V
    np.testing.assert_allclose(G, np.eye(nev), atol=1e-8)
    # parity against the native complex path
    res_n = chase_tpu.eigsh(H, nev, nex, tol=1e-10,
                            config=ChaseConfig(complex_backend="native"))
    np.testing.assert_allclose(res.ritzv, res_n.ritzv, atol=1e-9)


def test_real_pair_c64():
    N, nev, nex = 64, 6, 8
    H, lam = _complex_hermitian(N, seed=3, dtype=np.complex64)
    cfg = ChaseConfig(complex_backend="real_pair")
    res = chase_tpu.eigsh(H, nev, nex, tol=1e-5, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, lam[:nev], atol=2e-5)
    V = np.asarray(res.V)[:, :nev]
    assert V.dtype == np.complex64
    R = H @ V - V * res.ritzv[None, :].astype(np.complex64)
    assert np.linalg.norm(R, axis=0).max() < 5e-4


def test_real_pair_degenerate_cluster():
    """A doubly degenerate complex eigenvalue (4-fold in J) must yield two
    ORTHONORMAL complex eigenvectors, not the same direction twice."""
    N, nev, nex = 48, 4, 8
    lam = np.linspace(-1.0, 1.0, N)
    lam[1] = lam[0]                       # double complex eigenvalue at λ0
    H, lam_s = _complex_hermitian(N, seed=4, spectrum=lam)
    cfg = ChaseConfig(complex_backend="real_pair")
    res = chase_tpu.eigsh(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, lam_s[:nev], atol=1e-8)
    V = np.asarray(res.V)[:, :nev]
    G = V.conj().T @ V
    np.testing.assert_allclose(G, np.eye(nev), atol=1e-6)
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-7


def test_real_pair_fused():
    N, nev, nex = 64, 6, 10
    H, lam = _complex_hermitian(N, seed=5)
    cfg = ChaseConfig(complex_backend="real_pair")
    res = chase_tpu.eigsh_fused(H, nev, nex, tol=1e-9, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, lam[:nev], atol=1e-8)
    V = np.asarray(res.V)[:, :nev]
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-7


def test_real_pair_largest():
    N, nev = 64, 5
    H, lam = _complex_hermitian(N, seed=6)
    cfg = ChaseConfig(complex_backend="real_pair")
    res = chase_tpu.eigsh(H, nev, 8, tol=1e-10, config=cfg, largest=True)
    np.testing.assert_allclose(res.ritzv, lam[-nev:], atol=1e-8)


def test_real_pair_warm_sequence():
    """approx-mode warm start through the embedding (sequence solves)."""
    N, nev, nex = 64, 6, 8
    H1, lam1 = _complex_hermitian(N, seed=7)
    rng = np.random.default_rng(8)
    D = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    H2 = H1 + 1e-3 * (D + D.conj().T) / 2
    cfg = ChaseConfig(complex_backend="real_pair")
    r1 = chase_tpu.eigsh(H1, nev, nex, tol=1e-9, config=cfg)
    r2 = chase_tpu.eigsh(H2, nev, nex, tol=1e-9, config=cfg,
                         v0=np.asarray(r1.V), ritzv0=r1.ritzv_full,
                         approx=True)
    assert r2.converged
    lam2 = np.sort(np.linalg.eigvalsh(H2))
    np.testing.assert_allclose(r2.ritzv, lam2[:nev], atol=1e-8)
    assert r2.iterations <= r1.iterations


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_auto_policy_on_cpu_stays_native(monkeypatch, platform):
    """complex_backend='auto' keeps complex dtypes native on every
    supported platform; only an explicit 'real_pair' embeds."""
    import jax
    from chase_tpu.api import _use_real_pair
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    H = np.eye(8, dtype=np.complex128)
    assert not _use_real_pair(H, ChaseConfig())
    assert not _use_real_pair(H, ChaseConfig(complex_backend="native"))
    assert _use_real_pair(H, ChaseConfig(complex_backend="real_pair"))
    assert not _use_real_pair(H.real, ChaseConfig(complex_backend="real_pair"))


# ---------------------------------------------------------------------------
# pseudo-Hermitian (BSE) real-pair mode
# ---------------------------------------------------------------------------

def _bse_exact_positive(H, k):
    ev = np.sort(np.linalg.eigvals(H.astype(np.complex128)).real)
    return ev[ev > 0][:k]


def test_embed_real_pseudo_structure():
    """J'' is pseudo-symmetric w.r.t. the canonical signature, doubles the
    spectrum, and the plain half-swap IS the complex K-conjugation (the D
    similarity of embed_real_pseudo — without it the real solver's locked
    mirrors are not eigenvectors and convergence stalls)."""
    from chase_tpu.models import random_pseudo_hermitian
    from chase_tpu.ops.realpair import embed_real_pseudo
    N = 64
    H = random_pseudo_hermitian(N, dtype=np.complex128, seed=11)
    J, P, d = embed_real_pseudo(H)
    S2 = np.ones(2 * N)
    S2[N:] = -1
    M = S2[:, None] * J
    np.testing.assert_allclose(M, M.T, atol=1e-14)
    evH = np.sort(np.linalg.eigvals(H).real)
    evJ = np.sort(np.linalg.eig(J)[0].real)
    np.testing.assert_allclose(evJ, np.repeat(evH, 2), atol=1e-10)
    # K check on one positive eigenpair
    w, Z = np.linalg.eig(J)
    i = int(np.argmin(np.abs(w.real - evH[evH > 0][0])))
    z, lam = Z[:, i].real, w[i].real
    kz = np.concatenate([z[N:], z[:N]])
    assert np.linalg.norm(J @ kz + lam * kz) < 1e-10 * max(1.0, abs(lam))


@pytest.mark.parametrize("dtype,tol,atol", [
    (np.complex128, 1e-10, 1e-8), (np.complex64, 1e-5, 1e-3)],
    ids=["c128", "c64"])
def test_pseudo_real_pair_e2e(dtype, tol, atol):
    """{c,z} BSE solves through the embedding match the exact spectrum and
    return true complex eigenvectors (reference solve_pseudo dtypes,
    interface/chase_c_interface.h:159-175)."""
    from chase_tpu.models import random_pseudo_hermitian
    N, nev, nex = 128, 8, 8
    H = random_pseudo_hermitian(N, dtype=dtype, seed=3)
    cfg = ChaseConfig(complex_backend="real_pair")
    res = chase_tpu.eigsh_pseudo(H, nev, nex, tol=tol, config=cfg)
    assert res.converged
    pos = _bse_exact_positive(H, nev)
    np.testing.assert_allclose(res.ritzv, pos, atol=atol)
    V = np.asarray(res.V)[:, :nev]
    assert V.dtype == np.dtype(dtype)
    r = np.linalg.norm(H @ V - V * res.ritzv, axis=0)
    assert r.max() < 100 * tol


def test_pseudo_real_pair_fused_and_warm():
    """fused one-dispatch BSE solve through the embedding + a v0 warm
    restart that reconverges in one iteration."""
    from chase_tpu.models import random_pseudo_hermitian
    H = random_pseudo_hermitian(96, dtype=np.complex64, seed=7)
    cfg = ChaseConfig(complex_backend="real_pair")
    r0 = chase_tpu.eigsh_pseudo_fused(H, 6, 6, tol=1e-4, config=cfg)
    assert r0.converged
    pos = _bse_exact_positive(H, 6)
    np.testing.assert_allclose(r0.ritzv, pos, atol=1e-3)
    r1 = chase_tpu.eigsh_pseudo(H, 6, 6, tol=1e-4, config=cfg, v0=r0.V)
    assert r1.converged and r1.iterations <= 2
    np.testing.assert_allclose(r1.ritzv, pos, atol=1e-3)


def test_warm_v0_uses_fresh_lanczos_probes():
    """Seeding v0 with converged eigenvectors must NOT collapse the
    Lanczos/DoS filter bounds (regression: the probe Krylov space broke
    down on eigenvector seeds and 10/12 columns stalled for 25
    iterations; both drivers now probe with fresh random vectors for any
    user-provided basis)."""
    from chase_tpu.models import random_pseudo_hermitian, clement
    # pseudo, native complex path
    H = random_pseudo_hermitian(96, dtype=np.complex64, seed=7)
    cfg = ChaseConfig(complex_backend="native")
    r0 = chase_tpu.eigsh_pseudo(H, 6, 6, tol=1e-4, config=cfg)
    rng = np.random.default_rng(0)
    v = rng.standard_normal((96, 24)) + 1j * rng.standard_normal((96, 24))
    v[:, :6] = np.asarray(r0.V)[:, :6]     # eigvecs + random rest
    r1 = chase_tpu.eigsh_pseudo(H, 6, 6, tol=1e-4, config=cfg,
                                v0=v.astype(np.complex64))
    pos = _bse_exact_positive(H, 6)
    assert r1.converged and np.abs(r1.ritzv - pos).max() < 1e-3
    assert r1.resid.max() <= 1e-4
    # hermitian driver, plain v0 (no approx)
    Hc = clement(192).astype(np.float64)
    h0 = chase_tpu.eigsh(Hc, 12, 8, tol=1e-10)
    h1 = chase_tpu.eigsh(Hc, 12, 8, tol=1e-10, v0=np.asarray(h0.V))
    assert h1.converged and h1.iterations <= 2


def test_pseudo_real_pair_native_v0_convention():
    """A v0 produced by the NATIVE pseudo path (2·(nev+nex) columns — the
    C-ABI/`eigsh_pseudo` convention) must warm-start the real-pair path
    (regression: the mirror-concat assumed nev+nex columns and built a
    2x-oversized V0 → shape crash; a v0 that worked on CPU crashed on any
    accelerator where complex_backend auto-selects real_pair)."""
    from chase_tpu.models import random_pseudo_hermitian
    H = random_pseudo_hermitian(96, dtype=np.complex64, seed=7)
    r0 = chase_tpu.eigsh_pseudo(H, 6, 6, tol=1e-4,
                                config=ChaseConfig(complex_backend="native"))
    assert np.asarray(r0.V).shape[1] == 2 * (6 + 6)
    cfg = ChaseConfig(complex_backend="real_pair")
    r1 = chase_tpu.eigsh_pseudo(H, 6, 6, tol=1e-4, config=cfg,
                                v0=np.asarray(r0.V))
    pos = _bse_exact_positive(H, 6)
    assert r1.converged
    np.testing.assert_allclose(r1.ritzv, pos, atol=1e-3)
    # wrong widths raise a clear error instead of a broadcast crash
    with pytest.raises(ValueError, match="columns"):
        chase_tpu.eigsh_pseudo(H, 6, 6, tol=1e-4, config=cfg,
                               v0=np.asarray(r0.V)[:, :7])


def test_wide_f64_on_ignored_for_non_f64():
    """wide_f64='on' on an f32 or complex solve is ignored (logged), not a
    mid-solve TypeError (regression)."""
    from chase_tpu.models import clement
    H32 = clement(128).astype(np.float32)
    r = chase_tpu.eigsh(H32, 8, 8, tol=1e-3,
                        config=ChaseConfig(wide_f64="on"))
    assert r.converged
    Hc, lam = _complex_hermitian(96, seed=3, dtype=np.complex128)
    rc = chase_tpu.eigsh(Hc, 8, 8, tol=1e-8,
                         config=ChaseConfig(wide_f64="on",
                                            complex_backend="native"))
    assert rc.converged
    np.testing.assert_allclose(rc.ritzv, lam[:8], atol=1e-7)


def test_embed_complex_operator_reuse():
    """Pre-embedded operator (serving reuse): two solves against the same
    embedded op match the raw-H real-pair path, and the wrong-API guards
    fire."""
    N, nev, nex = 64, 6, 8
    H, lam = _complex_hermitian(N, seed=11, dtype=np.complex64)
    cfg = ChaseConfig(complex_backend="real_pair")
    op = chase_tpu.embed_complex_operator(H)
    for _ in range(2):                      # repeated solves, one embedding
        res = chase_tpu.eigsh(op, nev, nex, tol=1e-5, config=cfg)
        assert res.converged
        np.testing.assert_allclose(res.ritzv, lam[:nev], atol=2e-5)
        V = np.asarray(res.V)[:, :nev]
        assert V.dtype == np.complex64
        R = H @ V - V * res.ritzv[None, :].astype(np.complex64)
        assert np.linalg.norm(R, axis=0).max() < 5e-4
    # fused path reuses the same op
    resf = chase_tpu.eigsh_fused(op, nev, nex, tol=1e-5, config=cfg)
    np.testing.assert_allclose(resf.ritzv, lam[:nev], atol=2e-5)
    # wrong API → clear error
    with pytest.raises(ValueError, match="embedded without"):
        chase_tpu.eigsh_pseudo(op, nev, nex)
    with pytest.raises(ValueError, match="complex matrices"):
        chase_tpu.embed_complex_operator(np.eye(8, dtype=np.float64))


def test_embed_complex_operator_pseudo_reuse():
    from chase_tpu.models import random_pseudo_hermitian
    N, nev, nex = 64, 4, 6
    H = np.asarray(random_pseudo_hermitian(N, dtype=np.complex64, seed=9))
    pos = np.sort(np.linalg.eigvals(H).real)
    pos = pos[pos > 0][:nev]
    op = chase_tpu.embed_complex_operator(H, pseudo=True)
    for _ in range(2):
        res = chase_tpu.eigsh_pseudo(op, nev, nex, tol=1e-4)
        assert res.converged
        np.testing.assert_allclose(np.asarray(res.ritzv), pos, atol=1e-3)
    with pytest.raises(ValueError, match="embedded with pseudo"):
        chase_tpu.eigsh(op, nev, nex)


@pytest.mark.quick
def test_raw_complex_embed_cache():
    """A second eigsh/eigsh_pseudo call with the SAME raw complex H object
    must reuse the cached embedding (no re-embedding per call);
    mutating H in place must invalidate it."""
    import dataclasses
    from chase_tpu import api as _api
    from chase_tpu.models import random_hermitian
    from chase_tpu.config import ChaseConfig

    N, nev, nex = 48, 4, 6
    H = np.asarray(random_hermitian(N, dtype=np.complex128, seed=3))
    cfg = dataclasses.replace(ChaseConfig(), complex_backend="real_pair")
    _api._EMBED_CACHE.clear()

    calls = {"n": 0}
    orig = _api.embed_complex_operator

    def counting(Hm, **kw):
        calls["n"] += 1
        return orig(Hm, **kw)

    _api.embed_complex_operator, restore = counting, orig
    try:
        r1 = chase_tpu.eigsh(H, nev, nex, tol=1e-9, config=cfg)
        r2 = chase_tpu.eigsh(H, nev, nex, tol=1e-9, config=cfg)
        assert calls["n"] == 1, "second call must hit the embed cache"
        np.testing.assert_allclose(np.asarray(r1.ritzv),
                                   np.asarray(r2.ritzv), rtol=1e-8)
        # in-place mutation invalidates the cache entry
        H *= 1.0 + 1e-3
        chase_tpu.eigsh(H, nev, nex, tol=1e-9, config=cfg)
        assert calls["n"] == 2, "mutated H must re-embed"
        # a different object with equal contents re-embeds (id-keyed)
        chase_tpu.eigsh(H.copy(), nev, nex, tol=1e-9, config=cfg)
        assert calls["n"] == 3
        # LRU bound
        assert len(_api._EMBED_CACHE) <= _api._EMBED_CACHE_MAX
    finally:
        _api.embed_complex_operator = restore
        _api._EMBED_CACHE.clear()
