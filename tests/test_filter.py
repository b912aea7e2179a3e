"""Chebyshev filter unit tests.

Mirrors the role of the reference's per-backend HEMM/filter kernel tests
(tests/linalg/internal/*/hemm.cpp): the filter must amplify eigenvector
components below `lower` and damp those inside [lower, upper], and the
degree masking must freeze retired columns exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from chase_tpu.ops.filter import chebyshev_filter
from chase_tpu.models import clement
from conftest import ALL_DTYPES

pytestmark = pytest.mark.quick


def _filter_reference(H, X, degrees, lam1, lower, upper):
    """Straight-line numpy implementation of the scaled recurrence."""
    H = np.asarray(H, np.complex128 if np.iscomplexobj(H) else np.float64)
    X = np.asarray(X, H.dtype)
    c = (upper + lower) / 2
    e = (upper - lower) / 2
    sigma1 = e / (lam1 - c)
    Y = (sigma1 / e) * (H @ X - c * X)
    Y = np.where(np.asarray(degrees)[None, :] >= 1, Y, X)
    sigma = sigma1
    Xp = X
    for t in range(2, int(np.max(degrees)) + 1):
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        Z = (2 * sigma_new / e) * (H @ Y - c * Y) - sigma * sigma_new * Xp
        upd = np.asarray(degrees)[None, :] >= t
        Z = np.where(upd, Z, Y)
        Xp, Y, sigma = Y, Z, sigma_new
    return Y


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=["f32", "f64", "c64", "c128"])
def test_filter_matches_reference_recurrence(dtype):
    dtype = np.dtype(dtype)
    N, w = 64, 12
    rng = np.random.default_rng(0)
    H = clement(N).astype(dtype)
    X = rng.standard_normal((N, w))
    if np.issubdtype(dtype, np.complexfloating):
        X = X + 1j * rng.standard_normal((N, w))
    X = X.astype(dtype)
    degrees = np.array([0, 0, 4, 4, 6, 8, 8, 10, 12, 12, 14, 14], np.int32)
    lam1, lower, upper = -float(N - 1), 0.0, float(N)

    got = np.asarray(chebyshev_filter(
        jnp.asarray(H), jnp.asarray(X), jnp.asarray(degrees),
        np.asarray(lam1, np.float64 if dtype.itemsize >= 8 else np.float32),
        np.asarray(lower, np.float64 if dtype.itemsize >= 8 else np.float32),
        np.asarray(upper, np.float64 if dtype.itemsize >= 8 else np.float32),
        jnp.int32(int(degrees.max()))))
    want = _filter_reference(H, X, degrees, lam1, lower, upper)

    rtol = 1e-4 if dtype.itemsize <= 8 else 1e-10
    np.testing.assert_allclose(got, want.astype(dtype), rtol=rtol, atol=rtol)
    # degree-0 columns pass through bit-exactly
    np.testing.assert_array_equal(got[:, 0], X[:, 0])
    np.testing.assert_array_equal(got[:, 1], X[:, 1])


def test_filter_bf16_storage_tracks_f32():
    """bf16-storage H with f32 carry (the aggressive bf16 rung): the filtered
    basis must stay within bf16-rounding distance of the f32 filter."""
    import jax.numpy as jnp
    from chase_tpu.ops.filter import chebyshev_filter

    rng = np.random.default_rng(7)
    N, k, deg = 128, 8, 10
    A = rng.standard_normal((N, N)).astype(np.float32)
    H = (A + A.T) / 2
    X = rng.standard_normal((N, k)).astype(np.float32)
    w = np.linalg.eigvalsh(H.astype(np.float64))
    lam1, lo, up = w[0], w[k], w[-1]
    degrees = jnp.full((k,), deg, jnp.int32)
    Y32 = np.asarray(chebyshev_filter(
        jnp.asarray(H), jnp.asarray(X), degrees, lam1, lo, up, deg))
    Ybf = np.asarray(chebyshev_filter(
        jnp.asarray(H, jnp.bfloat16), jnp.asarray(X), degrees,
        lam1, lo, up, deg, precision="default"))
    assert Ybf.dtype == np.float32          # carry stays f32
    num = np.linalg.norm(Y32 - Ybf)
    den = np.linalg.norm(Y32)
    # bf16 has ~8 mantissa bits; deg matmuls compound the storage rounding
    assert num / den < 0.05, num / den


def test_filter_amplifies_wanted_end():
    """Components below `lower` grow relative to those inside the interval."""
    N = 128
    H = clement(N)
    w_exact = np.arange(-(N - 1), N, 2, dtype=np.float64)
    evals, evecs = np.linalg.eigh(H)
    # start vector = equal mix of lowest and mid eigenvector
    x = evecs[:, 0] + evecs[:, N // 2]
    X = x[:, None]
    deg = np.array([20], np.int32)
    lower, upper = float(evals[N // 4]), float(evals[-1]) * 1.01
    lam1 = float(evals[0])
    Y = np.asarray(chebyshev_filter(
        jnp.asarray(H), jnp.asarray(X), jnp.asarray(deg),
        lam1, lower, upper, jnp.int32(20)))
    c_low = abs(evecs[:, 0] @ Y[:, 0])
    c_mid = abs(evecs[:, N // 2] @ Y[:, 0])
    assert c_low / max(c_mid, 1e-300) > 1e6


def test_windowed_filter_matches_plain():
    """The host driver's shrinking-window segmented filter must equal the
    plain degree-masked recurrence bit-for-bit up to reduction order."""
    import jax.numpy as jnp
    from chase_tpu.ops.filter import chebyshev_filter
    from chase_tpu.solver import _filter_windowed

    rng = np.random.default_rng(21)
    N, k = 96, 24
    A = rng.standard_normal((N, N))
    H = jnp.asarray((A + A.T) / 2)
    V = jnp.asarray(rng.standard_normal((N, k)))
    w = np.linalg.eigvalsh(np.asarray(H))
    lam, lo, up = w[0], w[k], w[-1]
    degrees = np.sort(rng.integers(2, 18, size=k)) * 2   # ascending, even
    locked = 3
    deg_act = degrees[locked:].astype(np.int64)

    Y_plain = np.asarray(V).copy()
    act = np.asarray(chebyshev_filter(
        H, jnp.asarray(Y_plain), jnp.asarray(
            np.concatenate([np.zeros(locked, np.int32),
                            deg_act.astype(np.int32)])),
        lam, lo, up, int(deg_act.max())))
    for B in [4, 8, 24]:
        Yw, n_exec = _filter_windowed(
            H, jnp.array(V, copy=True), deg_act, locked, k, B, lam, lo,
            up, np.float64, "highest")
        Yw = np.asarray(Yw)
        # executed column-steps ≥ useful (masking waste is quantified)
        assert n_exec >= int(deg_act.sum())
        # the filter amplifies reduction-order noise by ~rho^deg, so
        # compare per-column directions at a realistic tolerance
        for j in range(locked, k):
            a, b = Yw[:, j], act[:, j]
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel < 1e-8, (B, j, rel)
        # locked columns untouched
        np.testing.assert_array_equal(Yw[:, :locked],
                                      np.asarray(V)[:, :locked])
