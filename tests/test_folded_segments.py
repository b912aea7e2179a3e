"""Direct parity tests for the dispatch-folded segment programs.

The folded kernels (ops/filter.filter_seg_* / refine_seg_*,
ops/pseudo.h2_seg_* / refine_h2_seg_steps) fuse window slice + recurrence
segment + masked write-back + carry shrink into ONE XLA program each to cut
per-dispatch overhead.  These tests pin them against the unfolded
whole-window kernels (chebyshev_filter / chebyshev_filter_refine /
chebyshev_filter_h2 / chebyshev_filter_refine_h2): identical polynomial,
identical per-column reduction order, so parity is near-bit-exact on CPU.

Mirrors the reference's per-kernel unit-test discipline
(tests/linalg/internal/*/hemm.cpp) applied to the retirement machinery of
algorithm.inc:974-1000.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from chase_tpu.ops import filter as filt
from chase_tpu.ops import pseudo as ps

pytestmark = pytest.mark.quick


def _sym(rng, n, dtype=np.float64):
    A = rng.standard_normal((n, n)).astype(dtype)
    return (A + A.T) / 2


def _percol_close(got, want, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    for j in range(got.shape[1]):
        den = max(np.linalg.norm(want[:, j]), 1e-300)
        rel = np.linalg.norm(got[:, j] - want[:, j]) / den
        assert rel < tol, (j, rel)


def test_filter_seg_init_steps_with_shrink_matches_plain():
    """filter_seg_init + two filter_seg_steps (one mid-run bucket shrink)
    == chebyshev_filter on the same window; columns outside untouched."""
    rng = np.random.default_rng(3)
    N, k = 80, 24
    H = jnp.asarray(_sym(rng, N))
    V = jnp.asarray(rng.standard_normal((N, k)))
    w_evs = np.linalg.eigvalsh(np.asarray(H))
    lam, lo, up = w_evs[0], w_evs[k], w_evs[-1]

    start, w_pad = 8, 16
    deg_win = np.array([0, 0, 4, 4, 4, 4, 6, 6, 8, 8, 10, 10, 12, 12, 12, 12],
                       np.int32)
    c = np.asarray((up + lo) / 2, np.float64)
    e = np.asarray((up - lo) / 2, np.float64)
    sigma1 = np.asarray(e / (lam - c), np.float64)

    V_np = np.asarray(V)
    want_win = filt.chebyshev_filter(
        H, jnp.array(V[:, start:start + w_pad], copy=True),
        jnp.asarray(deg_win), lam, lo, up, int(deg_win.max()))
    X0, Xp, Yc, sigma = filt.filter_seg_init(
        H, V, jnp.int32(start), jnp.asarray(deg_win), c, e, sigma1,
        w_pad=w_pad)
    # segment 1: steps t in [2, 5) at full width, write back at `start`
    V1, X0, Xp, Yc, sigma = filt.filter_seg_steps(
        H, V, X0, Xp, Yc, jnp.asarray(deg_win), sigma, sigma1, c, e,
        jnp.int32(0), jnp.int32(start), jnp.int32(2), jnp.int32(5),
        w_new=w_pad)
    # shrink: retire the left 4-column bucket (deg <= 4 all done at t=4),
    # fold the slice into segment 2 covering steps [5, 13)
    deg2 = deg_win[4:]
    V2, X0, Xp, Yc, sigma = filt.filter_seg_steps(
        H, V1, X0, Xp, Yc, jnp.asarray(deg2), sigma, sigma1, c, e,
        jnp.int32(4), jnp.int32(start + 4), jnp.int32(5), jnp.int32(13),
        w_new=w_pad - 4)

    got = np.asarray(V2)
    _percol_close(got[:, start:start + w_pad], want_win)
    # everything outside the window bit-exact
    np.testing.assert_array_equal(got[:, :start], V_np[:, :start])
    # degree-0 pad columns bit-exact
    np.testing.assert_array_equal(got[:, start:start + 2],
                                  V_np[:, start:start + 2])


@pytest.mark.parametrize("B", [4, 8, 24])
def test_refine_windowed_matches_unfolded(B):
    """solver._filter_refine_windowed (folded refine_seg_* plan) ==
    chebyshev_filter_refine on the padded window."""
    from chase_tpu.solver import _filter_refine_windowed, _window_pad

    rng = np.random.default_rng(11)
    N, nevex, locked = 96, 24, 5
    H = jnp.asarray(_sym(rng, N))
    evs, evecs = np.linalg.eigh(np.asarray(H))
    # near-converged basis: eigenvectors + small noise, Ritz values close
    Vn = evecs[:, :nevex] + 1e-4 * rng.standard_normal((N, nevex))
    V = jnp.asarray(Vn)
    ritzv = np.sum(Vn * (np.asarray(H) @ Vn), axis=0) / np.sum(Vn * Vn,
                                                               axis=0)
    R = jnp.asarray(np.asarray(H) @ Vn - Vn * ritzv[None, :])
    lam, lo, up = evs[0], evs[nevex], evs[-1]
    max_deg = 18
    degrees_act = np.sort(rng.integers(2, max_deg // 2,
                                       size=nevex - locked)) * 2

    w_pad, start = _window_pad(nevex, locked, B)
    Vg, n_exec = _filter_refine_windowed(
        H, jnp.array(V, copy=True), R, ritzv[locked:], degrees_act,
        locked, nevex, B, lam, lo, up, max_deg, "highest")
    assert n_exec >= int(degrees_act.sum()) - int(degrees_act.max())

    deg_win = np.zeros(w_pad, np.int32)
    deg_win[locked - start:] = degrees_act
    ritz_win = np.zeros(w_pad)
    ritz_win[locked - start:] = ritzv[locked:]
    a1e, al, be, inj, pf = filt.refine_tables(
        ritz_win, deg_win, lam, lo, up, max_deg)
    want = filt.chebyshev_filter_refine(
        H, V[:, start:start + w_pad], R[:, start:start + w_pad],
        jnp.asarray(deg_win), a1e, al, be, inj, pf,
        (up + lo) / 2.0, int(deg_win.max()))
    got = np.asarray(Vg)
    _percol_close(got[:, start:start + w_pad], want)
    np.testing.assert_array_equal(got[:, :locked],
                                  np.asarray(V)[:, :locked])


def _pseudo_setup(rng, N=64, k=16):
    from chase_tpu.models import random_pseudo_hermitian
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=5)
    evs = np.linalg.eigvals(np.asarray(H, np.float64))
    mu = np.sort(np.real(evs) ** 2)
    V = jnp.asarray(rng.standard_normal((N, k)))
    lam1 = float(mu[0]) * 0.9
    lower = float(mu[k])
    b_sup = float(mu[-1]) * 1.02
    return jnp.asarray(np.asarray(H, np.float64)), V, lam1, lower, b_sup


@pytest.mark.parametrize("B", [4, 16])
def test_h2_filter_windowed_matches_unfolded(B):
    """solver_pseudo._h2_filter_windowed (folded h2_seg_* plan) ==
    chebyshev_filter_h2 on the window."""
    from chase_tpu.solver_pseudo import _h2_filter_windowed

    rng = np.random.default_rng(13)
    H, V, lam1, lower, b_sup = _pseudo_setup(rng)
    k = V.shape[1]
    locked, u = 3, k - 3            # active = [locked, locked+u)
    right = locked + u
    w_pad = min(k, -(-u // B) * B)
    start = max(0, right - w_pad)
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[locked - start:] = np.sort(
        rng.integers(1, 8, size=u)) * 2

    Vg, n_exec = _h2_filter_windowed(
        H, jnp.array(V, copy=True), deg_win.copy(), start, B, right,
        lam1, lower, b_sup, "highest")
    assert n_exec >= int(deg_win.sum()) - int(deg_win.max())

    want = ps.chebyshev_filter_h2(
        H, jnp.array(V[:, start:start + w_pad], copy=True),
        jnp.asarray(deg_win),
        lam1, lower, b_sup, int(deg_win.max()))
    got = np.asarray(Vg)
    _percol_close(got[:, start:start + w_pad], want)
    np.testing.assert_array_equal(got[:, :start],
                                  np.asarray(V)[:, :start])


@pytest.mark.parametrize("B", [4, 16])
def test_h2_refine_windowed_matches_unfolded(B):
    """solver_pseudo._h2_refine_windowed (folded refine_h2_seg_steps plan)
    == chebyshev_filter_refine_h2 on the window."""
    from chase_tpu.solver_pseudo import _h2_refine_windowed

    rng = np.random.default_rng(17)
    H, V, lam1, lower, b_sup = _pseudo_setup(rng)
    N, k = V.shape
    locked, u = 3, k - 3
    right = locked + u
    w_pad = min(k, -(-u // B) * B)
    start = max(0, right - w_pad)
    offset = locked - start
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[offset:] = np.sort(rng.integers(1, 8, size=u)) * 2
    # plausible Ritz values for the active columns (positive branch)
    theta = np.zeros(w_pad)
    theta[offset:] = np.sqrt(
        np.linspace(lam1 * 1.1, lower * 0.9, u))
    max_deg = 18
    a1e, al, be, inj, pf = filt.refine_tables(
        theta ** 2, deg_win, lam1, lower, b_sup, max_deg)
    X = jnp.array(V[:, start:start + w_pad], copy=True)
    # synthetic small H²-residual seed (the parity is algebraic — any R2)
    R2w = jnp.asarray(1e-3 * rng.standard_normal((N, w_pad)))
    cc_h2 = (b_sup + lower) / 2.0

    want = ps.chebyshev_filter_refine_h2(
        H, jnp.array(X, copy=True), R2w, jnp.asarray(deg_win), a1e, al,
        be, inj, pf, cc_h2, int(deg_win.max()))
    Vg, n_exec = _h2_refine_windowed(
        H, jnp.array(V, copy=True), X, jnp.array(R2w, copy=True),
        deg_win.copy(), start, B, right, a1e, al, be,
        inj, pf, cc_h2, "highest")
    assert n_exec >= int(deg_win.sum()) - int(deg_win.max())
    got = np.asarray(Vg)
    _percol_close(got[:, start:start + w_pad], want)
    np.testing.assert_array_equal(got[:, :start],
                                  np.asarray(V)[:, :start])


def test_refine_seg_bf16_carry_matches_unfolded():
    """Folded refine segments with a bf16-storage H (f32 carry) track the
    unfolded refine kernel — the mixed-precision rung goes through the
    same folded programs."""
    from chase_tpu.solver import _filter_refine_windowed, _window_pad

    rng = np.random.default_rng(23)
    N, nevex, locked, B = 96, 16, 2, 8
    Hf64 = _sym(rng, N)
    H32 = jnp.asarray(Hf64, jnp.float32)
    evs = np.linalg.eigvalsh(Hf64)
    evecs = np.linalg.eigh(Hf64)[1]
    Vn = (evecs[:, :nevex] + 1e-3 * rng.standard_normal((N, nevex))
          ).astype(np.float32)
    V = jnp.asarray(Vn)
    ritzv = (np.sum(Vn * (Hf64 @ Vn), axis=0)
             / np.sum(Vn * Vn, axis=0))
    R = jnp.asarray((Hf64 @ Vn - Vn * ritzv[None, :]).astype(np.float32))
    lam, lo, up = evs[0], evs[nevex], evs[-1]
    max_deg = 10
    degrees_act = np.full(nevex - locked, 8, np.int64)

    Hbf = jnp.asarray(Hf64, jnp.bfloat16)
    Vg, _ = _filter_refine_windowed(
        Hbf, jnp.array(V, copy=True), R, ritzv[locked:], degrees_act,
        locked, nevex, B, lam, lo, up, max_deg, "default")
    assert np.asarray(Vg).dtype == np.float32

    w_pad, start = _window_pad(nevex, locked, B)
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[locked - start:] = degrees_act
    ritz_win = np.zeros(w_pad)
    ritz_win[locked - start:] = ritzv[locked:]
    a1e, al, be, inj, pf = filt.refine_tables(
        ritz_win, deg_win, lam, lo, up, max_deg)
    want = filt.chebyshev_filter_refine(
        Hbf, V[:, start:start + w_pad], R[:, start:start + w_pad],
        jnp.asarray(deg_win), a1e, al, be, inj, pf,
        (up + lo) / 2.0, int(deg_win.max()), precision="default")
    _percol_close(np.asarray(Vg)[:, start:start + w_pad], want, tol=1e-6)


def test_solve_folded_toggle_parity():
    """config.folded_filter=False (round-4 multi-dispatch A/B control)
    converges to the same eigenpairs as the folded default."""
    import chase_tpu
    from chase_tpu.models import clement

    H = np.asarray(clement(128), np.float64)
    nev, nex = 16, 8
    r_fold = chase_tpu.eigsh(H, nev, nex, tol=1e-10,
                             config=chase_tpu.ChaseConfig(folded_filter=True))
    r_unf = chase_tpu.eigsh(H, nev, nex, tol=1e-10,
                            config=chase_tpu.ChaseConfig(folded_filter=False))
    assert r_fold.converged and r_unf.converged
    np.testing.assert_allclose(np.asarray(r_unf.ritzv),
                               np.asarray(r_fold.ritzv), atol=1e-9)
