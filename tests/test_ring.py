"""Ring collective matmul tests (P11 compute/comm overlap) — the
shard_map/ppermute rings on the 8-device virtual mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import chase_tpu
from chase_tpu.parallel.ring import ring_hemm


def test_ring_hemm_matches_dense():
    grid = chase_tpu.make_grid(jax.devices(), shape=(8, 1))
    N, k = 512, 64
    H = np.random.default_rng(0).standard_normal((N, N))
    V = np.random.default_rng(1).standard_normal((N, k))
    Hs = jax.device_put(H, grid.sharding("r", None))
    Vs = jax.device_put(V, grid.sharding("r", None))
    W = ring_hemm(grid, Hs, Vs)
    np.testing.assert_allclose(np.asarray(W), H @ V, rtol=1e-10, atol=1e-10)
    assert W.sharding.spec == jax.sharding.PartitionSpec("r", None)


def test_ring_hemm_complex():
    grid = chase_tpu.make_grid(jax.devices()[:4], shape=(4, 1))
    N, k = 256, 32
    rng = np.random.default_rng(2)
    H = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    H = (H + H.conj().T) / 2
    V = rng.standard_normal((N, k)) + 1j * rng.standard_normal((N, k))
    Hs = jax.device_put(H, grid.sharding("r", None))
    Vs = jax.device_put(V, grid.sharding("r", None))
    W = ring_hemm(grid, Hs, Vs)
    np.testing.assert_allclose(np.asarray(W), H @ V, rtol=1e-10, atol=1e-10)


def test_ring_integrated_filter_matches_dense():
    """The shard_map ring filter must reproduce the dense filter exactly
    (up to reduction order) including degree-0 passthrough columns."""
    import jax.numpy as jnp
    from chase_tpu.parallel.ring import chebyshev_filter_ring
    from chase_tpu.ops.filter import chebyshev_filter
    from chase_tpu.models import clement

    grid = chase_tpu.make_grid(jax.devices(), shape=(8, 1))
    N, k = 512, 64
    H = clement(N)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, k))
    deg = np.full(k, 14, np.int32)
    deg[:4] = 0
    Hs = jax.device_put(H, grid.sharding("r", None))
    Xs = jax.device_put(X, grid.sharding("r", None))
    args = (np.float64(-(N - 1)), np.float64(0.0), np.float64(float(N)))
    Yr = np.asarray(chebyshev_filter_ring(grid, Hs, Xs, jnp.asarray(deg),
                                          *args, jnp.int32(14)))
    Yd = np.asarray(chebyshev_filter(jnp.asarray(H), jnp.asarray(X),
                                     jnp.asarray(deg), *args, jnp.int32(14)))
    scale = np.abs(Yd).max()
    assert np.abs(Yr - Yd).max() / scale < 1e-13
    np.testing.assert_array_equal(Yr[:, 0], X[:, 0])   # degree-0 passthrough


def test_chebyshev_filter_ring_matches_reference_filter():
    """The ring-integrated filter must match ops.filter.chebyshev_filter."""
    import jax
    import jax.numpy as jnp
    from chase_tpu.parallel.mesh import make_grid
    from chase_tpu.parallel.ring import chebyshev_filter_ring
    from chase_tpu.ops.filter import chebyshev_filter

    grid = make_grid(jax.devices(), shape=(8, 1))
    N, k = 128, 12
    rng = np.random.default_rng(3)
    H = np.asarray((lambda a: (a + a.T) / 2)(rng.standard_normal((N, N))))
    X = rng.standard_normal((N, k))
    w = np.linalg.eigvalsh(H)
    lam1, lo, up = w[0], w[k], w[-1]
    degrees = np.full(k, 10, np.int32)
    degrees[:3] = 4                     # mixed degrees exercise the masks
    Hs = jax.device_put(jnp.asarray(H), grid.sharding("r", None))
    Xs = jax.device_put(jnp.asarray(X), grid.sharding("r", None))
    Yr = np.asarray(chebyshev_filter_ring(
        grid, Hs, Xs, jnp.asarray(degrees), lam1, lo, up, 10))
    Yd = np.asarray(chebyshev_filter(
        jnp.asarray(H), jnp.asarray(X), jnp.asarray(degrees),
        lam1, lo, up, jnp.int32(10)))
    np.testing.assert_allclose(Yr, Yd, rtol=1e-10, atol=1e-12)


def test_solver_ring_filter_e2e():
    """eigsh with ring_filter=True on a (8,1) mesh converges to the exact
    Clement spectrum."""
    import jax
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues
    grid = chase_tpu.make_grid(jax.devices(), shape=(8, 1))
    cfg = chase_tpu.ChaseConfig(ring_filter=True)
    res = chase_tpu.eigsh(clement(192), 12, 12, tol=1e-10, config=cfg,
                          grid=grid)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(192)[:12],
                               atol=1e-7)


@pytest.mark.slow
def test_combined_features_e2e():
    """Everything at once on the mesh: block-cyclic layout + ring filter
    (1D grid) + TSQR availability + host small-dense + warm start."""
    import jax
    import chase_tpu
    from chase_tpu.parallel.layouts import BlockCyclicLayout
    from chase_tpu.models import clement, clement_eigenvalues

    N, nev, nex, mb = 192, 10, 10, 16
    grid = chase_tpu.make_grid(jax.devices(), shape=(8, 1))
    layout = BlockCyclicLayout(N, mb, 8, 1)
    H = np.asarray(layout.apply(clement(N)))
    cfg = chase_tpu.ChaseConfig(ring_filter=True,
                                small_dense_backend="host",
                                qr_check_ortho=True)
    r1 = chase_tpu.eigsh(H, nev, nex, tol=1e-10, config=cfg, grid=grid)
    assert r1.converged
    np.testing.assert_allclose(r1.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-7)
    r2 = chase_tpu.eigsh(H, nev, nex, tol=1e-10, config=cfg, grid=grid,
                         v0=np.asarray(r1.V), ritzv0=r1.ritzv_full,
                         approx=True)
    assert r2.converged and r2.iterations <= r1.iterations


# ---------------------------------------------------------------------------
# 2D ping-pong collective matmul filter (P4 + P11 on the production mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
def test_chebyshev_filter_ring2d_matches_reference_filter(shape):
    """The A/B-parity ping-pong filter must match ops.filter.chebyshev_filter
    on a genuine 2D mesh, including heterogeneous degrees (parity flips of
    frozen columns) and both odd and even max degrees."""
    import jax
    import jax.numpy as jnp
    from chase_tpu.parallel.mesh import make_grid
    from chase_tpu.parallel.ring import chebyshev_filter_ring2d
    from chase_tpu.ops.filter import chebyshev_filter

    grid = make_grid(jax.devices(), shape=shape)
    N, k = 128, 12
    rng = np.random.default_rng(7)
    H = np.asarray((lambda a: (a + a.T) / 2)(rng.standard_normal((N, N))))
    X = rng.standard_normal((N, k))
    w = np.linalg.eigvalsh(H)
    lam1, lo, up = w[0], w[k], w[-1]
    for degs in ([10, 10, 10, 4, 4, 6, 0, 8, 10, 2, 10, 10],   # even max
                 [9, 9, 3, 5, 0, 7, 9, 1, 9, 9, 9, 9]):        # odd max
        degrees = np.asarray(degs, np.int32)
        Hs = jax.device_put(jnp.asarray(H), grid.sharding("r", "c"))
        Xs = jax.device_put(jnp.asarray(X), grid.sharding("r", None))
        Yr = np.asarray(chebyshev_filter_ring2d(
            grid, Hs, Xs, jnp.asarray(degrees), lam1, lo, up,
            int(degrees.max())))
        Yd = np.asarray(chebyshev_filter(
            jnp.asarray(H), jnp.asarray(X), jnp.asarray(degrees),
            lam1, lo, up, jnp.int32(int(degrees.max()))))
        np.testing.assert_allclose(Yr, Yd, rtol=1e-10, atol=1e-12)


def test_ring2d_complex_hermitian():
    """The B-parity step uses Hermiticity (tileᴴ) — verify on complex H."""
    import jax
    import jax.numpy as jnp
    from chase_tpu.parallel.mesh import make_grid
    from chase_tpu.parallel.ring import chebyshev_filter_ring2d
    from chase_tpu.ops.filter import chebyshev_filter

    grid = make_grid(jax.devices(), shape=(2, 4))
    N, k = 96, 8
    rng = np.random.default_rng(8)
    H = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    H = (H + H.conj().T) / 2
    X = rng.standard_normal((N, k)) + 1j * rng.standard_normal((N, k))
    w = np.linalg.eigvalsh(H)
    lam1, lo, up = w[0], w[k], w[-1]
    degrees = np.full(k, 8, np.int32)
    Hs = jax.device_put(jnp.asarray(H), grid.sharding("r", "c"))
    Xs = jax.device_put(jnp.asarray(X), grid.sharding("r", None))
    Yr = np.asarray(chebyshev_filter_ring2d(
        grid, Hs, Xs, jnp.asarray(degrees), lam1, lo, up, 8))
    Yd = np.asarray(chebyshev_filter(
        jnp.asarray(H), jnp.asarray(X), jnp.asarray(degrees),
        lam1, lo, up, jnp.int32(8)))
    np.testing.assert_allclose(Yr, Yd, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_ring_mixed_precision_shadow(mode):
    """Ring filters accept a reduced-precision H shadow (f32 H, f64 carry
    block per filter_carry_dtype semantics: whole recurrence in f32)."""
    import jax
    import jax.numpy as jnp
    from chase_tpu.parallel.mesh import make_grid
    from chase_tpu.parallel.ring import (chebyshev_filter_ring,
                                         chebyshev_filter_ring2d)
    from chase_tpu.ops.filter import chebyshev_filter

    shape = (8, 1) if mode == "1d" else (4, 2)
    grid = make_grid(jax.devices(), shape=shape)
    N, k = 128, 8
    rng = np.random.default_rng(9)
    H = np.asarray((lambda a: (a + a.T) / 2)(rng.standard_normal((N, N))))
    X = rng.standard_normal((N, k))
    w = np.linalg.eigvalsh(H)
    lam1, lo, up = w[0], w[k], w[-1]
    degrees = np.full(k, 8, np.int32)
    H32 = H.astype(np.float32)
    hshard = grid.sharding("r", None) if mode == "1d" \
        else grid.sharding("r", "c")
    Hs = jax.device_put(jnp.asarray(H32), hshard)
    Xs = jax.device_put(jnp.asarray(X), grid.sharding("r", None))
    fn = chebyshev_filter_ring if mode == "1d" else chebyshev_filter_ring2d
    Yr = np.asarray(fn(grid, Hs, Xs, jnp.asarray(degrees),
                       lam1, lo, up, 8))
    assert Yr.dtype == np.float64          # cast back to the problem dtype
    Yd = np.asarray(chebyshev_filter(
        jnp.asarray(H32), jnp.asarray(X), jnp.asarray(degrees),
        lam1, lo, up, jnp.int32(8)))
    # f32 carry: agree to f32 accuracy (summation order differs)
    scale = np.linalg.norm(Yd, axis=0).max()
    assert np.abs(Yr - Yd).max() / scale < 1e-5


@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_ring_mixed_dtype_preserves_locked_columns_bitexact(mode):
    """Degree-0 (locked) f64 columns must pass through the ring filters
    BIT-EXACTLY even when H is a reduced-precision shadow — the f32 carry
    must not round-trip converged columns (their residuals are never
    recomputed after locking)."""
    import jax
    import jax.numpy as jnp
    from chase_tpu.parallel.mesh import make_grid
    from chase_tpu.parallel.ring import (chebyshev_filter_ring,
                                         chebyshev_filter_ring2d)

    shape = (8, 1) if mode == "1d" else (4, 2)
    grid = make_grid(jax.devices(), shape=shape)
    N, k = 128, 8
    rng = np.random.default_rng(11)
    H = np.asarray((lambda a: (a + a.T) / 2)(rng.standard_normal((N, N))))
    X = rng.standard_normal((N, k))          # f64: a round-trip would lose bits
    w = np.linalg.eigvalsh(H)
    degrees = np.full(k, 8, np.int32)
    degrees[:3] = 0                          # "locked" columns
    hshard = grid.sharding("r", None) if mode == "1d" \
        else grid.sharding("r", "c")
    Hs = jax.device_put(jnp.asarray(H.astype(np.float32)), hshard)
    Xs = jax.device_put(jnp.asarray(X), grid.sharding("r", None))
    fn = chebyshev_filter_ring if mode == "1d" else chebyshev_filter_ring2d
    Yr = np.asarray(fn(grid, Hs, Xs, jnp.asarray(degrees),
                       w[0], w[k], w[-1], 8))
    np.testing.assert_array_equal(Yr[:, :3], X[:, :3])
    assert np.abs(Yr[:, 3:] - X[:, 3:]).max() > 0   # active columns filtered


def test_solver_ring2d_e2e():
    """eigsh with ring_filter=True on a 4x2 mesh converges to the exact
    Clement spectrum at DP tolerance."""
    import jax
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues
    grid = chase_tpu.make_grid(jax.devices(), shape=(4, 2))
    cfg = chase_tpu.ChaseConfig(ring_filter=True)
    res = chase_tpu.eigsh(clement(192), 12, 12, tol=1e-10, config=cfg,
                          grid=grid)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(192)[:12],
                               atol=1e-7)


def test_solver_ring2d_with_mixed_precision_e2e():
    """Ring filter + mixed precision combined (the round-1 gap: the ring
    silently disengaged when H_low was active).  refine_filter=False keeps
    the ring path selected; with it on, the deviation filter takes
    precedence by design."""
    import jax
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues
    grid = chase_tpu.make_grid(jax.devices(), shape=(4, 2))
    cfg = chase_tpu.ChaseConfig(ring_filter=True, mixed_precision=True,
                                refine_filter=False)
    res = chase_tpu.eigsh(clement(192), 12, 12, tol=1e-8, config=cfg,
                          grid=grid)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(192)[:12],
                               atol=1e-6)


def test_ring_mode_selection():
    """_ring_mode: 1D for (p,1), 2D for r x c with r*c | N, None otherwise."""
    import chase_tpu
    from chase_tpu.solver import _ring_mode

    g81 = chase_tpu.make_grid(jax.devices(), shape=(8, 1))
    g42 = chase_tpu.make_grid(jax.devices(), shape=(4, 2))
    assert _ring_mode(None, 128) is None
    assert _ring_mode(g81, 128) == "1d"
    assert _ring_mode(g81, 127) is None      # N not divisible by r
    assert _ring_mode(g42, 128) == "2d"
    assert _ring_mode(g42, 124) is None      # N not divisible by r*c


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)], ids=["1d", "2d"])
def test_refine_ring_matches_flat_refine(shape):
    """chebyshev_filter_refine_ring(2d) must apply the identical deviation
    polynomial as ops.filter.chebyshev_filter_refine (ring x refine
    composition)."""
    import chase_tpu
    from chase_tpu.ops import filter as filt
    from chase_tpu.parallel.ring import (chebyshev_filter_refine_ring,
                                         chebyshev_filter_refine_ring2d)

    N, w = 128, 12
    rng = np.random.default_rng(0)
    H = rng.standard_normal((N, N))
    H = ((H + H.T) / 2).astype(np.float64)
    lam_all = np.linalg.eigvalsh(H)
    V = np.linalg.qr(rng.standard_normal((N, w)))[0]
    ritz = np.linspace(lam_all[0], lam_all[w], w)
    R = (H @ V - V * ritz[None, :]) * 1e-3
    degrees = np.asarray([0, 0, 4, 4, 6, 6, 8, 8, 8, 10, 10, 10], np.int32)
    lam1, lo, up = float(lam_all[0]), float(lam_all[w * 2]), \
        float(lam_all[-1] * 1.01)
    a1, al, be, inj, pf = filt.refine_tables(
        ritz, degrees, lam1, lo, up, 12)

    H_low = jnp.asarray(H, jnp.float32)
    Y_flat = filt.chebyshev_filter_refine(
        H_low, jnp.asarray(V), jnp.asarray(R), jnp.asarray(degrees),
        a1, al, be, inj, pf, (up + lo) / 2, jnp.int32(10))

    grid = chase_tpu.make_grid(jax.devices(), shape=shape)
    Hs = jax.device_put(H_low, grid.sharding("r", "c"))
    ring_fn = (chebyshev_filter_refine_ring if shape[1] == 1
               else chebyshev_filter_refine_ring2d)
    Y_ring = ring_fn(grid, Hs, jnp.asarray(V), jnp.asarray(R),
                     jnp.asarray(degrees), a1, al, be, inj, pf,
                     (up + lo) / 2, jnp.int32(10))
    np.testing.assert_allclose(np.asarray(Y_ring), np.asarray(Y_flat),
                               rtol=0, atol=2e-5 * np.abs(Y_flat).max())
    # degree-0 columns bit-exact
    np.testing.assert_array_equal(np.asarray(Y_ring)[:, :2], V[:, :2])


def test_solver_refine_ring_dp_e2e():
    """DP 1e-10 ladder ON a 2D grid with the ring engaged (auto): the
    refinement filter must route through the ring and still converge to
    the DP tolerance (weak #2 closed: ring x refine compose)."""
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    grid = chase_tpu.make_grid(jax.devices(), shape=(4, 2))
    cfg = chase_tpu.ChaseConfig(mixed_precision=True)   # ring_filter auto
    N = 192
    res = chase_tpu.eigsh(clement(N).astype(np.float64), 12, 12, tol=1e-10,
                          config=cfg, grid=grid)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:12],
                               atol=1e-8)


def test_ring_auto_on_and_opt_out():
    """ring_filter=None (default) auto-engages on eligible grids; False
    opts out; spectra identical either way."""
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    grid = chase_tpu.make_grid(jax.devices(), shape=(4, 2))
    N = 192
    H = clement(N)
    r_auto = chase_tpu.eigsh(H, 10, 10, tol=1e-10, grid=grid)
    r_off = chase_tpu.eigsh(H, 10, 10, tol=1e-10, grid=grid,
                            config=chase_tpu.ChaseConfig(ring_filter=False))
    assert r_auto.converged and r_off.converged
    np.testing.assert_allclose(r_auto.ritzv, clement_eigenvalues(N)[:10],
                               atol=1e-7)
    np.testing.assert_allclose(r_auto.ritzv, r_off.ritzv, atol=1e-8)


def test_windowed_ring_matches_unwindowed():
    """The ring filter on the padded right-aligned window (P12 on grids)
    must produce the same spectrum as the full-width ring (small col_block
    forces several window shrinks as columns lock)."""
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    grid = chase_tpu.make_grid(jax.devices(), shape=(8, 1))
    N = 192
    H = clement(N)
    cfg_win = chase_tpu.ChaseConfig(ring_filter=True, col_block=8)
    res = chase_tpu.eigsh(H, 12, 12, tol=1e-10, config=cfg_win, grid=grid)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:12],
                               atol=1e-7)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)], ids=["1d", "2d"])
def test_h2_ring_matches_flat_filter(shape):
    """chebyshev_filter_h2_ring(2d) must equal ops.pseudo.chebyshev_
    filter_h2 (P11 on the BSE path; the 2D schedule's Hᴴ step is
    S-flip-corrected since pseudo-Hermitian H is not Hermitian)."""
    import chase_tpu
    from chase_tpu.ops import pseudo as ps
    from chase_tpu.models import random_pseudo_hermitian
    from chase_tpu.parallel.ring import (chebyshev_filter_h2_ring,
                                         chebyshev_filter_h2_ring2d)

    N, w = 128, 10
    H = np.asarray(random_pseudo_hermitian(N, dtype=np.float64, seed=0))
    rng = np.random.default_rng(1)
    X = np.linalg.qr(rng.standard_normal((N, w)))[0]
    degrees = np.asarray([0, 0, 4, 4, 6, 6, 8, 8, 10, 10], np.int32)
    lam1, lo, up = 0.5, 2.0, 30.0

    Y_flat = ps.chebyshev_filter_h2(
        jnp.asarray(H), jnp.asarray(X), jnp.asarray(degrees),
        lam1, lo, up, jnp.int32(10))

    grid = chase_tpu.make_grid(jax.devices(), shape=shape)
    Hs = jax.device_put(jnp.asarray(H), grid.sharding("r", "c"))
    ring_fn = (chebyshev_filter_h2_ring if shape[1] == 1
               else chebyshev_filter_h2_ring2d)
    Y_ring = ring_fn(grid, Hs, jnp.asarray(X), jnp.asarray(degrees),
                     lam1, lo, up, jnp.int32(10))
    np.testing.assert_allclose(np.asarray(Y_ring), np.asarray(Y_flat),
                               rtol=0, atol=1e-10 * np.abs(Y_flat).max())
    np.testing.assert_array_equal(np.asarray(Y_ring)[:, :2], X[:, :2])


def test_pseudo_solver_ring_e2e():
    """Sharded BSE solve with the H² ring auto-engaged matches the direct
    spectrum (ring x pseudo composition)."""
    import chase_tpu
    from chase_tpu.models import random_pseudo_hermitian

    grid = chase_tpu.make_grid(jax.devices(), shape=(4, 2))
    N, nev, nex = 128, 6, 6
    H = np.asarray(random_pseudo_hermitian(N, dtype=np.float64, seed=2))
    res = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-9, grid=grid)
    assert res.converged
    full = np.sort(np.linalg.eigvals(H).real)
    pos = full[full > 0][:nev]
    np.testing.assert_allclose(np.asarray(res.ritzv), pos, atol=1e-7)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)], ids=["1d", "2d"])
def test_h2_ring_bf16_rung_matches_flat(shape):
    """The H² rings with a bf16 H shadow (reduced matmul inputs, f32 carry
    via filter_carry_dtype) match the flat bf16 H² filter to f32-reduction-
    order tolerance, and keep degree-0 columns bit-exact."""
    import chase_tpu
    from chase_tpu.ops import pseudo as ps
    from chase_tpu.models import random_pseudo_hermitian
    from chase_tpu.parallel.ring import (chebyshev_filter_h2_ring,
                                         chebyshev_filter_h2_ring2d)

    N, w = 128, 10
    H = np.asarray(random_pseudo_hermitian(N, dtype=np.float64, seed=0),
                   np.float32)
    rng = np.random.default_rng(1)
    X = np.asarray(np.linalg.qr(rng.standard_normal((N, w)))[0], np.float32)
    degrees = np.asarray([0, 0, 4, 4, 6, 6, 8, 8, 10, 10], np.int32)
    lam1, lo, up = 0.5, 2.0, 30.0
    Hbf = jnp.asarray(H, jnp.bfloat16)

    Y_flat = ps.chebyshev_filter_h2(
        Hbf, jnp.asarray(X), jnp.asarray(degrees),
        lam1, lo, up, jnp.int32(10), precision="default")

    grid = chase_tpu.make_grid(jax.devices(), shape=shape)
    Hs = jax.device_put(Hbf, grid.sharding("r", "c"))
    ring_fn = (chebyshev_filter_h2_ring if shape[1] == 1
               else chebyshev_filter_h2_ring2d)
    Y_ring = ring_fn(grid, Hs, jnp.asarray(X), jnp.asarray(degrees),
                     lam1, lo, up, jnp.int32(10), precision="default")
    assert np.asarray(Y_ring).dtype == np.float32     # carry stayed f32
    # the ring rounds the circulating chunk to bf16 per BLOCK while the
    # flat path rounds whole intermediates — eps_bf16-scale differences
    np.testing.assert_allclose(np.asarray(Y_ring), np.asarray(Y_flat),
                               rtol=0, atol=1e-4 * np.abs(Y_flat).max())
    np.testing.assert_array_equal(np.asarray(Y_ring)[:, :2], X[:, :2])


def test_pseudo_solver_ring_bf16_e2e():
    """Sharded f32 BSE solve with the bf16 H² rung riding the ring filter
    (ring x pseudo x P10 composition) matches the direct spectrum."""
    import chase_tpu
    from chase_tpu.models import random_pseudo_hermitian

    grid = chase_tpu.make_grid(jax.devices(), shape=(4, 2))
    N, nev, nex = 128, 6, 6
    H = np.asarray(random_pseudo_hermitian(N, dtype=np.float32, seed=2))
    cfg = chase_tpu.ChaseConfig(bf16_filter=True)
    res = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-4, config=cfg,
                                 grid=grid, collect_perf=True)
    assert res.converged
    full = np.sort(np.linalg.eigvals(H.astype(np.float64)).real)
    pos = full[full > 0][:nev]
    np.testing.assert_allclose(res.ritzv, pos, atol=1e-3)
    assert res.perf.filtered_vecs_low > 0
