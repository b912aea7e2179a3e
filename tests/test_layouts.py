"""Block-cyclic layout tests (mirrors the reference's BlockCyclicMatrix /
distMultiVector block-cyclic container tests: layout math + solve parity)."""

import numpy as np
import pytest

import chase_tpu
from chase_tpu.parallel.layouts import block_cyclic_perm, BlockCyclicLayout
from chase_tpu.models import clement, clement_eigenvalues


def test_ownership_matches_scalapack_convention():
    n, nb, p = 20, 3, 4
    perm = block_cyclic_perm(n, nb, p)
    # after permutation, contiguous quarter q must hold exactly the indices
    # with (g // nb) % p == q
    sizes = [len([g for g in range(n) if (g // nb) % p == q])
             for q in range(p)]
    start = 0
    for q, sz in enumerate(sizes):
        got = sorted(perm[start:start + sz])
        want = [g for g in range(n) if (g // nb) % p == q]
        assert got == want, q
        start += sz


def test_block_cyclic_solve_parity():
    N, nev, nex, mb = 192, 12, 8, 16
    H = clement(N)
    grid = chase_tpu.make_grid()
    layout = BlockCyclicLayout(N, mb, grid.shape["r"], grid.shape["c"])
    Hbc = np.asarray(layout.apply(H))
    res = chase_tpu.eigsh(Hbc, nev, nex, tol=1e-10, grid=grid)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N)[:nev],
                               atol=1e-7)
    # eigenvectors restored to the user's global row ordering solve H itself
    V = np.asarray(layout.restore_rows(np.asarray(res.V)[:, :nev]))
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-7


def test_pseudo_block_cyclic_solve_parity():
    """PseudoBlockCyclicLayout: S-metric-preserving per-half permutation —
    BSE solve on the permuted operator matches the unpermuted spectrum and
    the restored eigenvectors solve the original problem."""
    from chase_tpu.parallel.layouts import PseudoBlockCyclicLayout
    from chase_tpu.models import random_pseudo_hermitian

    N, nev, nex, mb = 128, 10, 8, 8
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=3)
    grid = chase_tpu.make_grid()
    layout = PseudoBlockCyclicLayout(N, mb, grid.shape["r"],
                                     grid.shape["c"])
    # the permutation must never cross the S halves
    assert np.all(layout.row_perm[:N // 2] < N // 2)
    assert np.all(layout.row_perm[N // 2:] >= N // 2)
    Hbc = np.asarray(layout.apply(H))
    # permuted operator retains the BSE block structure
    n2 = N // 2
    np.testing.assert_allclose(Hbc[n2:, n2:], -Hbc[:n2, :n2].conj(),
                               atol=1e-14)
    np.testing.assert_allclose(Hbc[n2:, :n2], -Hbc[:n2, n2:].conj(),
                               atol=1e-14)

    ref = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-9)
    res = chase_tpu.eigsh_pseudo(Hbc, nev, nex, tol=1e-9, grid=grid)
    assert ref.converged and res.converged
    np.testing.assert_allclose(res.ritzv, ref.ritzv, atol=1e-7)
    V = np.asarray(layout.restore_rows(np.asarray(res.V)[:, :nev]))
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 1e-6


def test_block_cyclic_vector_1d_roundtrip_and_warm_start():
    """BlockCyclicVector1D: owner-order round trip, matrix-following mode,
    and a v0 given in block-cyclic owner order feeding a solve."""
    from chase_tpu.parallel.layouts import BlockCyclicVector1D

    N, k, mb, p = 96, 7, 8, 4
    rng = np.random.default_rng(0)
    V = rng.standard_normal((N, k))
    vec = BlockCyclicVector1D(N, mb, p)
    np.testing.assert_array_equal(
        np.asarray(vec.from_owner_order(vec.to_owner_order(V))), V)
    # contiguous quarter q of the owner order holds the cyclically owned rows
    owned = np.asarray(vec.to_owner_order(np.arange(N)[:, None]))[:, 0]
    sizes = np.bincount((np.arange(N) // mb) % p, minlength=p)
    start = 0
    for q in range(p):
        got = sorted(owned[start:start + sizes[q]])
        want = [g for g in range(N) if (g // mb) % p == q]
        assert got == want
        start += sizes[q]

    # matrix-following mode: must equal the matrix row permutation
    N2, mb2 = 192, 16
    grid = chase_tpu.make_grid()
    layout = BlockCyclicLayout(N2, mb2, grid.shape["r"], grid.shape["c"])
    vec2 = BlockCyclicVector1D(N2, mb2, grid.shape["r"], like=layout)
    np.testing.assert_array_equal(vec2.perm, layout.row_perm)

    # e2e: v0 prepared in the matrix ownership order drives the solve
    H = clement(N2)
    Hbc = np.asarray(layout.apply(H))
    v0 = rng.standard_normal((N2, 20))
    res = chase_tpu.eigsh(Hbc, 12, 8, tol=1e-10, grid=grid,
                          v0=np.asarray(vec2.to_owner_order(v0)))
    assert res.converged
    np.testing.assert_allclose(res.ritzv, clement_eigenvalues(N2)[:12],
                               atol=1e-7)


def test_pseudo_pad_to_grid_tile():
    """S-preserving pad: a BSE problem whose half
    size does not divide the mesh tile pads each half independently with
    decoupled ±g phantom pairs (displaced outside the wanted window) —
    spectra identical to the unsharded solve, eigenvectors returned at the
    caller's N.  Reference analogue: any-N block-cyclic BSE layouts
    (linalg/distMatrix/distMatrix.hpp:2867)."""
    import jax
    from chase_tpu.models import random_pseudo_hermitian
    from chase_tpu.parallel.operator import DenseOperator

    N, nev, nex = 204, 12, 8        # N/2 = 102, not divisible by 8
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=3)
    grid = chase_tpu.make_grid(jax.devices(), shape=(2, 4))
    op = DenseOperator(H, grid=grid, pseudo_hermitian=True)
    assert op.N_orig == N and op.N % (2 * 8) == 0 and op.N > N
    # padded operator is still pseudo-Hermitian w.r.t. its padded S
    Hp = np.asarray(op.H)
    S = np.ones(op.N); S[op.N // 2:] = -1
    np.testing.assert_allclose(S[:, None] * Hp * S[None, :], Hp.T,
                               atol=1e-12)
    res = chase_tpu.eigsh_pseudo(op, nev, nex, tol=1e-10)
    r0 = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, r0.ritzv, atol=1e-9)
    V = np.asarray(res.V)[:, :nev]
    assert V.shape[0] == N            # unpadded back to the caller's size
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 5e-9


def test_pseudo_pad_warm_start_roundtrip():
    """place_block/unpad_block on a padded pseudo operator: a previous
    solve's V warm-starts a repeat solve on the same padded grid."""
    import jax
    from chase_tpu.models import random_pseudo_hermitian
    from chase_tpu.parallel.operator import DenseOperator

    N, nev, nex = 204, 10, 6
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=4)
    grid = chase_tpu.make_grid(jax.devices(), shape=(8, 1))
    op = DenseOperator(H, grid=grid, pseudo_hermitian=True)
    X = np.random.default_rng(0).standard_normal((N, 4))
    rt = np.asarray(op.unpad_block(op.place_block(X)))
    np.testing.assert_allclose(rt, X, atol=0)
