"""Device-resident fused BSE solver tests."""

import numpy as np
import pytest

import chase_tpu
from chase_tpu.models import random_pseudo_hermitian


def _pos(H, k):
    ev = np.sort(np.linalg.eigvals(
        H.astype(np.complex128 if np.iscomplexobj(H) else np.float64)).real)
    return ev[ev > 0][:k]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_fused_pseudo_matches_spectrum(dtype):
    N, nev, nex = 160, 10, 8
    H = random_pseudo_hermitian(N, dtype=dtype, seed=5)
    res = chase_tpu.eigsh_pseudo_fused(H, nev, nex, tol=1e-9)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, _pos(H, nev), atol=1e-7)
    V = np.asarray(res.V)[:, :nev]
    R = H @ V - V * res.ritzv[None, :].astype(V.dtype)
    assert np.linalg.norm(R, axis=0).max() < 1e-7


@pytest.mark.quick
def test_fused_pseudo_agrees_with_host_driver():
    N, nev, nex = 140, 8, 8
    H = random_pseudo_hermitian(N, dtype=np.complex128, seed=9)
    a = chase_tpu.eigsh_pseudo(H, nev, nex, tol=1e-9)
    b = chase_tpu.eigsh_pseudo_fused(H, nev, nex, tol=1e-9)
    assert a.converged and b.converged
    np.testing.assert_allclose(a.ritzv, b.ritzv, atol=1e-7)


def test_fused_pseudo_multiround_locking():
    """Harder spectrum forcing multiple locking rounds."""
    N, nev, nex = 160, 14, 6
    H = random_pseudo_hermitian(N, dtype=np.complex128, seed=11,
                                coupling=0.4, spread=0.8)
    res = chase_tpu.eigsh_pseudo_fused(H, nev, nex, tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, _pos(H, nev), atol=1e-6)
    assert res.iterations >= 2


def test_fused_pseudo_perf_counters():
    import numpy as np
    import chase_tpu
    from chase_tpu.models import random_pseudo_hermitian
    H = random_pseudo_hermitian(128, dtype=np.float64, seed=2)
    res = chase_tpu.eigsh_pseudo_fused(H, 6, 6, tol=1e-8, collect_perf=True)
    assert res.converged
    assert res.perf is not None and res.perf.matrix_type == 1
    assert res.perf.filtered_vecs > 0
    assert res.perf.iter_count == res.iterations
    assert res.perf.get_flops(128, 25, 4, H.dtype) > 0


def test_fused_pseudo_host_small_dense():
    import numpy as np
    import chase_tpu
    from chase_tpu.models import random_pseudo_hermitian
    H = random_pseudo_hermitian(128, dtype=np.float64, seed=5)
    cfg = chase_tpu.ChaseConfig(small_dense_backend="host")
    res = chase_tpu.eigsh_pseudo_fused(H, 6, 6, tol=1e-8, config=cfg)
    assert res.converged
    exact = np.linalg.eigvals(np.asarray(H, np.float64))
    pos = np.sort(exact.real[exact.real > 0])[:6]
    np.testing.assert_allclose(res.ritzv, pos, atol=1e-6)


def test_fused_pseudo_tiny_block():
    """Regression: 2*(nev+nex) < num_lanczos must not crash the probe
    scan.  (Convergence at k=3 is limited like the reference: the Lanczos
    step count is capped by nev+nex, so the spectral estimate is crude —
    assert the eigenvalues, not full locking.)"""
    import numpy as np
    import chase_tpu
    from chase_tpu.models import random_pseudo_hermitian
    H = random_pseudo_hermitian(64, dtype=np.float64, seed=1)
    res = chase_tpu.eigsh_pseudo_fused(H, 2, 1, tol=1e-8)
    exact = np.linalg.eigvals(H)
    pos = np.sort(exact.real[exact.real > 0])[:2]
    np.testing.assert_allclose(res.ritzv, pos, atol=1e-5)


@pytest.mark.quick
def test_fused_pseudo_refine_ladder_dp():
    """Fused BSE DP 1e-10 solve with the in-graph H² refinement ladder:
    filter FLOPs stay in f32 (deviation recurrence seeded by f64
    H²-residuals) while true residuals reach the DP tolerance — mirrors
    test_fused.test_fused_refine_ladder_dp for the BSE serving path
    (reference runtime-tolerance serving parity,
    chase_c_interface.h:159-175)."""
    N, nev, nex = 192, 16, 12
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=29)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True)
    res = chase_tpu.eigsh_pseudo_fused(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged
    V = np.asarray(res.V)[:, :nev]
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 5e-9
    np.testing.assert_allclose(res.ritzv, _pos(H, nev), atol=1e-8)
    # parity: same tolerance WITHOUT the ladder (pure f64 H² filter)
    res_f64 = chase_tpu.eigsh_pseudo_fused(H, nev, nex, tol=1e-10,
                                           config=chase_tpu.ChaseConfig())
    assert abs(res.iterations - res_f64.iterations) <= 2


def test_fused_pseudo_ladder_cluster_tail_regression():
    """Regression: cluster-aware degree factors must NOT inflate the nex
    tail's degrees (the host computes them over examined columns only).
    A 2.5× tail inflation tipped this exact problem from 4-iteration
    convergence into f32 overflow (gap modes outside the DoS `lower`
    overestimate amplified by the extra degree)."""
    N, nev, nex = 200, 16, 10
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=7)
    cfg = chase_tpu.ChaseConfig(mixed_precision=True)
    res = chase_tpu.eigsh_pseudo_fused(H, nev, nex, tol=1e-10, config=cfg)
    assert res.converged and res.iterations <= 8
    V = np.asarray(res.V)[:, :nev]
    R = H @ V - V * res.ritzv[None, :]
    assert np.linalg.norm(R, axis=0).max() < 5e-9


def test_fused_pseudo_bf16_rung():
    """Fused BSE f32 solve with the bf16 storage rung for the H² HEMMs."""
    N, nev, nex = 160, 10, 8
    H = random_pseudo_hermitian(N, dtype=np.float64, seed=31)
    Hf = H.astype(np.float32)
    cfg = chase_tpu.ChaseConfig(bf16_filter=True)
    res = chase_tpu.eigsh_pseudo_fused(Hf, nev, nex, tol=1e-4, config=cfg)
    assert res.converged
    np.testing.assert_allclose(res.ritzv, _pos(H, nev), atol=1e-2)
    V = np.asarray(res.V)[:, :nev]
    R = Hf @ V - V * res.ritzv[None, :].astype(V.dtype)
    assert np.linalg.norm(R, axis=0).max() < 1e-2
