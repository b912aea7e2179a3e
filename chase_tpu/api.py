"""User-facing API.

The idiomatic surface replacing the reference's C/Fortran singleton tables
(interface/chase_c_interface.h: {s,d,c,z}chase_init/.../_finalize_).  One
function, dtype-dispatched by the input array, grid-parallel when a Grid2D
is supplied:

    evals, evecs, info = chase_tpu.eigsh(H, nev=100, nex=40)

Sequences of correlated problems (the reference's mode='A' warm start):

    r1 = eigsh(H1, nev, nex, return_info=True)
    r2 = eigsh(H2, nev, nex, v0=r1.V, ritzv0=r1.ritzv_full, approx=True)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import ChaseConfig
from .parallel.mesh import Grid2D
from .parallel.operator import DenseOperator
from .perf import PerfData
from .solver import solve, SolveResult

__all__ = ["eigsh", "eigsh_fused", "eigsh_pseudo",
           "eigsh_pseudo_fused", "eigsh_sequence", "EigshResult",
           "estimate_spectral_bounds", "embed_complex_operator"]


def embed_complex_operator(H, *, grid=None,
                           pseudo: bool = False) -> DenseOperator:
    """Pre-embed a complex (pseudo-)Hermitian matrix for REPEATED
    real-pair solves against the same operator.

    ``eigsh``/``eigsh_pseudo`` called with a raw complex H embed and place
    the (2N, 2N) real matrix (a cache keeps the last two).  This helper
    builds the embedded real DenseOperator ONCE; passing it to
    eigsh/eigsh_fused (or
    eigsh_pseudo/eigsh_pseudo_fused with ``pseudo=True``) with the
    ordinary COMPLEX nev/nex reuses the device-resident J — the complex
    analogue of the real DenseOperator serving pattern, and the input
    ``chase_tpu.warmup`` expects for complex problems.
    """
    from .ops.realpair import embed_real, embed_real_pseudo
    H = np.asarray(H)
    if not np.issubdtype(H.dtype, np.complexfloating):
        raise ValueError(f"embed_complex_operator is for complex matrices, "
                         f"got {H.dtype} — pass real H to eigsh directly")
    if pseudo:
        Jp, P, d = embed_real_pseudo(H)
        op = DenseOperator(Jp, grid=grid, pseudo_hermitian=True)
        op.rp_perm, op.rp_d = P, d
    else:
        op = DenseOperator(embed_real(H), grid=grid)
        op.rp_perm = op.rp_d = None
    op.rp_n = H.shape[0]
    op.rp_dtype = H.dtype
    return op


# -- raw-complex-H embedding cache -------------------------------------------
# Passing a raw complex H to eigsh/eigsh_pseudo with
# complex_backend='real_pair' would otherwise re-embed (and re-place) the
# (2N, 2N) real operator on EVERY call.  This tiny LRU makes the second
# call with the SAME array object warm.  Keyed on id(H); a strided content probe
# guards against both id reuse and in-place mutation of H between calls.
# Bounded at 2 entries since each pins a (2N)² device buffer (use
# embed_complex_operator for explicit lifetime control).

from collections import OrderedDict as _OrderedDict

_EMBED_CACHE: "_OrderedDict[tuple, tuple]" = _OrderedDict()
_EMBED_CACHE_MAX = 2


def _embed_probe(H):
    s = max(1, H.shape[0] // 8)
    return (H.shape, np.dtype(H.dtype).str,
            np.asarray(H[::s, ::s]).tobytes())


def _cached_embed(H_obj, grid, pseudo: bool) -> DenseOperator:
    """Embedded DenseOperator for a raw complex H, cached across calls."""
    from .logger import get_logger
    key = (id(H_obj), bool(pseudo), id(grid))
    hit = _EMBED_CACHE.get(key)
    if hit is not None:
        held, probe, op = hit
        if held is H_obj and probe == _embed_probe(held):
            _EMBED_CACHE.move_to_end(key)
            get_logger().info(
                "reusing cached real-pair embedding for this H "
                "(pass an embed_complex_operator(...) operator for "
                "explicit control)", "interface")
            return op
        del _EMBED_CACHE[key]
    op = embed_complex_operator(np.asarray(H_obj), grid=grid, pseudo=pseudo)
    _EMBED_CACHE[key] = (H_obj, _embed_probe(H_obj), op)
    while len(_EMBED_CACHE) > _EMBED_CACHE_MAX:
        _EMBED_CACHE.popitem(last=False)
    return op


def _fused_small_dense(rcfg, grid: "Optional[Grid2D]" = None) -> str:
    """Resolve small_dense for the fused (in-graph) solvers: 'auto' is the
    device eigensolver; 'host' runs host LAPACK through a pure_callback.

    On a multi-device grid 'host' is additionally forced back to 'device':
    pure_callback under GSPMD partitioning executes per-device against
    device-local shards, which is unvalidated for the replicated k×k eigh —
    use the host driver (split-sync) for host-LAPACK on grids."""
    sd = rcfg.small_dense_backend
    if sd == "host" and grid is not None and grid.nprocs > 1:
        from .logger import get_logger
        get_logger().warn(
            "small_dense='host' inside the fused solver is unsupported on "
            "a multi-device grid (sharded pure_callback); forcing 'device'."
            "  Use eigsh (host driver) for the split-sync host path.")
        return "device"
    return "device" if sd == "auto" else sd


def _collect_fused_perf(out, iters: int, t_all: float,
                        matrix_type: int = 0) -> PerfData:
    """PerfData from the fused solvers' in-graph counters (single dispatch
    has no host-visible phase boundaries — only 'All' is wall-timed)."""
    perf = PerfData()
    perf.matrix_type = matrix_type
    perf.add_time("All", t_all)
    perf.filtered_vecs = int(out["filtered_vecs"])
    for b in np.asarray(out["block_history"])[:iters]:
        perf.add_iter_blocksize(int(b))
    return perf


def _write_resid_history(path: str, out, iters: int):
    """CHASE_SAVE_RESIDUALS CSV from the in-graph residual history."""
    hist = np.asarray(out["resid_history"])[:iters]
    with open(path, "w") as f:
        f.write("iteration,residual\n")
        for i, row in enumerate(hist):
            for r in row:
                f.write(f"{i},{r}\n")


def _unpad(res: SolveResult, op: DenseOperator) -> SolveResult:
    if op.N_orig != op.N:
        res.V = op.unpad_block(res.V)
    return res


def eigsh(H, nev: int, nex: Optional[int] = None, *,
          tol: Optional[float] = None,
          v0=None, ritzv0=None, approx: bool = False,
          largest: bool = False,
          config: Optional[ChaseConfig] = None,
          grid: Optional[Grid2D] = None,
          collect_perf: bool = False,
          key=None) -> SolveResult:
    """Compute the ``nev`` lowest eigenpairs of a (dense) Hermitian matrix.

    Args:
      H: (N, N) Hermitian array (numpy or jax), or a DenseOperator.
      nev: number of wanted eigenpairs.
      nex: extra search-space size (default: max(nev//4, 8), reference
           examples use ~0.2–0.6·nev).
      tol: residual tolerance (default per dtype: 1e-10 DP / 1e-5 SP).
      v0: optional (N, nev+nex) starting subspace.
      ritzv0: previous Ritz values (required with approx=True).
      approx: warm-start mode ('A' in the reference C interface).
      config: full ChaseConfig for everything else.
      grid: Grid2D to shard H/V over a device mesh.
      collect_perf: attach a PerfData with phase timings to the result.

    Returns:
      SolveResult with .ritzv (nev,), .V (N, nev+nex) device array whose
      first nev columns are the eigenvectors, .resid, .converged, ...
    """
    if nex is None:
        nex = max(nev // 4, 8)
    if approx and v0 is None:
        raise ValueError("approx=True (warm start) needs v0 (and ritzv0) "
                         "from a previous solve")
    cfg = config or ChaseConfig()
    if tol is not None or approx:
        import dataclasses
        updates = {}
        if tol is not None:
            updates["tol"] = tol
        if approx:
            updates["approx"] = True
        cfg = dataclasses.replace(cfg, **updates)

    if largest:
        # ChASE computes the lowest extremal part; the top end is the
        # lowest end of -H.
        if isinstance(H, DenseOperator):
            raise ValueError("largest=True needs a raw matrix, not an "
                             "operator — pass -H yourself instead")
        res = eigsh(-np.asarray(H), nev, nex, tol=tol, v0=v0,
                    ritzv0=None if ritzv0 is None else -np.asarray(ritzv0),
                    approx=approx, config=config, grid=grid,
                    collect_perf=collect_perf, key=key)
        # solve(-H) returns the lowest of -H ascending = the top of H
        # descending after negation; flip to ascending (scipy convention).
        order = np.arange(len(res.ritzv))[::-1].copy()
        res.ritzv = (-res.ritzv)[order]
        res.resid = res.resid[order]
        full = np.concatenate([order, np.arange(nev, res.V.shape[1])])
        if isinstance(res.V, np.ndarray):    # real-pair results stay on host
            res.V = np.take(res.V, full, axis=1)
        else:
            import jax.numpy as jnp
            res.V = jnp.take(res.V, jnp.asarray(full), axis=1)
        if res.ritzv_full is not None:
            # keep ritzv_full column-aligned with the reordered V
            res.ritzv_full = (-res.ritzv_full)[full[:len(res.ritzv_full)]]
        return res

    if getattr(H, "rp_n", None):     # pre-embedded complex operator
        return _eigsh_real_pair(None, nev, nex, cfg=cfg, v0=v0,
                                ritzv0=ritzv0, grid=grid,
                                collect_perf=collect_perf, key=key, op=H)
    if not isinstance(H, DenseOperator) and _use_real_pair(H, cfg):
        return _eigsh_real_pair(H, nev, nex, cfg=cfg, v0=v0, ritzv0=ritzv0,
                                grid=grid, collect_perf=collect_perf,
                                key=key)

    op = H if isinstance(H, DenseOperator) else DenseOperator(H, grid=grid)
    perf = PerfData() if collect_perf else None
    res = solve(op, nev, nex, config=cfg, V0=v0, ritzv0=ritzv0,
                perf=perf, key=key)
    return _unpad(res, op)


def _use_real_pair(H, cfg) -> bool:
    """Complex input with complex_backend='real_pair' (every supported
    platform runs complex natively, so 'auto' means native)."""
    dt = np.dtype(getattr(H, "dtype", None) or np.asarray(H).dtype)
    return (np.issubdtype(dt, np.complexfloating)
            and getattr(cfg, "complex_backend", "auto") == "real_pair")


def _eigsh_real_pair(H, nev, nex, *, cfg, v0=None, ritzv0=None, grid=None,
                     collect_perf=False, key=None,
                     fused: bool = False, op=None) -> SolveResult:
    """Complex Hermitian solve via the real symplectic embedding
    (ops/realpair.py): the doubled real problem runs the full real solver
    stack (host driver or the fused one-dispatch program); the pair
    structure collapses back to complex eigenpairs.  ``op``: a pre-built
    embedded operator from :func:`embed_complex_operator` (skips the
    per-call embedding + placement)."""
    from .ops.realpair import embed_block, extract_pairs
    from .logger import get_logger
    if op is None:
        N = np.asarray(H).shape[0]
        get_logger().info(
            f"complex problem → real-pair embedding (2N={2*N}); set "
            f"complex_backend='native' to force complex dtypes, or "
            f"pre-embed with embed_complex_operator for repeated solves",
            "interface")
        op = _cached_embed(H, grid, pseudo=False)
    else:
        if op.rp_perm is not None:
            raise ValueError("this operator was embedded with pseudo=True — "
                             "solve it with eigsh_pseudo/eigsh_pseudo_fused")
        N = op.rp_n
    v0r = None if v0 is None else embed_block(np.asarray(v0))
    if fused:
        # clear the embedding marker around the inner call: eigsh_fused
        # would otherwise re-dispatch here forever
        rp_n, op.rp_n = getattr(op, "rp_n", None), None
        try:
            res = eigsh_fused(op, 2 * nev, 2 * nex, config=cfg, v0=v0r,
                              collect_perf=collect_perf, key=key)
        finally:
            op.rp_n = rp_n
    else:
        r0 = None if ritzv0 is None else np.repeat(np.asarray(ritzv0), 2)
        perf = PerfData() if collect_perf else None
        res = solve(op, 2 * nev, 2 * nex, config=cfg, V0=v0r, ritzv0=r0,
                    perf=perf, key=key)
        res = _unpad(res, op)
    X2 = np.asarray(res.V)
    _, Vc, _ = extract_pairs(res.ritzv, X2[:, :2 * nev], res.resid, nev)
    vals, Vc, rres = _complex_rayleigh_ritz(op, Vc)
    # tail columns [nev, nev+nex): naive reconstruction of the real search
    # directions — valid warm-start material for sequence solves
    tail = (X2[:N, 2 * nev::2] + 1j * X2[N:, 2 * nev::2]).astype(Vc.dtype)
    nrm = np.linalg.norm(tail, axis=0)
    tail = tail / np.where(nrm > 0, nrm, 1.0)[None, :]
    res.ritzv = vals
    res.V = np.concatenate([Vc, tail], axis=1)   # (N, nev+nex) complex, host
    res.resid = rres
    if res.ritzv_full is not None:
        res.ritzv_full = res.ritzv_full[::2].copy()
    return res


def _complex_rayleigh_ritz(op, Vc):
    """Rayleigh–Ritz of the complex operator on the extracted eigenvectors.

    Each extracted complex vector comes from ONE real Ritz vector of the
    embedding J, so its complex orthogonality to the others is only as
    good as residual/gap (1e-11 at N=2048, tol=1e-10).  One Rayleigh–Ritz
    step in complex arithmetic on the device — Householder QR
    (ops/qr.householder_qr), the complex H·Q taken as J·[Re Q; Im Q], an
    nev×nev eigh, and the rotation and residuals of ops/rr._rr_finish —
    restores working-precision orthonormality and returns the Ritz values
    and true complex residual norms.  Its cost is one RR of width nev,
    against one RR of width 2(nev+nex) per solver iteration.  Returns
    (ritzv, V, resid) on the host."""
    import jax
    import jax.numpy as jnp
    from .ops.qr import householder_qr
    from .ops.rr import _rr_finish
    N = Vc.shape[0]
    Q = householder_qr(jnp.asarray(Vc))
    Z = op.place_block(jnp.concatenate([Q.real, Q.imag]))
    W = op.unpad_block(jnp.matmul(op.H, Z, precision="highest"))
    HQ = jax.lax.complex(W[:N], W[N:])
    A = jnp.matmul(Q.conj().T, HQ, precision="highest")
    w, Y = jnp.linalg.eigh((A + A.conj().T) / 2)
    V, w, resid = _rr_finish(Q, HQ, Q, w, Y, 0)
    return np.asarray(w), np.asarray(V), np.asarray(resid)


def _eigsh_pseudo_real_pair(H, nev, nex, *, cfg, v0=None, ritzv0=None,
                            grid=None, collect_perf=False, key=None,
                            fused: bool = False, op=None) -> SolveResult:
    """Complex pseudo-Hermitian (BSE) solve via the permuted symplectic
    embedding (ops/realpair.embed_real_pseudo): J' is a REAL BSE-form
    matrix of size 2N with every eigenvalue of H doubled, so the whole
    real pseudo stack (H² filter, S-metric Lanczos, pencil RR,
    K-conjugation, ring schedules) runs unchanged on real arithmetic
    — an alternative to the reference's {c,z} solve_pseudo
    (interface/chase_c_interface.h:159-175)."""
    from .ops.realpair import embed_block_pseudo, extract_pairs
    from .solver_pseudo import solve_pseudo
    from .logger import get_logger
    if op is None:
        N = np.asarray(H).shape[0]
        get_logger().info(
            f"complex BSE problem → real-pair embedding (2N={2*N}); set "
            f"complex_backend='native' to force complex dtypes, or "
            f"pre-embed with embed_complex_operator(pseudo=True) for "
            f"repeated solves", "interface")
        op = _cached_embed(H, grid, pseudo=True)
        P, d = op.rp_perm, op.rp_d
    else:
        if op.rp_perm is None:
            raise ValueError("this operator was embedded without "
                             "pseudo=True — solve it with eigsh/eigsh_fused")
        N = op.rp_n
        P, d = op.rp_perm, op.rp_d
    invP = np.argsort(P)
    v0r = None
    if v0 is not None:
        v0 = np.asarray(v0)
        k_half, k_full = nev + nex, 2 * (nev + nex)
        # embed_block_pseudo doubles the columns; the embedded subspace
        # needs 2·(2nev+2nex) of them
        if v0.shape[1] == k_full:
            # native/C-ABI convention: a full 2(nev+nex)-column S-basis
            # (previous native solve's V, or init-time V buffers) embeds
            # straight to the full embedded width
            v0r = embed_block_pseudo(v0, P, d)       # (2N, 2·k_full)
        elif v0.shape[1] == k_half:
            # a previous real-pair result's V (positive pairs + tail):
            # fill the negative mirrors by K-conjugation (the plain
            # half-swap IS the complex K in these coordinates —
            # embed_real_pseudo's D similarity)
            v0r = embed_block_pseudo(v0, P, d)       # (2N, 2·k_half)
            v0r = np.concatenate(
                [v0r, np.concatenate([v0r[N:], v0r[:N]], axis=0)], axis=1)
        else:
            raise ValueError(
                f"pseudo-Hermitian v0 must have nev+nex={k_half} or "
                f"2(nev+nex)={k_full} columns, got {v0.shape[1]}")
    if fused:
        # clear the embedding marker around the inner call (see
        # _eigsh_real_pair's fused branch)
        rp_n, op.rp_n = getattr(op, "rp_n", None), None
        try:
            res = eigsh_pseudo_fused(op, 2 * nev, 2 * nex, config=cfg,
                                     v0=v0r, collect_perf=collect_perf,
                                     key=key)
        finally:
            op.rp_n = rp_n
    else:
        r0 = None if ritzv0 is None else np.repeat(np.asarray(ritzv0), 2)
        perf = PerfData() if collect_perf else None
        if perf is not None:
            perf.matrix_type = 1
        res = solve_pseudo(op, 2 * nev, 2 * nex, config=cfg, V0=v0r,
                           ritzv0=r0, perf=perf, key=key)
        res = _unpad(res, op)
    # undo the sign similarity + signature permutation, then collapse
    # the doubled pairs
    X2 = (d[:, None] * np.asarray(res.V))[invP]
    vals, Vc, rres = extract_pairs(res.ritzv, X2[:, :2 * nev], res.resid,
                                   nev)
    # tail columns: positive search directions as complex warm-start seeds
    tail = (X2[:N, 2 * nev:2 * (nev + nex):2]
            + 1j * X2[N:, 2 * nev:2 * (nev + nex):2]).astype(Vc.dtype)
    nrm = np.linalg.norm(tail, axis=0)
    tail = tail / np.where(nrm > 0, nrm, 1.0)[None, :]
    res.ritzv = vals
    res.V = np.concatenate([Vc, tail], axis=1)   # (N, nev+nex) complex
    res.resid = rres
    if res.ritzv_full is not None:
        res.ritzv_full = res.ritzv_full[::2].copy()
    return res


def eigsh_fused(H, nev: int, nex: Optional[int] = None, *,
                tol: Optional[float] = None, v0=None,
                largest: bool = False,
                config: Optional[ChaseConfig] = None,
                grid: Optional[Grid2D] = None,
                collect_perf: bool = False,
                key=None) -> SolveResult:
    """Device-resident Hermitian solve: the whole iteration runs as ONE
    XLA program (`chase_tpu.fused.solve_fused`) — minimal host↔device
    traffic, ideal for production serving and benchmarking.  Functionally
    equivalent to :func:`eigsh` up to documented tie-order deltas.

    With ``collect_perf=True`` the result carries a PerfData whose FLOP
    counters come from in-graph accumulators (filtered vectors, per-
    iteration block sizes); only the 'All' phase is wall-timed — a single
    dispatch has no host-visible phase boundaries (use
    ``perf.profiler_trace`` for an xprof breakdown).  ``save_residuals``
    (config / CHASE_SAVE_RESIDUALS) writes the per-iteration residual
    history CSV from the in-graph history buffer.
    """
    import time as _time

    import jax
    import jax.numpy as jnp
    from .fused import solve_fused

    if nex is None:
        nex = max(nev // 4, 8)
    if largest:
        if isinstance(H, DenseOperator):
            raise ValueError("largest=True needs a raw matrix, not an "
                             "operator — pass -H yourself instead")
        res = eigsh_fused(-np.asarray(H), nev, nex, tol=tol, v0=v0,
                          config=config, grid=grid,
                          collect_perf=collect_perf, key=key)
        order = np.arange(len(res.ritzv))[::-1].copy()
        res.ritzv = (-res.ritzv)[order]
        res.resid = res.resid[order]
        full = np.concatenate([order, np.arange(nev, res.V.shape[1])])
        if isinstance(res.V, np.ndarray):    # real-pair results stay on host
            res.V = np.take(res.V, full, axis=1)
        else:
            res.V = jnp.take(res.V, jnp.asarray(full), axis=1)
        if res.ritzv_full is not None:
            # keep ritzv_full column-aligned with the reordered V
            res.ritzv_full = (-res.ritzv_full)[full[:len(res.ritzv_full)]]
        return res
    cfg = config or ChaseConfig()
    if tol is not None:
        import dataclasses as _dc
        cfg = _dc.replace(cfg, tol=tol)
    if getattr(H, "rp_n", None):     # pre-embedded complex operator
        return _eigsh_real_pair(None, nev, nex, cfg=cfg, v0=v0, grid=grid,
                                collect_perf=collect_perf, key=key,
                                fused=True, op=H)
    if not isinstance(H, DenseOperator) and _use_real_pair(H, cfg):
        return _eigsh_real_pair(H, nev, nex, cfg=cfg, v0=v0, grid=grid,
                                collect_perf=collect_perf, key=key,
                                fused=True)
    op = H if isinstance(H, DenseOperator) else DenseOperator(H, grid=grid)
    rcfg = cfg.resolve(op.dtype)
    tol = rcfg.tol
    if key is None:
        key = jax.random.key(rcfg.seed)
    warm = v0 is not None
    probes = None
    if v0 is None:
        v0 = jax.random.normal(key, (op.N, nev + nex), dtype=op.dtype)
    else:
        v0 = op.place_block(jnp.asarray(v0, op.dtype))
        probes = op.place_block(jax.random.normal(
            jax.random.fold_in(key, 1),
            (op.N, min(rcfg.num_lanczos, nev + nex)), dtype=op.dtype))
    # wide-fused DP (wide_f64='on'): route every full-precision
    # contraction through the int8-slice GEMM so the one-dispatch program
    # carries no f64 dots, factorizations or eigensolves
    from .solver import resolve_wide
    use_wide, _, _ = resolve_wide(rcfg, op, not rcfg.is_double,
                                  "device", "device")
    wide_kwargs = {}
    H_arg = op.H
    if use_wide:
        slices, sa, ws, wL = op.H_wide      # engages + drops the f64 buffer
        H_arg = op.H_low
        wide_kwargs = dict(H_wide=(slices, sa), wide_rr=True,
                           wide_s=ws, wide_L=wL)
    t0 = _time.perf_counter()
    out = solve_fused(
        H_arg, v0, nev=nev, nex=nex, tol=tol, deg0=rcfg.deg,
        max_deg=rcfg.max_deg, deg_extra=rcfg.deg_extra,
        max_iter=rcfg.max_iter, lanczos_iter=rcfg.lanczos_iter,
        num_lanczos=rcfg.num_lanczos, optimization=rcfg.optimization,
        precision=rcfg.matmul_precision, inject_dos=not warm,
        bf16_filter=rcfg.bf16_filter,
        bf16_threshold=rcfg.bf16_filter_threshold,
        small_dense=_fused_small_dense(rcfg, op.grid),
        probes=probes, eigh_polish=rcfg.polish_passes(),
        refine_filter=(rcfg.refine_filter and rcfg.mixed_precision
                       and rcfg.is_double),
        phase_tiers=rcfg.fused_tiers, **wide_kwargs)
    ritzv = np.asarray(out["ritzv"], np.float64)
    resid = np.asarray(out["resid"], np.float64)
    locked = int(out["locked"])
    iters = int(out["iterations"])
    t_all = _time.perf_counter() - t0

    perf = _collect_fused_perf(out, iters, t_all) if collect_perf else None
    if rcfg.save_residuals:
        _write_resid_history(rcfg.save_residuals, out, iters)
    eh = np.asarray(out["early_history"])[:iters]
    early = [float(x) for x in eh[eh >= 0]]

    res = SolveResult(
        ritzv=ritzv[:nev], V=out["V"], resid=resid[:nev],
        iterations=iters, locked=locked,
        converged=bool(locked >= nev),
        upperb=float(out["upperb"]), lowerb=float(out["lowerb"]),
        perf=perf, ritzv_full=ritzv, early_locked=early)
    return _unpad(res, op)


def eigsh_pseudo_fused(H, nev: int, nex: Optional[int] = None, *,
                       tol: Optional[float] = None, v0=None,
                       config: Optional[ChaseConfig] = None,
                       grid: Optional[Grid2D] = None,
                       collect_perf: bool = False,
                       key=None) -> SolveResult:
    """Device-resident BSE solve — one XLA program
    (`chase_tpu.fused_pseudo.solve_pseudo_fused`).  ``collect_perf`` and
    ``save_residuals`` work like in :func:`eigsh_fused` (in-graph
    counters/history)."""
    import time as _time

    import jax
    import jax.numpy as jnp
    from .fused_pseudo import solve_pseudo_fused
    from .ops.blocks import scale_lower_rows

    if nex is None:
        nex = max(nev // 4, 8)
    cfg = config or ChaseConfig()
    if tol is not None:
        import dataclasses as _dc
        cfg = _dc.replace(cfg, tol=tol)
    if getattr(H, "rp_n", None):     # pre-embedded complex BSE operator
        return _eigsh_pseudo_real_pair(None, nev, nex, cfg=cfg, v0=v0,
                                       grid=grid, collect_perf=collect_perf,
                                       key=key, fused=True, op=H)
    if not isinstance(H, DenseOperator) and _use_real_pair(H, cfg):
        return _eigsh_pseudo_real_pair(H, nev, nex, cfg=cfg, v0=v0,
                                       grid=grid, collect_perf=collect_perf,
                                       key=key, fused=True)
    op = H if isinstance(H, DenseOperator) else DenseOperator(
        H, grid=grid, pseudo_hermitian=True)
    rcfg = cfg.resolve(op.dtype)
    tol = rcfg.tol
    if key is None:
        key = jax.random.key(rcfg.seed)
    K2 = 2 * (nev + nex)
    warm = v0 is not None
    probes = None
    if v0 is None:
        v0 = jax.random.normal(key, (op.N, K2), dtype=op.dtype)
        v0 = scale_lower_rows(v0, 0.001)
    else:
        v0 = op.place_block(jnp.asarray(v0, op.dtype))
        probes = op.place_block(scale_lower_rows(jax.random.normal(
            jax.random.fold_in(key, 1),
            (op.N, min(rcfg.num_lanczos, nev + nex)),
            dtype=op.dtype), 0.001))
    t0 = _time.perf_counter()
    out = solve_pseudo_fused(
        op.H, v0, nev=nev, nex=nex, tol=tol, deg0=rcfg.deg,
        max_deg=rcfg.max_deg, deg_extra=rcfg.deg_extra,
        max_iter=rcfg.max_iter, lanczos_iter=rcfg.lanczos_iter,
        num_lanczos=rcfg.num_lanczos, optimization=rcfg.optimization,
        cluster_aware=rcfg.cluster_aware_degrees,
        precision=rcfg.matmul_precision,
        small_dense=_fused_small_dense(rcfg, op.grid),
        inject_dos=not warm, probes=probes,
        eigh_polish=rcfg.polish_passes(),
        bf16_filter=rcfg.bf16_filter,
        bf16_threshold=rcfg.bf16_filter_threshold,
        refine_filter=(rcfg.refine_filter and rcfg.mixed_precision
                       and rcfg.is_double))
    ritzv = np.asarray(out["ritzv"], np.float64)
    resid = np.asarray(out["resid"], np.float64)
    locked = int(out["locked"])
    iters = int(out["iterations"])
    t_all = _time.perf_counter() - t0

    perf = _collect_fused_perf(out, iters, t_all, matrix_type=1) \
        if collect_perf else None
    if rcfg.save_residuals:
        _write_resid_history(rcfg.save_residuals, out, iters)
    eh = np.asarray(out["early_history"])[:iters]
    early = [float(x) for x in eh[eh >= 0]]

    res = SolveResult(
        ritzv=ritzv[:nev], V=out["V"], resid=resid[:nev],
        iterations=iters, locked=locked,
        converged=bool(locked >= nev),
        upperb=float(out["upperb"]), lowerb=float(out["lowerb"]),
        perf=perf, ritzv_full=ritzv, early_locked=early)
    return _unpad(res, op)


def eigsh_pseudo(H, nev: int, nex: Optional[int] = None, *,
                 tol: Optional[float] = None,
                 v0=None, ritzv0=None, approx: bool = False,
                 config: Optional[ChaseConfig] = None,
                 grid: Optional[Grid2D] = None,
                 collect_perf: bool = False,
                 key=None) -> SolveResult:
    """Compute the ``nev`` smallest-*positive* eigenpairs of a
    pseudo-Hermitian (BSE) matrix H = S·M (spectrum real, symmetric about 0).

    The reference's Solve_pseudo / *chase_pseudo_* C entry points
    (interface/chase_c_interface.h:163-175).  The search subspace holds
    2·(nev+nex) vectors (the negative mirrors ride along via
    K-conjugation).
    """
    from .solver_pseudo import solve_pseudo
    if nex is None:
        nex = max(nev // 4, 8)
    if approx and v0 is None:
        raise ValueError("approx=True (warm start) needs v0 (and ritzv0) "
                         "from a previous solve")
    cfg = config or ChaseConfig()
    if tol is not None or approx:
        import dataclasses
        updates = {}
        if tol is not None:
            updates["tol"] = tol
        if approx:
            updates["approx"] = True
        cfg = dataclasses.replace(cfg, **updates)
    if getattr(H, "rp_n", None):     # pre-embedded complex BSE operator
        return _eigsh_pseudo_real_pair(None, nev, nex, cfg=cfg, v0=v0,
                                       ritzv0=ritzv0, grid=grid,
                                       collect_perf=collect_perf, key=key,
                                       op=H)
    if not isinstance(H, DenseOperator) and _use_real_pair(H, cfg):
        return _eigsh_pseudo_real_pair(H, nev, nex, cfg=cfg, v0=v0,
                                       ritzv0=ritzv0, grid=grid,
                                       collect_perf=collect_perf, key=key)
    op = H if isinstance(H, DenseOperator) else DenseOperator(
        H, grid=grid, pseudo_hermitian=True)
    perf = PerfData() if collect_perf else None
    if perf is not None:
        perf.matrix_type = 1
    res = solve_pseudo(op, nev, nex, config=cfg, V0=v0, ritzv0=ritzv0,
                       perf=perf, key=key)
    return _unpad(res, op)


def eigsh_sequence(matrices, nev: int, nex: Optional[int] = None, *,
                   tol: Optional[float] = None,
                   config: Optional[ChaseConfig] = None,
                   grid: Optional[Grid2D] = None,
                   collect_perf: bool = False,
                   warmup: bool = True):
    """Solve a sequence of correlated Hermitian problems with automatic
    warm-starting — the reference's flagship use case (sequences of
    correlated eigenproblems from SCF iterations, README.md:13-16;
    examples/2_input_output --sequence).

    ``matrices`` is an iterable of (N, N) arrays (or a generator, so the
    whole sequence never needs to be in memory).  Yields SolveResults.

    ``warmup=True`` (default) precompiles every phase program the sequence
    can visit from a thread pool before the first member (chase_tpu.warmup;
    compilations overlap, so members never stall on sequential lazy
    compiles).  No-op cost on runtimes with a hot compilation cache.
    """
    v0 = ritzv0 = None
    first = True
    for H in matrices:
        if first:
            first = False
            if warmup and not isinstance(H, DenseOperator) \
                    and not _use_real_pair(H, config or ChaseConfig()):
                from .warmup import warmup as _warmup
                nx = nex if nex is not None else max(nev // 4, 8)
                op0 = DenseOperator(np.asarray(H), grid=grid)
                _warmup(op0, nev, nx, config=config)
                H = op0
        res = eigsh(H, nev, nex, tol=tol, config=config, grid=grid,
                    collect_perf=collect_perf,
                    v0=v0, ritzv0=ritzv0, approx=v0 is not None)
        v0, ritzv0 = np.asarray(res.V), res.ritzv_full
        yield res


# Back-compat style alias matching scipy naming
EigshResult = SolveResult


def estimate_spectral_bounds(H, *, num_lanczos: int = 4,
                             lanczos_iter: int = 25, nev: int = 0,
                             grid: Optional[Grid2D] = None,
                             config: Optional[ChaseConfig] = None,
                             key=None) -> dict:
    """Standalone stochastic Lanczos + DoS spectral estimator.

    Exposes the bounds machinery the solvers use internally
    (algorithm.inc:1067-1214): a spectral upper bound, the smallest-Ritz
    estimate, and — when ``nev > 0`` — the DoS quantile locating the
    damping interval's lower edge for a nev-sized subspace.

    Returns {"upperb", "lambda_min", "lowerb"} (lowerb = lambda_min when
    nev == 0).
    """
    import jax
    import jax.numpy as jnp
    from .ops import lanczos as lz

    op = H if isinstance(H, DenseOperator) else DenseOperator(H, grid=grid)
    rcfg = (config or ChaseConfig()).resolve(op.dtype)
    N = op.N
    if key is None:
        key = jax.random.key(rcfg.seed)
    # mirror the solvers' internal estimator: even step count + configured
    # matmul precision
    m = min(N // 2, lanczos_iter)
    m -= m % 2
    m = max(m, 2)
    probes = op.place_block(jax.random.normal(key, (N, num_lanczos),
                                              dtype=op.dtype))
    alphas, betas, _ = lz.lanczos_scan(op.H, probes, m=m,
                                       want_basis=False,
                                       precision=rcfg.matmul_precision)
    a_np = np.asarray(alphas, np.float64)
    b_np = np.asarray(betas, np.float64)
    theta, tau, _ = lz.lanczos_tridiag_host(a_np, b_np)
    upperb = lz.upper_bound(theta, b_np[-1])
    lam_min = float(theta.min())
    lowerb = lam_min
    if nev > 0:
        _, lowerb = lz.dos_lower_bound(theta, tau, nev, N)
    return {"upperb": float(upperb), "lambda_min": lam_min,
            "lowerb": float(lowerb)}
