"""Orthonormalization: CholQR1/2, shifted CholQR2, Householder fallback.

JAX redesign of the reference's QR stack
(linalg/internal/cpu/cholqr1.hpp:41-215 and the condition-number-driven
selection in Impl/chase_cpu/chase_cpu.hpp:590-776):

* Gram matrix ``G = VᴴV`` is a single sharded matmul (GSPMD inserts the
  column-communicator allreduce of mpi/cholqr.hpp:197 automatically when V
  is row-sharded).
* Cholesky of the small k×k Gram is replicated (reference: redundant potrf
  on every rank).
* ``potrf`` failure (reference: LAPACK info != 0) is detected through NaNs
  in the Cholesky factor; the solver falls back to Householder QR
  (jnp.linalg.qr) exactly like chase_cpu.hpp:725-751.
* Locked columns: the reference runs CholQR over the *full* block and then
  restores the locked columns from backup (chase_cpu.hpp:601-607, 754-775);
  we do the same with a functional column mask.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..logger import get_logger
from ..types import real_dtype, is_double_base

__all__ = ["cholqr", "householder_qr", "tsqr", "restore_locked",
           "orthonormalize", "orthonormalize_pseudo",
           "orthonormalize_window"]


def _gram(V, precision):
    return jnp.matmul(V.conj().T, V, precision=precision)


def _trsm_right(L, V):
    """V @ L^{-H} for lower-triangular L (BLAS trsm 'R','U','N' analogue)."""
    return jax.lax.linalg.triangular_solve(
        L, V, left_side=False, lower=True, transpose_a=True, conjugate_a=True)


def _chol_usable(L) -> bool:
    """Guard for the host-factorized CholQR chains: a shift-regularized
    MARGINALLY-PD Gram (cond ≳ 1e14) factors without LAPACK error, but
    applying its explicit triangular inverse explodes the basis silently
    — measured on the BSE ladder's iteration-1 block (f32-filtered columns
    numerically dependent, Gram eig_min ~1e-19·‖G‖): col norms reached
    1e18 within two iterations and the solve quietly degraded to 4.5e-8
    at tol 1e-10.  The device path NaN-signals this case; here the diag
    ratio of L (a cond(G) lower bound) triggers the same TSQR fallback."""
    import numpy as _np
    dL = _np.abs(_np.diagonal(L))
    if not _np.isfinite(L).all() or dL.min() <= 0:
        return False
    return (dL.max() / dL.min()) ** 2 < 1e14


@partial(jax.jit, static_argnames=("passes", "shifted", "precision", "upcast"))
def cholqr(V, *, passes=2, shifted=False, precision="highest", upcast=None):
    """``passes`` rounds of Cholesky QR; optional diagonal shift on round 0.

    Returns (V_orthonormal, ok) where ``ok`` is False if any Cholesky failed
    (non-PD Gram → NaNs).  Mirrors cholQR1/cholQR2/shiftedcholQR2
    (cpu/cholqr1.hpp:41-189).
    """
    in_dtype = V.dtype
    if upcast is not None:
        V = V.astype(upcast)
    m = V.shape[0]
    rt = real_dtype(V.dtype)
    ok = jnp.bool_(True)
    for p in range(passes):
        G = _gram(V, precision)
        # Column equilibration (Jacobi scaling): factor D⁻¹GD⁻¹ with
        # D = √diag(G) and fold D⁻¹ into the trsm.  Mathematically the
        # same Q; numerically it removes the column-NORM spread from the
        # Gram's condition number (van der Sluis: within k of optimal) —
        # the refine ladder's output has near-orthogonal columns whose
        # norms p(λ_j) span many decades, which used to fail this chain
        # into the TSQR rescue every iteration.
        d = jnp.sqrt(jnp.abs(jnp.diagonal(G).real)).astype(rt)
        d = jnp.where(d > 0, d, jnp.ones_like(d))
        G = G / (d[:, None] * d[None, :]).astype(G.dtype)
        if p == 0 and shifted:
            # shift = sqrt(m)·Σ|diag(G)|·eps (DP) / 10·Σ|diag(G)|·eps (SP)
            nrmf = jnp.sum(jnp.abs(jnp.diagonal(G).real))
            epsv = jnp.asarray(np.finfo(rt).eps, rt)
            coef = np.sqrt(m) if is_double_base(V.dtype) else 10.0
            shift = (coef * epsv) * nrmf
            G = G + shift * jnp.eye(G.shape[0], dtype=G.dtype)
        L = jnp.linalg.cholesky(G)
        pass_ok = jnp.isfinite(L.real).all()
        ok = ok & pass_ok
        # Replace NaN factor by identity so the trsm stays finite; the caller
        # discards the result when ok is False.
        L = jnp.where(pass_ok, L, jnp.eye(G.shape[0], dtype=G.dtype))
        V = _trsm_right(L, V / d[None, :].astype(V.dtype))
    return V.astype(in_dtype), ok


@partial(jax.jit, static_argnames=("precision",))
def _gram_jit(V, *, precision="highest"):
    return _gram(V, precision)


@partial(jax.jit, static_argnames=("precision",))
def _apply_right_jit(V, M, *, precision="highest"):
    return jnp.matmul(V, M, precision=precision)


def cholqr_hostchol(V, *, passes=2, shifted=False, precision="highest",
                    upcast=None):
    """CholQR with the k×k factorization on host, in f64.

    Split-sync variant of :func:`cholqr` (opt-in, small_dense='host'):
    the Gram matrix is a sharded matmul, the k×k Cholesky AND triangular
    inverse happen on host LAPACK in f64 (doubling as the
    QR_DOUBLE_PRECISION analogue), and the application ``V ← V·L⁻ᴴ`` is a
    plain device matmul —
    no device triangular solve at all.  Well-conditioned by construction
    on rounds > 0 (CholQR squares toward orthonormality), and the shifted
    round-0 Gram is regularized exactly like the device path.
    """
    import scipy.linalg as sla

    in_dtype = V.dtype
    if shifted:
        # The explicit triangular INVERSE applied as a matmul loses more
        # accuracy than a solve would on the badly conditioned shifted
        # round-0 Gram; one extra unshifted cleanup pass squares that
        # error away (CholQR's quadratic orthogonality improvement).
        passes = max(passes, 3)
    if upcast is not None:
        # QR_DOUBLE_PRECISION upcast of the GRAM ACCUMULATION too — an f32
        # Gram of an ill-conditioned block can go numerically non-PD even
        # though the f64 host factorization would succeed
        V = V.astype(upcast)
    m = V.shape[0]
    in_rt = real_dtype(V.dtype)
    ok = True
    for p in range(passes):
        G = np.asarray(_gram_jit(V, precision=precision))
        wide = np.complex128 if np.iscomplexobj(G) else np.float64
        Gw = G.astype(wide)
        # column equilibration (see cholqr): unit-diagonal Gram, the
        # scaling folded into the applied inverse
        d = np.sqrt(np.abs(np.diagonal(Gw).real))
        d = np.where(d > 0, d, 1.0)
        Gw = Gw / (d[:, None] * d[None, :])
        if p == 0 and shifted:
            coef = np.sqrt(m) if is_double_base(V.dtype) else 10.0
            shift = coef * np.finfo(np.dtype(in_rt)).eps \
                * np.sum(np.abs(np.diagonal(Gw).real))
            Gw = Gw + shift * np.eye(Gw.shape[0], dtype=wide)
        try:
            L = np.linalg.cholesky(Gw)
        except np.linalg.LinAlgError:
            return V.astype(in_dtype), False
        if not _chol_usable(L):
            return V.astype(in_dtype), False
        Linv = sla.solve_triangular(L, np.eye(L.shape[0], dtype=wide),
                                    lower=True)
        M = Linv.conj().T / d[:, None]
        V = _apply_right_jit(V, jnp.asarray(M.astype(G.dtype)),
                             precision=precision)
    return V.astype(in_dtype), ok


def cholqr_wide(V, *, passes=2, shifted=False, precision="highest",
                upcast=None):
    """CholQR with the N-contraction Gram on the exact-bf16 slice path and
    the k×k factorization on host f64 (ops/wide + cholqr_hostchol's
    split-sync pattern).

    The wide_f64='on' QR path: the Gram is ~1e-14-accurate slice GEMM
    work, the Cholesky + triangular
    inverse run on host LAPACK, and the application returns as a plain
    (N,k)@(k,k) matmul.
    """
    import scipy.linalg as sla
    from .wide import wide_matmul, wide_gram

    in_dtype = V.dtype
    if shifted:
        passes = max(passes, 3)      # cleanup pass after the shifted round
    if upcast is not None:
        V = V.astype(upcast)
    m = V.shape[0]
    in_rt = real_dtype(V.dtype)
    ok = True
    for p in range(passes):
        G = np.asarray(wide_gram(V))
        # column equilibration (see cholqr): unit-diagonal Gram, the
        # scaling folded into the applied inverse
        d = np.sqrt(np.abs(np.diagonal(G)))
        d = np.where(d > 0, d, 1.0)
        G = G / (d[:, None] * d[None, :])
        if p == 0 and shifted:
            coef = np.sqrt(m) if is_double_base(V.dtype) else 10.0
            shift = coef * np.finfo(np.dtype(in_rt)).eps \
                * np.sum(np.abs(np.diagonal(G)))
            G = G + shift * np.eye(G.shape[0])
        try:
            L = np.linalg.cholesky(G)
        except np.linalg.LinAlgError:
            return V.astype(in_dtype), False
        if not _chol_usable(L):
            return V.astype(in_dtype), False
        Linv = sla.solve_triangular(L, np.eye(L.shape[0]), lower=True)
        V = wide_matmul(V, jnp.asarray((Linv.T / d[:, None]).copy()))
    return V.astype(in_dtype), ok


@partial(jax.jit, static_argnames=("n_panels", "precision", "upcast"))
def mgs_cholqr(V, *, n_panels=6, precision="highest", upcast=None):
    """Panelized block-Gram-Schmidt CholQR (BCGS2 shape).

    JAX analogue of the reference's ``modifiedGramSchmidtCholQR``
    (nccl/cholqr.hpp:1025-1190; auto-invoked at N ≥ 1e5,
    Impl/config/config.hpp:9): panel 0 gets CholQR2; every later panel is
    projected against the previous panel, CholQR1'd, re-projected against
    ALL previous columns, and CholQR1'd again.  Bounds the Gram
    accumulation error that plain CholQR suffers on very tall blocks.
    All panel boundaries are static; projections are plain matmuls and the
    k_p×k_p Cholesky factors replicate (the P6/P8 pattern).
    Returns (Q, ok).
    """
    in_dtype = V.dtype
    if upcast is not None:
        V = V.astype(upcast)
    k = V.shape[1]
    ps = -(-k // n_panels)
    bounds = [(i * ps, min((i + 1) * ps, k))
              for i in range(n_panels) if i * ps < k]

    Q0, ok = cholqr(V[:, :bounds[0][1]], passes=2, precision=precision)
    cols = [Q0]
    for (a, b) in bounds[1:]:
        Pnl = V[:, a:b]
        prev = cols[-1]
        Pnl = Pnl - jnp.matmul(
            prev, jnp.matmul(prev.conj().T, Pnl, precision=precision),
            precision=precision)
        Pnl, ok1 = cholqr(Pnl, passes=1, precision=precision)
        Qall = jnp.concatenate(cols, axis=1)
        Pnl = Pnl - jnp.matmul(
            Qall, jnp.matmul(Qall.conj().T, Pnl, precision=precision),
            precision=precision)
        Pnl, ok2 = cholqr(Pnl, passes=1, precision=precision)
        ok = ok & ok1 & ok2
        cols.append(Pnl)
    return jnp.concatenate(cols, axis=1).astype(in_dtype), ok


@partial(jax.jit, static_argnames=("upcast",))
def householder_qr(V, *, upcast=None):
    """Dense Householder QR (reference houseHoulderQR: geqrf + gqr)."""
    in_dtype = V.dtype
    if upcast is not None:
        V = V.astype(upcast)
    Q, _ = jnp.linalg.qr(V, mode="reduced")
    return Q.astype(in_dtype)


@partial(jax.jit, static_argnames=("grid", "axis", "upcast"))
def tsqr(V, *, grid=None, axis: str = "r", upcast=None):
    """Distributed tall-skinny Householder QR (TSQR).

    JAX replacement for the reference's distributed Householder QR
    (linalg/internal/mpi/householder_qr.hpp and
    nccl/householder_qr.hpp — custom panel factorization + compact-WY
    formQ, ~7k LoC across backends).  Instead of panel-by-panel pivot
    broadcasts, TSQR does:

      1. local Householder QR of each (N/p, k) row shard,
      2. one ``all_gather`` of the p small k×k R factors over the mesh
         axis (the only communication),
      3. a replicated recombination QR of the stacked (p·k, k) R matrix
         (reference analogue: redundant root factorization on every rank),
      4. a local (N/p, k)×(k, k) back-multiply.

    Backward stable like Householder regardless of cond(V) — this is the
    rescue path when the CholQR chain breaks down on a singular Gram.
    With ``grid=None`` (or a 1-sized axis / shards shorter than k) it
    degenerates to dense ``jnp.linalg.qr``.
    """
    in_dtype = V.dtype
    if upcast is not None:
        V = V.astype(upcast)
    N, k = V.shape
    p = 1 if grid is None else grid.mesh.shape[axis]
    if p == 1 or N % p != 0 or N // p < k:
        Q, _ = jnp.linalg.qr(V, mode="reduced")
        return Q.astype(in_dtype)

    def local(v):
        q1, r1 = jnp.linalg.qr(v, mode="reduced")
        rs = jax.lax.all_gather(r1, axis)            # (p, k, k), replicated
        q2, _ = jnp.linalg.qr(rs.reshape(p * k, k), mode="reduced")
        me = jax.lax.axis_index(axis)
        q2_me = jax.lax.dynamic_slice(q2, (me * k, jnp.int32(0)), (k, k))
        return jnp.matmul(q1, q2_me, precision="highest")

    fn = shard_map(local, mesh=grid.mesh,
                   in_specs=P(axis, None), out_specs=P(axis, None))
    return fn(V).astype(in_dtype)


# An f32-Householder + wide-CholQR2 rescue in place of the f64 TSQR
# fallback looks like a cheap
# Householder substitute for wide mode, but breakdowns also occur NEAR
# CONVERGENCE (not only at the ladder's structural first iteration) and
# the f32 cast then floors near-converged columns at eps_f32 — they
# early-lock at ~1000·tol and the solve stalls at 5e-7 (N=1024 BSE wide
# A/B).  The f64 TSQR stays the rescue; it runs a handful of times per
# solve.


@jax.jit
def restore_locked(V_new, V_old, locked):
    """Keep columns [0, locked) from V_old (reference lacpy restore)."""
    cols = jnp.arange(V_new.shape[1])
    return jnp.where(cols[None, :] < locked, V_old, V_new)


def orthonormalize_pseudo(V, locked, cond, rcfg, grid=None,
                          small_dense="device"):
    """S-aware QR for the pseudo-Hermitian path.

    Mirrors the pseudo branch of Impl/chase_cpu/chase_cpu.hpp:597-626 and
    754-775: rearrange the block [L | active | R] → [L | R | active], flip
    the lower-half sign of the 2·locked locked columns (so CholQR
    S-orthogonalizes the active block against them), orthonormalize, restore
    the unflipped locked columns, and undo the rearrangement.  All layout
    moves are gathers with host-built (traced) index arrays.
    """
    from .blocks import permute_cols
    from .pseudo import flip_locked_cols

    if locked == 0:
        return orthonormalize(V, 0, cond, rcfg, grid,
                              small_dense=small_dense)
    K2 = V.shape[1]
    perm_to = np.concatenate([
        np.arange(locked), np.arange(K2 - locked, K2),
        np.arange(locked, K2 - locked)])
    inv = np.argsort(perm_to)
    Vp = permute_cols(V, jnp.asarray(perm_to))
    Vf = flip_locked_cols(Vp, jnp.int32(2 * locked))
    Q = orthonormalize(Vf, 0, cond, rcfg, grid, small_dense=small_dense)
    Q = restore_locked(Q, Vp, jnp.int32(2 * locked))
    return permute_cols(Q, jnp.asarray(inv))


@partial(jax.jit, static_argnames=("precision",))
def _project_against_locked(V_full, W, start, *, precision="highest"):
    """W ← (I − L·Lᴴ)·W where L = the locked columns of V_full OUTSIDE the
    window, i.e. columns [0, start).  Masked full-width matmul so one XLA
    program serves every ``start`` (block classical Gram–Schmidt step)."""
    cols = jnp.arange(V_full.shape[1])
    L = jnp.where((cols < start)[None, :], V_full, jnp.zeros((), V_full.dtype))
    C = jnp.matmul(L.conj().T, W, precision=precision)
    return W - jnp.matmul(L, C, precision=precision)


@jax.jit
def _project_against_locked_wide(V_full, W, start):
    """_project_against_locked with both matmuls on the exact-bf16 slice
    GEMM (wide_f64='on')."""
    from .wide import wide_matmul
    cols = jnp.arange(V_full.shape[1])
    L = jnp.where((cols < start)[None, :], V_full,
                  jnp.zeros((), V_full.dtype))
    C = wide_matmul(L.T, W)
    return W - wide_matmul(L, C)


def orthonormalize_window(V, start, w_pad, locked, cond, rcfg, grid=None,
                          small_dense="device"):
    """Width-bucketed QR: orthonormalize only the padded active window.

    The reference shrinks every post-filter phase to the unconverged block
    (algorithm.inc:1712-1718) — here we shrink to the same static bucket
    widths the filter uses, so XLA compiles a handful of window programs.
    The window [start, nevex) holds the active columns plus ≤B−1 locked
    padding columns; columns [0, start) are locked and orthonormal.

      1. BCGS projection of the window against the out-of-window locked
         columns (one masked N·k·w matmul pair),
      2. cond-selected CholQR chain on the (N, w) window — Gram w×w instead
         of k×k,
      3. a second projection + CholQR1 (BCGS2 reorthogonalization — bounds
         the loss from step 1's classical projection),
      4. locked padding columns restored, window written back.

    Falls back to the full-block :func:`orthonormalize` (TSQR rescue) when
    the window Cholesky chain breaks down.
    """
    from .blocks import slice_cols, update_cols

    log = get_logger()
    precision = rcfg.matmul_precision
    upcast = None
    if rcfg.qr_hi_prec and not is_double_base(V.dtype):
        if jax.config.jax_enable_x64:
            upcast = np.complex128 if np.issubdtype(V.dtype, np.complexfloating) \
                else np.float64

    Vw0 = slice_cols(V, jnp.int32(start), w_pad)
    lw = locked - start
    if small_dense == "wide":
        W = _project_against_locked_wide(V, Vw0, jnp.int32(start))
    else:
        W = _project_against_locked(V, Vw0, jnp.int32(start),
                                    precision=precision)

    if (not rcfg.cholqr) and cond != 1.0:
        Q = tsqr(W, grid=grid, upcast=upcast)
        ok = True
        variant = "TSQR(window)"
    else:
        if cond > rcfg.cholqr_shift_threshold:
            passes, shifted, variant = 3, True, "shiftedCholQR2(window)"
        elif cond < rcfg.cholqr1_threshold:
            passes, shifted, variant = 1, False, "cholQR1(window)"
        else:
            passes, shifted, variant = 2, False, "cholQR2(window)"
        if small_dense == "wide":
            Q, ok = cholqr_wide(W, passes=passes, shifted=shifted,
                                precision=precision, upcast=upcast)
            variant += "+wide"
        elif (not shifted and V.shape[0] >= rcfg.mgs_qr_min_n
                and w_pad >= 12):
            Q, ok = mgs_cholqr(W, precision=precision, upcast=upcast)
            variant = "MGS-CholQR(window)"
        elif small_dense == "host":
            Q, ok = cholqr_hostchol(W, passes=passes, shifted=shifted,
                                    precision=precision, upcast=upcast)
        else:
            Q, ok = cholqr(W, passes=passes, shifted=shifted,
                           precision=precision, upcast=upcast)
    if bool(ok):
        # BCGS2 second sweep: re-project + re-orthonormalize.  Honor the
        # user's CholQR opt-out (CHASE_DISABLE_CHOLQR / --qr H) here too —
        # the TSQR window variant must stay Cholesky-free end to end.
        if small_dense == "wide":
            Q = _project_against_locked_wide(V, Q, jnp.int32(start))
        else:
            Q = _project_against_locked(V, Q, jnp.int32(start),
                                        precision=precision)
        if (not rcfg.cholqr) and cond != 1.0:
            Q = tsqr(Q, grid=grid, upcast=upcast)
            ok = True
        elif small_dense == "wide":
            Q, ok2 = cholqr_wide(Q, passes=1, precision=precision,
                                 upcast=upcast)
            ok = bool(ok2)
        elif small_dense == "host":
            # honor the explicit host opt-in for the cleanup pass too
            Q, ok2 = cholqr_hostchol(Q, passes=1, precision=precision,
                                     upcast=upcast)
            ok = bool(ok2)
        else:
            Q, ok2 = cholqr(Q, passes=1, precision=precision, upcast=upcast)
            ok = bool(ok2)
    if not bool(ok):
        log.warn(f"{variant} failed (non-PD Gram), falling back to "
                 f"full-block QR", "linalg")
        return orthonormalize(V, locked, cond, rcfg, grid,
                              small_dense=small_dense)
    log.debug(f"QR: {variant}, cond(V) ≈ {cond:.2e}", "linalg")
    if rcfg.qr_check_ortho:
        err = float(jnp.max(jnp.abs(
            _gram(Q, precision) - jnp.eye(Q.shape[1], dtype=Q.dtype))))
        thr = 100 * np.finfo(np.dtype(real_dtype(Q.dtype))).eps
        if err > thr:
            log.warn(f"QR(window) orthogonality check: {err:.2e} "
                     f"> {thr:.2e}", "linalg")
    Q = restore_locked(Q, Vw0, jnp.int32(lw))
    return update_cols(V, Q, jnp.int32(start))


def orthonormalize(V, locked, cond, rcfg, grid=None, small_dense="device"):
    """Condition-number-driven QR of the full block, locked cols preserved.

    Host-side driver mirroring Impl/chase_cpu/chase_cpu.hpp:629-776:
    cond > upper-threshold → shiftedCholQR2; cond < lower-threshold →
    CholQR1; otherwise CholQR2; Householder on Cholesky failure or when
    CholQR is disabled (and cond != 1.0).  On a device grid the
    Householder path is the distributed TSQR (see ``tsqr``) — the
    reference's distributed Householder QR analogue.

    Args:
      V: (N, nevex) device array (full block, locked columns at front).
      locked: host int — number of locked columns to preserve.
      cond: host float — condition estimate of the filtered basis.
      rcfg: ResolvedConfig.
      grid: optional Grid2D — enables the sharded TSQR fallback.
    Returns:
      (N, nevex) device array.
    """
    log = get_logger()
    precision = rcfg.matmul_precision
    upcast = None
    if rcfg.qr_hi_prec and not is_double_base(V.dtype):
        # QR_DOUBLE_PRECISION analogue — only when x64 is actually on.
        if jax.config.jax_enable_x64:
            upcast = np.complex128 if np.issubdtype(V.dtype, np.complexfloating) \
                else np.float64
    V_old = V

    if (not rcfg.cholqr) and cond != 1.0:
        Q = tsqr(V, grid=grid, upcast=upcast)
        return restore_locked(Q, V_old, jnp.int32(locked))

    if cond > rcfg.cholqr_shift_threshold:
        passes, shifted, variant = 3, True, "shiftedCholQR2"
    elif cond < rcfg.cholqr1_threshold:
        passes, shifted, variant = 1, False, "cholQR1"
    else:
        passes, shifted, variant = 2, False, "cholQR2"
    use_mgs = (not shifted and V.shape[0] >= rcfg.mgs_qr_min_n
               and V.shape[1] >= 12 and small_dense != "wide")
    if small_dense == "wide":
        Q, ok = cholqr_wide(V, passes=passes, shifted=shifted,
                            precision=precision, upcast=upcast)
        variant += "+wide"
    elif use_mgs:
        # very tall blocks: panelized Gram-Schmidt CholQR bounds the Gram
        # accumulation error (reference auto-selects at N >= 1e5,
        # Impl/config/config.hpp:9)
        Q, ok = mgs_cholqr(V, precision=precision, upcast=upcast)
        variant = "MGS-CholQR"
    elif small_dense == "host":
        Q, ok = cholqr_hostchol(V, passes=passes, shifted=shifted,
                                precision=precision, upcast=upcast)
        variant += "(host-factorized)"
    else:
        Q, ok = cholqr(V, passes=passes, shifted=shifted,
                       precision=precision, upcast=upcast)

    if not bool(ok):
        log.warn(f"{variant} failed (non-PD Gram), falling back to "
                 f"Householder (TSQR) QR", "linalg")
        Q = tsqr(V_old, grid=grid, upcast=upcast)
    else:
        log.debug(f"QR: {variant}, cond(V) ≈ {cond:.2e}", "linalg")
    if rcfg.qr_check_ortho:
        # CHASE_QR_CHECK_ORTHO analogue (nccl/householder_qr.hpp:292)
        err = float(jnp.max(jnp.abs(
            _gram(Q, rcfg.matmul_precision)
            - jnp.eye(Q.shape[1], dtype=Q.dtype))))
        thr = 100 * np.finfo(np.dtype(real_dtype(Q.dtype))).eps
        if err > thr:
            log.warn(f"QR orthogonality check: ||Q^H Q - I|| = {err:.2e} "
                     f"> {thr:.2e}", "linalg")
        else:
            log.debug(f"QR orthogonality check: {err:.2e}", "linalg")
    return restore_locked(Q, V_old, jnp.int32(locked))
