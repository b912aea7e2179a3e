"""Pseudo-Hermitian (BSE) kernels: S-metric ops, H² filter, K-conjugation,
S-Lanczos and the pseudo Rayleigh–Ritz pencil solve.

JAX redesign of the reference's BSE machinery:

* ``flipLowerHalfMatrixSign`` (cpu/utils.hpp:99-120, flipSign.cu) — applying
  the metric S = diag(I_{N/2}, −I_{N/2}) — becomes a row-mask multiply that
  XLA fuses into the adjacent matmul.
* ``HEMM_H2`` (chase_cpu.hpp:510-555): two back-to-back matmuls + axpy; the
  Chebyshev recurrence on H² lives here with the same degree-mask /
  traced-trip-count structure as the Hermitian filter.
* ``ApplyKconjugate`` (chase_cpu.hpp:557-588): the mirror eigenvector
  x(λ) → K x = conj(swap_halves(x)) for −λ becomes a gather with host-built
  index/mask arrays — one XLA program for every (locked, unconverged).
* Pseudo-Lanczos in the M = S·H inner product (cpu/lanczos.hpp:330-510,
  per Grüning et al.), batched over probes in one lax.scan.
* ``rayleighRitz_v2`` (cpu/rayleighRitz.hpp:284-392): Hermitianized pencil
  QᴴSHQ y = θ QᴴSQ y via Cholesky + two triangular solves; here with
  static full width and identity/-identity padding of the masked (locked)
  slots so one XLA program serves every `locked`; fused with residuals.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..types import real_dtype

__all__ = [
    "flip_lower_half", "apply_s", "chebyshev_filter_h2", "k_conjugate_cols",
    "lanczos_scan_pseudo", "rayleigh_ritz_residuals_pseudo",
    "flip_locked_cols", "residuals_pseudo", "chebyshev_filter_refine_h2",
    "h2_residual", "h2_residual_wide", "h2_carry_init", "h2_steps",
    "refine_h2_steps",
]


def apply_s(X):
    """S·X where S = diag(I_{N/2}, −I_{N/2}) — fused sign flip, no copy of S."""
    n2 = X.shape[0] // 2
    rows = jnp.arange(X.shape[0])
    return jnp.where((rows >= n2)[:, None], -X, X)


flip_lower_half = apply_s


@jax.jit
def flip_locked_cols(V, nflip):
    """Flip the lower-half sign of the first ``nflip`` columns (traced).

    The S-orthogonalization trick of the pseudo QR (chase_cpu.hpp:597-626):
    CholQR against S·x_locked makes the active block S-orthogonal to the
    locked eigenvectors.
    """
    n2 = V.shape[0] // 2
    rows = jnp.arange(V.shape[0])[:, None]
    cols = jnp.arange(V.shape[1])[None, :]
    flip = (rows >= n2) & (cols < nflip)
    return jnp.where(flip, -V, V)


@jax.jit
def k_conjugate_cols(V, src_idx, write_mask):
    """out[:, j] = K(V[:, src_idx[j]]) where write_mask[j], else V[:, j].

    K x = conj([x_lower; x_upper]) maps the eigenvector of λ to the one of
    −λ (BSE symmetry).  src_idx/write_mask are data, so a single XLA
    program covers every (locked, unconverged) geometry.
    """
    src = jnp.take(V, src_idx, axis=1)
    n2 = V.shape[0] // 2
    Ks = jnp.concatenate([src[n2:], src[:n2]], axis=0).conj()
    return jnp.where(write_mask[None, :], Ks, V)


def _h2_shift(H, X, c, precision):
    """(H² − c·I) @ X via two matmuls (HEMM_H2 with γ = −αc folded).

    When H is stored in a narrower dtype than the carry X (the bf16 storage
    rung for f32 BSE problems, or the f32 mixed-precision shadow of a DP
    problem — P10 on the pseudo path), both matmuls take reduced-precision
    inputs but accumulate in X's dtype
    (``preferred_element_type``), exactly like ops.filter._hemm_shift.  The
    intermediate H·X is rounded back to H's dtype for the second product;
    the step error is O(eps_low·‖H‖²·‖X‖) — the same RELATIVE scale vs the
    H²-spectrum bound b_sup as the Hermitian rung's eps_low·‖H‖ vs upperb.
    """
    if H.dtype != X.dtype:
        W = jnp.matmul(H, X.astype(H.dtype), precision=precision,
                       preferred_element_type=X.dtype)
        HX = jnp.matmul(H, W.astype(H.dtype), precision=precision,
                        preferred_element_type=X.dtype)
        return HX - c * X
    return jnp.matmul(H, jnp.matmul(H, X, precision=precision),
                      precision=precision) - c * X


@partial(jax.jit, static_argnames=("precision",), donate_argnums=(1,))
def chebyshev_filter_h2(H, X, degrees, lam1, lower, upper, deg_max, *,
                        precision="highest"):
    """Degree-masked Chebyshev filter on H² (algorithm.inc:1012-1064).

    ``lam1/lower/upper`` are H²-spectrum quantities (μ₁, μ_nev+nex, b_sup).
    No shift of H: the interval shift is folded into the matmul epilogue.
    H may be a reduced-precision shadow (mixed precision / bf16 rung): the
    recurrence carry follows ``filter_carry_dtype`` with reduced-input
    matmuls accumulating in the carry dtype (see :func:`_h2_shift`).
    """
    from ..types import filter_carry_dtype
    out_dtype = X.dtype
    carry_dt = filter_carry_dtype(H.dtype, X.dtype)
    rt = real_dtype(carry_dt)
    Xc = X.astype(carry_dt)

    lam1 = jnp.asarray(lam1, rt)
    lo = jnp.minimum(jnp.asarray(lower, rt), jnp.asarray(upper, rt))
    up = jnp.maximum(jnp.asarray(lower, rt), jnp.asarray(upper, rt))
    c = (up + lo) / 2
    e = (up - lo) / 2
    sigma1 = e / (lam1 - c)

    alpha1 = sigma1 / e
    Y = alpha1 * _h2_shift(H, Xc, c, precision)
    Y = jnp.where(degrees[None, :] >= 1, Y, Xc)

    def body(t, carry):
        Xp, Yc, sigma = carry
        tau = 1.0 / (2.0 / sigma1 - sigma)
        alpha = 2.0 * tau / e
        beta = -sigma * tau
        Z = alpha * _h2_shift(H, Yc, c, precision) + beta * Xp
        upd = degrees[None, :] >= t
        Z = jnp.where(upd, Z, Yc)
        return (Yc, Z, tau)

    deg_max = jnp.asarray(deg_max, jnp.int32)
    _, Y, _ = jax.lax.fori_loop(2, deg_max + 1, body, (Xc, Y, sigma1))
    # degree-0 (locked/padding) columns bit-exact: a reduced carry must not
    # round-trip untouched problem-dtype columns through the carry dtype
    return jnp.where(degrees[None, :] >= 1, Y.astype(out_dtype), X)


# -- segmented H² building blocks (window shrink, ops/filter analogues) ----

@partial(jax.jit, static_argnames=("precision",))
def h2_carry_init(H, X, degrees, c, e, sigma1, *, precision="highest"):
    """First H² recurrence step; returns (X, Y, sigma) carry.  X arrives
    already cast to the carry dtype."""
    rt = real_dtype(X.dtype)
    alpha1 = jnp.asarray(sigma1 / e, rt)
    c = jnp.asarray(c, rt)
    Y = alpha1 * _h2_shift(H, X, c, precision)
    Y = jnp.where(degrees[None, :] >= 1, Y, X)
    return X, Y, jnp.asarray(sigma1, rt)


@partial(jax.jit, static_argnames=("precision",))
def h2_steps(H, Xp, Yc, degrees, sigma, sigma1, c, e, t0, t1, *,
             precision="highest"):
    """H² recurrence steps t in [t0, t1) on a (possibly shrunk) window."""
    def body(t, carry):
        Xp, Yc, sigma = carry
        tau = 1.0 / (2.0 / sigma1 - sigma)
        Z = (2.0 * tau / e) * _h2_shift(H, Yc, c, precision) \
            - (sigma * tau) * Xp
        Z = jnp.where(degrees[None, :] >= t, Z, Yc)
        return (Yc, Z, tau)

    return jax.lax.fori_loop(jnp.asarray(t0, jnp.int32),
                             jnp.asarray(t1, jnp.int32),
                             body, (Xp, Yc, sigma))


@partial(jax.jit, static_argnames=("precision",))
def refine_h2_steps(H, Wp, Wc, Rc, degrees, alphas, betas, inj, cc, t0, t1,
                    *, precision="highest"):
    """Deviation-recurrence steps on H² for [t0, t1) — the segmented
    variant of :func:`chebyshev_filter_refine_h2`'s loop body."""
    def body(t, st):
        Wp, Wc = st
        Z = (alphas[t] * _h2_shift(H, Wc, cc, precision)
             + betas[t] * Wp + inj[t][None, :] * Rc)
        Z = jnp.where(degrees[None, :] >= t, Z, Wc)
        return (Wc, Z)

    return jax.lax.fori_loop(jnp.asarray(t0, jnp.int32),
                             jnp.asarray(t1, jnp.int32), body, (Wp, Wc))


# -- dispatch-folded H² segment programs (ops/filter.filter_seg_* twins) ---

@partial(jax.jit, static_argnames=("w_pad", "precision"))
def h2_seg_init(H, V, start, deg_win, c, e, sigma1, *, w_pad,
                precision="highest"):
    """Slice the window and run H² recurrence step 1 — one program."""
    from ..types import filter_carry_dtype
    carry = filter_carry_dtype(H.dtype, V.dtype)
    X0 = jax.lax.dynamic_slice(V, (jnp.int32(0), start),
                               (V.shape[0], w_pad))
    Xc = X0.astype(carry)
    rt = real_dtype(carry)
    alpha1 = jnp.asarray(sigma1 / e, rt)
    cc = jnp.asarray(c, rt)
    Y = alpha1 * _h2_shift(H, Xc, cc, precision)
    Y = jnp.where(deg_win[None, :] >= 1, Y, Xc)
    return X0, Xc, Y, jnp.asarray(sigma1, rt)


@partial(jax.jit, static_argnames=("w_new", "precision"),
         donate_argnums=(1, 2, 3, 4))
def h2_seg_steps(H, V, X0, Xp, Yc, deg_win, sigma, sigma1, c, e, off,
                 start_new, t0, t1, *, w_new, precision="highest"):
    """One fused H² segment: shrink carries, run steps [t0, t1), write the
    masked window back — one program."""
    if w_new != Xp.shape[1]:
        X0 = jax.lax.dynamic_slice(X0, (jnp.int32(0), off),
                                   (X0.shape[0], w_new))
        Xp = jax.lax.dynamic_slice(Xp, (jnp.int32(0), off),
                                   (Xp.shape[0], w_new))
        Yc = jax.lax.dynamic_slice(Yc, (jnp.int32(0), off),
                                   (Yc.shape[0], w_new))

    def body(t, carry):
        Xp, Yc, sigma = carry
        tau = 1.0 / (2.0 / sigma1 - sigma)
        Z = (2.0 * tau / e) * _h2_shift(H, Yc, c, precision) \
            - (sigma * tau) * Xp
        Z = jnp.where(deg_win[None, :] >= t, Z, Yc)
        return (Yc, Z, tau)

    Xp, Yc, sigma = jax.lax.fori_loop(
        jnp.asarray(t0, jnp.int32), jnp.asarray(t1, jnp.int32),
        body, (Xp, Yc, sigma))
    Yw = jnp.where(deg_win[None, :] >= 1, Yc.astype(V.dtype), X0)
    V = jax.lax.dynamic_update_slice(V, Yw, (jnp.int32(0), start_new))
    return V, X0, Xp, Yc, sigma


@partial(jax.jit, static_argnames=("w_new", "precision"),
         donate_argnums=(1, 2, 3, 4, 5))
def refine_h2_seg_steps(H, V, X0, Wp, Wc, Rc, deg_win, alphas, betas, inj,
                        p_final, cc, off, start_new, t0, t1, *, w_new,
                        precision="highest"):
    """Fused H² deviation segment: shrink carries, run steps [t0, t1),
    combine and write back — one program."""
    if w_new != Wc.shape[1]:
        X0 = jax.lax.dynamic_slice(X0, (jnp.int32(0), off),
                                   (X0.shape[0], w_new))
        Wp = jax.lax.dynamic_slice(Wp, (jnp.int32(0), off),
                                   (Wp.shape[0], w_new))
        Wc = jax.lax.dynamic_slice(Wc, (jnp.int32(0), off),
                                   (Wc.shape[0], w_new))
        Rc = jax.lax.dynamic_slice(Rc, (jnp.int32(0), off),
                                   (Rc.shape[0], w_new))

    def body(t, st):
        Wp, Wc = st
        Z = (alphas[t] * _h2_shift(H, Wc, cc, precision)
             + betas[t] * Wp + inj[t][None, :] * Rc)
        Z = jnp.where(deg_win[None, :] >= t, Z, Wc)
        return (Wc, Z)

    Wp, Wc = jax.lax.fori_loop(
        jnp.asarray(t0, jnp.int32), jnp.asarray(t1, jnp.int32),
        body, (Wp, Wc))
    rtv = real_dtype(V.dtype)
    Y = p_final[None, :].astype(rtv) * X0 + Wc.astype(V.dtype)
    Y = jnp.where(deg_win[None, :] >= 1, Y, X0)
    V = jax.lax.dynamic_update_slice(V, Y, (jnp.int32(0), start_new))
    return V, X0, Wp, Wc, Rc


# -- deviation-form refinement filter on H² (the DP-tolerance BSE ladder) ---
#
# Same algebra as ops/filter.chebyshev_filter_refine, applied to G = H²: for
# any scalar μ_j the deviation w_t = p_t(Gs)v_j − p_t(μs_j)v_j obeys the
# three-term recurrence of p_t plus an additive injection proportional to the
# H²-RESIDUAL r2_j = (G − μ_j)v_j.  Choosing μ_j = θ_j² (the pencil-RR Ritz
# value squared) factors r2_j = (H + θ_j)(H − θ_j)v_j = (H + θ_j)·r_j, i.e. ONE
# extra f64-accurate HEMM on the (small) H-residual vectors the pencil RR
# already produces.  Every intermediate of the w recurrence is then
# O(|p|·‖e_j‖), so it runs in the fast dtypes while the solve contracts to the
# f64 floor — the reference instead hands Solve_pseudo's filter back to DP
# below resid 1e-3 (algorithm.inc:1834-2220 at the DP tolerance of
# configuration.hpp:53-62).  Coefficient tables come from
# ops.filter.refine_tables with the H²-space quantities (μ = θ², λ₁ = μ₁,
# [lower, b_sup]): the σ-recurrence is identical — only the operator
# application differs (_h2_shift).


@partial(jax.jit, static_argnames=("precision",))
def chebyshev_filter_refine_h2(H, V, R2, degrees, alpha1_e, alphas, betas,
                               inj, p_final, cc, deg_max, *,
                               precision="highest"):
    """Deviation-form Chebyshev filter on H²: y_j = p_final_j·v_j + w_j with
    the w recurrence in the fast dtype of ``H``.

    Args:
      H: (N, N) pseudo-Hermitian operator in the FAST dtype (f32/bf16
         shadow of the problem).
      V: (N, w) current (post-pencil-RR) Ritz block, PROBLEM dtype.
      R2: (N, w) H²-residual vectors (H² − θ²_j)v_j, problem dtype
         (:func:`h2_residual` / :func:`h2_residual_wide`).
      degrees: (w,) int32 per-column H² degrees; 0 = untouched.
      alpha1_e, alphas, betas, inj, p_final: ops.filter.refine_tables
         output for (θ², degrees, μ₁, lower, b_sup).
      cc: H²-interval center (host float).
      deg_max: traced int scalar — loop trip count.

    Returns: (N, w) filtered block, problem dtype.
    """
    from ..types import filter_carry_dtype
    carry = filter_carry_dtype(H.dtype, V.dtype)
    rt = real_dtype(carry)
    Rc = R2.astype(carry)
    cc = jnp.asarray(cc, rt)
    alphas = jnp.asarray(alphas, rt)
    betas = jnp.asarray(betas, rt)
    inj = jnp.asarray(inj, rt)

    W = jnp.asarray(alpha1_e, rt) * Rc                      # w_1 = (σ1/e)·r2
    Wp = jnp.zeros_like(Rc)                                 # w_0 = 0

    def body(t, st):
        Wp, Wc = st
        Z = (alphas[t] * _h2_shift(H, Wc, cc, precision)
             + betas[t] * Wp + inj[t][None, :] * Rc)
        Z = jnp.where(degrees[None, :] >= t, Z, Wc)
        return (Wc, Z)

    deg_max = jnp.asarray(deg_max, jnp.int32)
    _, W = jax.lax.fori_loop(2, deg_max + 1, body, (Wp, W))

    rtv = real_dtype(V.dtype)
    Y = jnp.asarray(p_final, rtv)[None, :] * V + W.astype(V.dtype)
    return jnp.where(degrees[None, :] >= 1, Y, V)


@partial(jax.jit, static_argnames=("precision",))
def h2_residual(H, R, theta, *, precision="highest"):
    """H²-residual vectors from the pencil RR's H-residuals:
    r2_j = (H + θ_j)·r_j = H·r_j + θ_j·r_j (no large-term cancellation —
    both addends are O(‖H‖·‖r‖)).  Must run f64-accurately: error here
    enters the deviation recurrence directly and caps the ladder's floor."""
    W = jnp.matmul(H, R, precision=precision)
    return W + theta[None, :].astype(R.dtype) * R


@partial(jax.jit, static_argnames=("s", "L"))
def _h2_residual_wide_impl(a_slices, sa, R, theta, *, s, L):
    from .wide import _wide_matmul_presliced
    W = _wide_matmul_presliced(a_slices, sa, R, s=s, L=L, cut=L - 1)
    return W + theta[None, :].astype(R.dtype) * R


def h2_residual_wide(H_wide, R, theta):
    """:func:`h2_residual` with the HEMM on the exact-bf16 slice GEMM
    (ops/wide) — f64 BSE problems on accelerators without f64 matmul
    hardware (the pseudo arm of the wide-f64 policy)."""
    a_slices, sa, s, L = H_wide
    return _h2_residual_wide_impl(a_slices, sa, R, theta, s=s, L=L)


@partial(jax.jit, static_argnames=("m", "precision", "want_basis"))
def lanczos_scan_pseudo(H, V0, *, m, precision="highest", want_basis=True):
    """Batched Lanczos of the pseudo-Hermitian H in the M = S·H inner
    product (HPD for BSE).  Mirrors cpu/lanczos.hpp:330-510 in scaled form:

      β²_k = Re(v₁ᴴ S H v₁)  (M-norm²),  α_k = Re(wᴴ S w)  with w = H v₁.

    Returns (alphas (m,nv), betas (m,nv) [betas[:-1] = e], basis (m,N) of
    the last probe).  The Ritz values of (d,e) approximate the *signed*
    spectrum of H.
    """
    rt = real_dtype(H.dtype)

    def s_dot(a, b):
        return jnp.sum(a.conj() * apply_s(b), axis=0).real.astype(rt)

    v1 = V0.astype(H.dtype)
    w = jnp.matmul(H, v1, precision=precision)
    b2 = s_dot(v1, w)
    b = jnp.sqrt(jnp.abs(b2))
    safe = jnp.where(b > 0, b, jnp.ones((), rt))
    v1 = v1 / safe[None, :].astype(v1.dtype)
    w = w / safe[None, :].astype(w.dtype)
    v0 = jnp.zeros_like(v1)
    e_prev = jnp.zeros((v1.shape[1],), rt)

    def step(carry, _):
        v0, v1, w, e_prev = carry
        alpha = s_dot(w, w)
        w2 = w - alpha[None, :].astype(w.dtype) * v1 \
               - e_prev[None, :].astype(w.dtype) * v0
        # next basis vector (unnormalized) and its M-norm
        Hw = jnp.matmul(H, w2, precision=precision)
        b2 = s_dot(w2, Hw)
        e_k = jnp.sqrt(jnp.abs(b2))
        safe = jnp.where(e_k > 0, e_k, jnp.ones((), rt))
        v1n = w2 / safe[None, :].astype(w2.dtype)
        wn = Hw / safe[None, :].astype(Hw.dtype)
        out = (alpha, e_k, v1[:, -1]) if want_basis else (alpha, e_k)
        return (v1, v1n, wn, e_k), out

    _, outs = jax.lax.scan(step, (v0, v1, w, e_prev), None, length=m)
    if want_basis:
        alphas, betas, basis = outs
        return alphas, betas, basis
    alphas, betas = outs
    return alphas, betas, None


def host_pencil_factor(A_h, B_h, rt):
    """Host LAPACK f64 factorization of the Hermitianized pencil: Cholesky
    of A = QᴴSHQ, M = −L⁻¹ B L⁻ᴴ, eigh, back-solve, normalize.  Returns
    (theta, X, ok); on Cholesky breakdown L falls back to identity (the
    device path's behavior) with ok=False.  Shared by the split-sync host
    RR below and the fused pseudo solver's pure_callback."""
    import numpy as _np
    import scipy.linalg as sla

    A_h, B_h = _np.asarray(A_h), _np.asarray(B_h)
    wide = _np.complex128 if _np.iscomplexobj(A_h) else _np.float64
    try:
        L = _np.linalg.cholesky(A_h.astype(wide))
        ok = True
    except _np.linalg.LinAlgError:
        L = _np.eye(A_h.shape[0], dtype=wide)
        ok = False
    C = sla.solve_triangular(L, B_h.astype(wide), lower=True)
    C = sla.solve_triangular(L, C.conj().T, lower=True).conj().T
    M = -(C + C.conj().T) / 2
    w, Z = _np.linalg.eigh(M)
    theta = -1.0 / _np.where(_np.abs(w) > 0, w, 1.0)
    X = sla.solve_triangular(L, Z, lower=True, trans="C")
    nrm = _np.linalg.norm(X, axis=0)
    X = X / _np.where(nrm > 0, nrm, 1.0)[None, :]
    return (theta.real.astype(_np.dtype(rt)), X.astype(A_h.dtype), ok)


@partial(jax.jit, static_argnames=("precision",))
def _prr_project(H, V, locked, *, precision="highest"):
    """Device half 1 of the pencil RR: masked block + both pencil matrices."""
    K2 = V.shape[1]
    rt = real_dtype(V.dtype)
    cols = jnp.arange(K2)
    active = (cols >= locked) & (cols < K2 - locked)

    Q = jnp.where(active[None, :], V, jnp.zeros((), V.dtype))
    W = jnp.matmul(H, Q, precision=precision)          # H·Q (reused for resid)
    T = apply_s(W)                                     # S·H·Q
    A = jnp.matmul(Q.conj().T, T, precision=precision)  # QᴴSHQ (HPD on active)
    pad_p = jnp.where(active, jnp.zeros((), rt), jnp.ones((), rt))
    A = A + jnp.diag(pad_p).astype(A.dtype)
    SQ = apply_s(Q)
    B = jnp.matmul(Q.conj().T, SQ, precision=precision)  # QᴴSQ
    B = B - jnp.diag(pad_p).astype(B.dtype)               # pad −1
    return Q, W, A, B


@partial(jax.jit, static_argnames=("precision", "want_vectors", "wide"))
def _prr_finish(Q, W, V, theta, X, locked, *, precision="highest",
                want_vectors=False, wide=False):
    """Device half 2: rotate, residuals, roll, merge.  ``wide`` routes the
    rotations through the exact-bf16-slice GEMM; ``want_vectors`` also
    returns the H-residual vectors (rolled like everything else) — they
    seed the H² deviation-form refinement filter."""
    K2 = V.shape[1]
    rt = real_dtype(V.dtype)
    cols = jnp.arange(K2)
    u = K2 // 2 - locked   # number of kept (positive) Ritz pairs

    if wide:
        from .wide import wide_matmul
        Vrot = wide_matmul(Q, X)
        Wrot = wide_matmul(W, X)                          # = H·Vrot
    else:
        Vrot = jnp.matmul(Q, X, precision=precision)
        Wrot = jnp.matmul(W, X, precision=precision)      # = H·Vrot
    R = Wrot - Vrot * theta[None, :].astype(V.dtype)
    resid = jnp.linalg.norm(R, axis=0).real.astype(rt)

    # wanted pairs live at eigh positions [0, u); roll to [locked, locked+u)
    Vrot = jnp.roll(Vrot, locked, axis=1)
    theta = jnp.roll(theta, locked)
    resid = jnp.roll(resid, locked)
    write = (cols >= locked) & (cols < locked + u)
    V_out = jnp.where(write[None, :], Vrot, V)
    if want_vectors:
        return V_out, theta, resid, jnp.roll(R, locked, axis=1)
    return V_out, theta, resid


@partial(jax.jit, static_argnames=("s", "L"))
def _prr_project_wide(a_slices, sa, V, locked, *, s, L):
    """_prr_project with every N-contraction f64 matmul on the exact-bf16
    slice path (ops/wide): the pseudo arm of the wide-f64 policy.  The
    active columns are renormalized first (wide mode is f64-only, where the
    Hermitian RR renormalizes too — see ops/rr._rr_project)."""
    from .wide import _wide_matmul_presliced, wide_matmul
    K2 = V.shape[1]
    rt = real_dtype(V.dtype)
    cols = jnp.arange(K2)
    active = (cols >= locked) & (cols < K2 - locked)

    Q = jnp.where(active[None, :], V, jnp.zeros((), V.dtype))
    nrm = jnp.linalg.norm(Q, axis=0).real.astype(rt)
    Q = Q / jnp.where(nrm > 0, nrm, jnp.ones((), rt))[None, :].astype(Q.dtype)
    W = _wide_matmul_presliced(a_slices, sa, Q, s=s, L=L, cut=L - 1)  # H·Q
    T = apply_s(W)                                       # S·H·Q
    A = wide_matmul(Q.T, T)                              # QᵀSHQ (HPD on active)
    pad_p = jnp.where(active, jnp.zeros((), rt), jnp.ones((), rt))
    A = A + jnp.diag(pad_p).astype(A.dtype)
    SQ = apply_s(Q)
    B = wide_matmul(Q.T, SQ)                             # QᵀSQ
    B = B - jnp.diag(pad_p).astype(B.dtype)              # pad −1
    return Q, W, A, B


@partial(jax.jit, static_argnames=("precision", "polish", "want_vectors"))
def _prr_device(H, V, locked, *, precision="highest", polish=0,
                want_vectors=False):
    K2 = V.shape[1]
    rt = real_dtype(V.dtype)
    Q, W, A, B = _prr_project(H, V, locked, precision=precision)

    L = jnp.linalg.cholesky(A)
    ok = jnp.isfinite(L.real).all()
    L = jnp.where(ok, L, jnp.eye(K2, dtype=A.dtype))

    C = jax.lax.linalg.triangular_solve(L, B, left_side=True, lower=True)
    C = jax.lax.linalg.triangular_solve(L, C, left_side=False, lower=True,
                                        transpose_a=True, conjugate_a=True)
    M = -(C + C.conj().T) / 2                             # Hermitize −L⁻¹BL⁻ᴴ

    # polish default 0: the S-metric pencil, not the eigh vector
    # floor, bounds its accuracy; opt in via config.eigh_polish
    from .rr import eigh_polished
    w, Z = eigh_polished(M, passes=polish, precision=precision)  # ascending
    w = w.real.astype(rt)
    theta = -1.0 / jnp.where(jnp.abs(w) > 0, w, jnp.ones((), rt))

    X = jax.lax.linalg.triangular_solve(L, Z, left_side=True, lower=True,
                                        transpose_a=True, conjugate_a=True)
    nrm = jnp.linalg.norm(X, axis=0).real.astype(rt)
    X = X / jnp.where(nrm > 0, nrm, jnp.ones((), rt))[None, :].astype(X.dtype)
    out = _prr_finish(Q, W, V, theta, X, locked, precision=precision,
                      want_vectors=want_vectors)
    return (*out, ok)


def rayleigh_ritz_residuals_pseudo(H, V, locked, *, precision="highest",
                                   small_dense="device", polish=0,
                                   want_vectors=False, H_wide=None):
    """Pseudo-Hermitian Rayleigh–Ritz (v2, Hermitianized pencil) fused with
    residuals, static full width.

    V: (N, 2·nevex) block laid out [locked_L | active 2u | locked_R] with
    u = nevex − locked.  Columns outside the active range are masked out
    and their pencil slots padded (A←+1, B←−1 on the diagonal) so the
    padded eigenvalues w = +1 sort after every wanted (positive-θ) w < 0.

    ``small_dense="host"``: the K2×K2 pencil factorization (Cholesky,
    triangular solves, eigh, back-solve) runs on host LAPACK in f64
    between two jitted halves — same split-sync rationale as
    ops/rr.rayleigh_ritz_residuals.

    ``H_wide``: pre-sliced operator (DenseOperator.H_wide) — the big f64
    HEMMs run on the exact-bf16 slice path (implies the host pencil
    factorization); H may be None then.  ``want_vectors``: also return the
    H-residual vectors R (rolled layout) for the H² refinement ladder.

    Returns:
      V_out: V with columns [locked, locked+u) replaced by the positive
             Ritz vectors (ascending θ).
      theta: (2·nevex,) — positions [locked, locked+u) hold the positive
             Ritz values ascending.
      resid: same layout; ‖H v − θ v‖₂.
      [R:    (N, 2·nevex) H-residual vectors, same layout —
             ``want_vectors=True`` only.]
      ok:    False when the pencil Cholesky broke down.
    """
    rt = real_dtype(V.dtype)
    if H_wide is not None:
        a_slices, sa, s, L = H_wide
        Q, W, A, B = _prr_project_wide(a_slices, sa, V, locked, s=s, L=L)
        theta, X, ok = host_pencil_factor(A, B, rt)
        out = _prr_finish(
            Q, W, V, jnp.asarray(theta), jnp.asarray(X), locked,
            precision=precision, want_vectors=want_vectors, wide=True)
        return (*out, jnp.bool_(ok))

    if small_dense != "host":
        return _prr_device(H, V, locked, precision=precision, polish=polish,
                           want_vectors=want_vectors)

    Q, W, A, B = _prr_project(H, V, locked, precision=precision)
    theta, X, ok = host_pencil_factor(A, B, rt)
    out = _prr_finish(
        Q, W, V, jnp.asarray(theta), jnp.asarray(X), locked,
        precision=precision, want_vectors=want_vectors)
    return (*out, jnp.bool_(ok))


def rayleigh_ritz_pseudo_geev(H, Q, *, precision="highest"):
    """Debug/reference pseudo Rayleigh–Ritz via the non-Hermitian quotient.

    Port of the v1 path (cpu/rayleighRitz.hpp:146-250, the XGEEV variant):
    builds the oblique Rayleigh quotient with the dual (S-metric) left
    basis and solves it with a general eigensolver on the host (numpy
    ``eig``) and kept — per the reference's own practice — as the
    independent cross-check for the production Hermitianized pencil path
    (SURVEY §7 risk 3).

    Returns (theta ascending, ritz vectors in the original space).
    """
    import numpy as np_
    Qn = np_.asarray(Q)
    Hn = np_.asarray(H)
    n = Qn.shape[1]
    k = Hn.shape[0] // 2
    T = Hn @ Qn                                   # A·Q
    W = Qn.conj().T @ T                           # Qᴴ A Q
    M = -2.0 * (Qn[k:].conj().T @ Qn[k:])         # -2 Q₂ᴴQ₂
    diag = 1.0 / (1.0 + np_.diagonal(M).copy())   # (Qᴴ S Q)⁻¹ diagonal
    np_.fill_diagonal(M, 0.0)
    A = -(M @ W)                                  # (Diag - M)·W off-diag part
    Tf = T.copy()
    Tf[k:] *= -1                                  # S·A·Q
    A = A + Qn.conj().T @ Tf
    A = diag[:, None] * A                         # row-rescale by (QᴴSQ)⁻¹
    w, Z = np_.linalg.eig(A)
    order = np_.argsort(w.real)
    theta = w.real[order]
    V = Qn @ Z[:, order]
    return theta, V


@partial(jax.jit, static_argnames=("precision",))
def residuals_pseudo(H, V, theta, *, precision="highest"):
    """Standalone ‖H v − θ v‖ for pseudo-Hermitian verification."""
    W = jnp.matmul(H, V, precision=precision)
    R = W - V * theta[None, :].astype(V.dtype)
    return jnp.linalg.norm(R, axis=0).real.astype(real_dtype(V.dtype))
