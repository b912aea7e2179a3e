"""Chebyshev polynomial filter — the hot kernel.

JAX redesign of the reference's scaled-and-shifted three-term
Chebyshev recurrence (algorithm/algorithm.inc:942-1009 `Algorithm::filter`
driving `HEMM` per backend, e.g. Impl/chase_cpu/chase_cpu.hpp:449-508).

Differences from the reference, driven by XLA semantics:

* The diagonal shift ``H - cI`` is folded into the matmul epilogue
  (``H@V - c*V``) instead of mutating H's diagonal in place
  (``ChaseBase::Shift``).  H stays immutable — important because H is a
  sharded, donated-free constant that XLA keeps resident in device memory.
* Per-vector degree retirement (the reference shrinks the GEMM width via
  pointer walks as columns retire, algorithm.inc:974-1000) is expressed with
  a *static-width* window plus per-column degree masks: step ``t`` updates
  column ``j`` iff ``t <= degrees[j]``.  Columns with ``degrees == 0`` pass
  through untouched, which the solver uses both for bucket padding and for
  locked columns caught inside the window.
* The whole recurrence is one ``lax.fori_loop`` with a *traced* trip count,
  so one XLA compilation serves every degree distribution at a given window
  width.
* Mixed precision (reference `ENABLE_MIXED_PRECISION`,
  chase_cpu.hpp:384-447): the caller passes an ``H`` already cast to the
  reduced dtype; ``X`` is cast on entry and the result cast back.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..types import filter_carry_dtype, real_dtype

__all__ = ["chebyshev_filter", "filter_carry_init", "filter_steps",
           "chebyshev_filter_refine", "refine_tables", "refine_steps",
           "refine_combine"]


def _hemm_shift(H, X, c, precision):
    """(H - c·I) @ X without touching H's diagonal.

    When H is stored in a narrower dtype than the carry X (the bf16
    storage rung of the mixed-precision ladder, P10), the matmul takes
    reduced-precision inputs but accumulates in X's dtype
    (``preferred_element_type``) — the bf16 tensor-core rung with the
    carry kept at full f32.
    """
    if H.dtype != X.dtype:
        HX = jnp.matmul(H, X.astype(H.dtype), precision=precision,
                        preferred_element_type=X.dtype)
        return HX - c * X
    return jnp.matmul(H, X, precision=precision) - c * X


@partial(jax.jit, static_argnames=("precision",), donate_argnums=(1,))
def chebyshev_filter(H, X, degrees, lam1, lower, upper, deg_max, *,
                     precision="highest"):
    """Apply the degree-masked scaled Chebyshev filter to the window ``X``.

    Args:
      H: (N, N) operator, possibly in a reduced dtype (mixed precision).
      X: (N, w) active window of the search subspace (problem dtype).
      degrees: (w,) int32 per-column polynomial degrees; 0 = leave untouched.
      lam1: estimate of the smallest eigenvalue (filter amplification point).
      lower, upper: interval of the spectrum to damp.
      deg_max: traced scalar — max(degrees); loop trip count.
      precision: matmul precision for the recurrence.

    Returns:
      (N, w) filtered window, in X's dtype.
    """
    out_dtype = X.dtype
    carry = filter_carry_dtype(H.dtype, X.dtype)
    rt = real_dtype(carry)
    Xc = X.astype(carry)

    lam1 = jnp.asarray(lam1, rt)
    lower = jnp.asarray(lower, rt)
    upper = jnp.asarray(upper, rt)
    c = (upper + lower) / 2
    e = (upper - lower) / 2
    sigma1 = e / (lam1 - c)

    # --- step 1: Y = (sigma1/e) (H - cI) X  (algorithm.inc:962-975) -------
    alpha1 = sigma1 / e
    Y = alpha1 * _hemm_shift(H, Xc, c, precision)
    Y = jnp.where(degrees[None, :] >= 1, Y, Xc)

    # --- steps t = 2..deg_max ---------------------------------------------
    def body(t, carry):
        Xp, Yc, sigma = carry
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        alpha = 2.0 * sigma_new / e
        beta = -sigma * sigma_new
        Z = alpha * _hemm_shift(H, Yc, c, precision) + beta * Xp
        upd = degrees[None, :] >= t
        Z = jnp.where(upd, Z, Yc)
        return (Yc, Z, sigma_new)

    deg_max = jnp.asarray(deg_max, jnp.int32)
    _, Y, _ = jax.lax.fori_loop(2, deg_max + 1, body, (Xc, Y, sigma1))
    # degree-0 (locked/padding) columns bit-exact: a reduced carry (the
    # f64→f32 mixed-precision rung) must not round-trip untouched
    # problem-dtype columns through the carry dtype
    return jnp.where(degrees[None, :] >= 1, Y.astype(out_dtype), X)


# -- deviation-form refinement filter (the DP-tolerance ladder) -------------
#
# For any per-column scalar shift λ_j the deviation w_t = p_t(Hs)v_j −
# p_t(λs_j)v_j obeys the SAME three-term recurrence as p_t plus an additive
# injection a_t·p_{t−1}(λs_j)·(Hs−λs_j)v_j — pure algebra, exact for any λ_j.
# Choosing λ_j = the column's Ritz value makes (H−λ_j)v_j the RR residual
# vector r_j, which the fused RR computes in the problem precision anyway.
# Every intermediate of the w recurrence is then O(|p|·‖e_j‖) (e_j = the
# current eigenvector error), so running it in f32/bf16 introduces
# noise PROPORTIONAL TO THE CURRENT ERROR instead of eps_low·‖H‖: the filter
# keeps contracting geometrically past the low-precision floor, all the way
# to the f64 RR/QR floor (~1e-14·‖H‖).  The reference instead switches the
# filter back to DP once resid < 1e-3 (Impl/chase_cpu/chase_cpu.hpp:384-447,
# DP default algorithm/configuration.hpp:53-62); here, with
# mixed_precision=True, the filter NEVER leaves the fast dtype — only the
# one H·V HEMM inside RR (shared with the residuals) runs in f64.


def refine_tables(ritzv_act, degrees_act, lam1, lower, upper, max_deg):
    """Host-side (numpy, f64) coefficient tables for the deviation filter.

    Mirrors the scaled σ-recurrence of :func:`chebyshev_filter` exactly, so
    the refined filter applies the IDENTICAL polynomial — only the arithmetic
    decomposition differs.

    Returns:
      alpha1_e: σ1/e — scale of the w_1 = (σ1/e)·r init.
      alphas:  (max_deg+1,) per-step 2σ_t/e HEMM coefficients (rows < 2 unused).
      betas:   (max_deg+1,) per-step −σ_{t−1}σ_t coefficients.
      inj:     (max_deg+1, w) per-step injection 2σ_t·p_{t−1}(λs_j)/e applied
               to the UNSCALED residual r_j = (H−λ_j)v_j.
      p_final: (w,) f64 — p_{deg_j}(λs_j), the exact scalar multiplying v_j
               in the combine y_j = p_final_j·v_j + w_j.
    """
    import numpy as np
    ritzv_act = np.asarray(ritzv_act, np.float64)
    degrees_act = np.asarray(degrees_act)
    w = ritzv_act.shape[0]
    c = (upper + lower) / 2.0
    e = (upper - lower) / 2.0
    sigma1 = e / (lam1 - c)
    lams = (ritzv_act - c) / e
    alphas = np.zeros(max_deg + 1, np.float64)
    betas = np.zeros(max_deg + 1, np.float64)
    inj = np.zeros((max_deg + 1, w), np.float64)
    p_prev = np.ones(w, np.float64)            # p_0(λs) = 1
    p_cur = sigma1 * lams                      # p_1(λs) = σ1·λs
    p_final = np.where(degrees_act >= 1, p_cur, 1.0)
    sigma = sigma1
    # p_t keeps growing to max_deg for EVERY column (only steps t ≤ deg_j
    # are ever applied); deep-outside λ at high t can overflow f64 to inf —
    # those rows are degree-masked in the recurrence, so silence the noise
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(2, max_deg + 1):
            sigma_new = 1.0 / (2.0 / sigma1 - sigma)
            alphas[t] = 2.0 * sigma_new / e
            betas[t] = -sigma * sigma_new
            inj[t] = (2.0 * sigma_new / e) * p_cur
            p_new = 2.0 * sigma_new * lams * p_cur \
                - sigma * sigma_new * p_prev
            p_prev, p_cur = p_cur, p_new
            sigma = sigma_new
            p_final = np.where(degrees_act >= t, p_new, p_final)
    return sigma1 / e, alphas, betas, inj, p_final


@partial(jax.jit, static_argnames=("precision",))
def chebyshev_filter_refine(H, V, R, degrees, alpha1_e, alphas, betas, inj,
                            p_final, cc, deg_max, *, precision="highest"):
    """Deviation-form Chebyshev filter: y_j = p_final_j·v_j + w_j with the
    w recurrence in the fast dtype of ``H`` (see module comment above).

    Args:
      H: (N, N) operator in the FAST dtype (f32/bf16 shadow of the problem).
      V: (N, w) current (post-RR) Ritz block in the PROBLEM dtype (f64/f32).
      R: (N, w) residual vectors H·v_j − λ_j·v_j, problem dtype.
      degrees: (w,) int32 per-column degrees; 0 = untouched.
      alpha1_e, alphas, betas, inj, p_final: host tables (refine_tables).
      cc: filter interval center (host float).
      deg_max: traced int scalar — loop trip count.

    Returns: (N, w) filtered block, problem dtype.
    """
    carry = filter_carry_dtype(H.dtype, V.dtype)
    rt = real_dtype(carry)
    Rc = R.astype(carry)
    cc = jnp.asarray(cc, rt)
    alphas = jnp.asarray(alphas, rt)
    betas = jnp.asarray(betas, rt)
    inj = jnp.asarray(inj, rt)

    W = jnp.asarray(alpha1_e, rt) * Rc                      # w_1 = (σ1/e)·r
    Wp = jnp.zeros_like(Rc)                                 # w_0 = 0

    def body(t, st):
        Wp, Wc = st
        Z = (alphas[t] * _hemm_shift(H, Wc, cc, precision)
             + betas[t] * Wp + inj[t][None, :] * Rc)
        Z = jnp.where(degrees[None, :] >= t, Z, Wc)
        return (Wc, Z)

    deg_max = jnp.asarray(deg_max, jnp.int32)
    _, W = jax.lax.fori_loop(2, deg_max + 1, body, (Wp, W))

    # combine in the PROBLEM precision: exact scalar scaling + small update
    rtv = real_dtype(V.dtype)
    Y = jnp.asarray(p_final, rtv)[None, :] * V + W.astype(V.dtype)
    return jnp.where(degrees[None, :] >= 1, Y, V)


# -- segmented-refine building blocks (window shrink for the DP ladder) ----

@partial(jax.jit, static_argnames=("precision",))
def refine_steps(H, Wp, Wc, Rc, degrees, alphas, betas, inj, cc, t0, t1, *,
                 precision="highest"):
    """Deviation-recurrence steps t in [t0, t1) on a (possibly shrunk)
    window — the refine analogue of :func:`filter_steps`.  All table
    arrays arrive pre-cast to the carry dtype and pre-sliced to the
    window's columns."""
    def body(t, st):
        Wp, Wc = st
        Z = (alphas[t] * _hemm_shift(H, Wc, cc, precision)
             + betas[t] * Wp + inj[t][None, :] * Rc)
        Z = jnp.where(degrees[None, :] >= t, Z, Wc)
        return (Wc, Z)

    return jax.lax.fori_loop(jnp.asarray(t0, jnp.int32),
                             jnp.asarray(t1, jnp.int32), body, (Wp, Wc))


@jax.jit
def refine_combine(V, W, p_final, degrees):
    """y_j = p_final_j·v_j + w_j in the problem precision (deg-0 columns
    untouched) — the refine filter's epilogue, split out so the segmented
    path can write retired buckets back early."""
    rtv = real_dtype(V.dtype)
    Y = p_final[None, :].astype(rtv) * V + W.astype(V.dtype)
    return jnp.where(degrees[None, :] >= 1, Y, V)


# -- dispatch-folded segment programs (per-dispatch-overhead reduction) ----
#
# The segmented window filter used to issue slice + carry-init + per-
# segment (steps, masked-writeback, update) + shrink slices as SEPARATE
# jitted programs — ~12 dispatches per iteration, each with its own
# dispatch overhead.  These fused variants do the
# window slice, the recurrence segment, the degree-masked write-back and
# the carry shrink inside ONE program each: ~2-4 dispatches per iteration,
# same bucketed program count (widths are static).


@partial(jax.jit, static_argnames=("w_pad", "precision"))
def filter_seg_init(H, V, start, deg_win, c, e, sigma1, *, w_pad,
                    precision="highest"):
    """Slice the window out of V and run recurrence step 1 — one program.
    Returns (X0, Xp, Yc, sigma) in the carry dtype."""
    carry = filter_carry_dtype(H.dtype, V.dtype)
    X0 = jax.lax.dynamic_slice(V, (jnp.int32(0), start),
                               (V.shape[0], w_pad))
    Xc = X0.astype(carry)
    rt = real_dtype(carry)
    alpha1 = jnp.asarray(sigma1 / e, rt)
    cc = jnp.asarray(c, rt)
    Y = alpha1 * _hemm_shift(H, Xc, cc, precision)
    Y = jnp.where(deg_win[None, :] >= 1, Y, Xc)
    return X0, Xc, Y, jnp.asarray(sigma1, rt)


@partial(jax.jit, static_argnames=("w_new", "precision"),
         donate_argnums=(1, 2, 3, 4))
def filter_seg_steps(H, V, X0, Xp, Yc, deg_win, sigma, sigma1, c, e, off,
                     start_new, t0, t1, *, w_new, precision="highest"):
    """One fused segment: shrink the carries by ``off`` columns (traced; 0
    = no shrink), run steps t in [t0, t1), write the masked window back
    into V.  Returns (V', X0', Xp', Yc', sigma) at the new static width.
    V and the carries are DONATED (callers rebind the results): without
    donation each segment double-buffers the f64 block + three carries —
    ~2.5 GB of dead transients at the N=30000 window."""
    if w_new != Xp.shape[1]:
        X0 = jax.lax.dynamic_slice(X0, (jnp.int32(0), off),
                                   (X0.shape[0], w_new))
        Xp = jax.lax.dynamic_slice(Xp, (jnp.int32(0), off),
                                   (Xp.shape[0], w_new))
        Yc = jax.lax.dynamic_slice(Yc, (jnp.int32(0), off),
                                   (Yc.shape[0], w_new))

    def body(t, carry):
        Xp, Yc, sigma = carry
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        alpha = 2.0 * sigma_new / e
        beta = -sigma * sigma_new
        Z = alpha * _hemm_shift(H, Yc, c, precision) + beta * Xp
        Z = jnp.where(deg_win[None, :] >= t, Z, Yc)
        return (Yc, Z, sigma_new)

    Xp, Yc, sigma = jax.lax.fori_loop(
        jnp.asarray(t0, jnp.int32), jnp.asarray(t1, jnp.int32),
        body, (Xp, Yc, sigma))
    # degree-0 (locked pad) columns bit-exact from the original slice
    Yw = jnp.where(deg_win[None, :] >= 1, Yc.astype(V.dtype), X0)
    V = jax.lax.dynamic_update_slice(V, Yw, (jnp.int32(0), start_new))
    return V, X0, Xp, Yc, sigma


@partial(jax.jit, static_argnames=("w_pad",))
def refine_seg_init(H, V, R, start, alpha1_e, *, w_pad):
    """Slice the V/R windows and seed w₁ = (σ1/e)·r — one program.
    ``H`` only supplies the carry dtype (its fast-rung storage)."""
    carry = filter_carry_dtype(H.dtype, V.dtype)
    rt = real_dtype(carry)
    X0 = jax.lax.dynamic_slice(V, (jnp.int32(0), start),
                               (V.shape[0], w_pad))
    Rc = jax.lax.dynamic_slice(R, (jnp.int32(0), start),
                               (R.shape[0], w_pad)).astype(carry)
    Wc = jnp.asarray(alpha1_e, rt) * Rc
    return X0, jnp.zeros_like(Rc), Wc, Rc


@partial(jax.jit, static_argnames=("w_new", "precision"),
         donate_argnums=(1, 2, 3, 4, 5))
def refine_seg_steps(H, V, X0, Wp, Wc, Rc, deg_win, alphas, betas, inj,
                     p_final, cc, off, start_new, t0, t1, *, w_new,
                     precision="highest"):
    """Fused refine segment: shrink carries, run deviation steps
    [t0, t1), combine y = p_final·v + w and write back — one program.
    Returns (V', X0', Wp', Wc', Rc')."""
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
        Z = (alphas[t] * _hemm_shift(H, Wc, cc, precision)
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


# -- segmented-filter building blocks (used by the perf-tuned solver path) --

@partial(jax.jit, static_argnames=("precision",))
def filter_carry_init(H, X, degrees, c, e, sigma1, *, precision="highest"):
    """First recurrence step; returns (X, Y, sigma) carry.

    X arrives already cast to the carry dtype (filter_carry_dtype);
    scalars follow the carry, not H's (possibly bf16) storage dtype."""
    alpha1 = jnp.asarray(sigma1 / e, real_dtype(X.dtype))
    c = jnp.asarray(c, real_dtype(X.dtype))
    Y = alpha1 * _hemm_shift(H, X, c, precision)
    Y = jnp.where(degrees[None, :] >= 1, Y, X)
    return X, Y, jnp.asarray(sigma1, real_dtype(X.dtype))


@partial(jax.jit, static_argnames=("precision",))
def filter_steps(H, Xp, Yc, degrees, sigma, sigma1, c, e, t0, t1, *,
                 precision="highest"):
    """Run recurrence steps t in [t0, t1) on a (possibly shrunk) window."""
    def body(t, carry):
        Xp, Yc, sigma = carry
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        alpha = 2.0 * sigma_new / e
        beta = -sigma * sigma_new
        Z = alpha * _hemm_shift(H, Yc, c, precision) + beta * Xp
        upd = degrees[None, :] >= t
        Z = jnp.where(upd, Z, Yc)
        return (Yc, Z, sigma_new)

    return jax.lax.fori_loop(jnp.asarray(t0, jnp.int32),
                             jnp.asarray(t1, jnp.int32),
                             body, (Xp, Yc, sigma))
