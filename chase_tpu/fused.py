"""Device-resident fused solver: the entire Hermitian solve as ONE XLA
program.

The reference (and our :mod:`chase_tpu.solver`) drives the iteration from
host — fine when dispatch is cheap, but the natural limit of the
reference's "batch per-iteration device→host transfers" concern (SURVEY §7
risk 4) is to keep *everything* resident: Lanczos, DoS bounds, the whole
degrees→filter→QR→RR→locking `while` loop, and the final sort run inside a
single `jax.jit` under `lax.while_loop`, with locking expressed as a
stable group-sort column permutation instead of host-side swaps.  One
dispatch per solve; scalars never leave the device.

Semantics deltas vs the host driver (all documented, none affecting
convergence guarantees):
  * locking reorders converged-first via a stable sort (reference: walk
    swaps — same set, slightly different tie order);
  * the DoS starting vectors are injected without the i·(nevex/idx)
    interspersing permutation (algorithm.inc:1202-1207);
  * QR always uses shifted CholQR (shift applied only when the condition
    estimate crosses the threshold) + an in-graph Householder rescue,
    instead of the 3-way host selection;
  * per-vector degrees drive a two-window filter over a degree-sorted
    VIEW of the block (the permutation is applied on filter entry and
    undone on exit, so the iteration's column order — and locking-v3's
    positional resid_last pairing — is untouched).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .ops.blocks import inverse_permutation
from .ops.rr import pin_value
from .types import real_dtype, is_double_base

__all__ = ["solve_fused"]


def _eigh_tridiag_batched(alphas, betas_off):
    """Batched dense eigh of the (m×m) Lanczos tridiagonals. alphas:(m,nv)."""
    m, nv = alphas.shape
    T = (jnp.zeros((nv, m, m), alphas.dtype)
         .at[:, jnp.arange(m), jnp.arange(m)].set(alphas.T))
    if m > 1:
        i = jnp.arange(m - 1)
        T = T.at[:, i, i + 1].set(betas_off.T)
        T = T.at[:, i + 1, i].set(betas_off.T)
    w, Q = jnp.linalg.eigh(T)
    return w, Q            # (nv, m), (nv, m, m)


def _dos_bounds(theta, tau, betas_last, nevex, N):
    """Gaussian-broadened DoS quantile on device (algorithm.inc:1096-1145)."""
    rt = theta.dtype
    nv, m = theta.shape
    n = nv * m
    tf = theta.reshape(-1)
    wf = tau.reshape(-1)
    order = jnp.argsort(tf)
    ts = tf[order]
    lam = ts[0]
    sigma = 0.25
    thresh = 2 * sigma * sigma / 10
    search = jnp.asarray(nevex / N, rt)
    x = ts[:, None] - tf[None, :]
    g = 0.5 * (1 + jax.scipy.special.erf(x / np.sqrt(2 * sigma * sigma)))
    contrib = jnp.where(x > thresh, 1.0, jnp.where(x < -thresh, 0.0, g))
    cdf = (contrib * wf[None, :]).sum(axis=1) / nv
    crossed = cdf > search
    has = crossed.any()
    i = jnp.argmax(crossed)
    prev = jnp.where(i > 0, cdf[jnp.maximum(i - 1, 0)], jnp.zeros((), rt))
    take_next = (jnp.abs(cdf[i] - search) < jnp.abs(prev - search)) \
        & (i + 1 < n)
    lowerb = jnp.where(take_next, ts[jnp.minimum(i + 1, n - 1)], ts[i])
    lowerb = jnp.where(has, lowerb, ts[-1])
    upperb = (jnp.maximum(jnp.abs(theta[:, 0]), jnp.abs(theta[:, -1]))
              + jnp.abs(betas_last)).max()
    return lam, lowerb, upperb


def _cheb_rho(t):
    z = t.astype(jnp.complex64 if t.dtype == jnp.float32 else jnp.complex128)
    s = jnp.sqrt(z * z - 1)
    return jnp.maximum(jnp.abs(z - s), jnp.abs(z + s)).real


def _tier_offsets(k: int, tiers: int):
    """Static phase-window tiers for the while-loop body.

    The in-graph analogue of the host driver's P12 window shrink
    (algorithm.inc:1712-1718 → solver._window_pad): shapes inside
    ``lax.while_loop`` are frozen, so instead of one full-width body the
    body branches (``lax.cond``) over a handful of STATIC right-aligned
    windows [off, k) and runs filter+QR+RR at that width once ``locked ≥
    off``.  Each tier compiles its own phase programs (≤4 branches);
    execution pays only the selected one, cutting the late-iteration
    filter/QR/RR width from k to k−off.  Offsets are sublane/lane aligned.
    """
    if tiers <= 1:
        return [0]
    fr = {2: (0.5,), 3: (0.5, 0.75)}.get(tiers, (0.25, 0.5, 0.75))
    align = 64 if k >= 512 else 8
    offs = [0]
    for f in fr:
        o = (int(k * f) // align) * align
        if o > offs[-1] and k - o >= align:
            offs.append(o)
    return offs


@partial(jax.jit,
         static_argnames=("nev", "nex", "deg0", "max_deg", "deg_extra",
                          "max_iter", "lanczos_iter", "num_lanczos",
                          "optimization", "precision", "cholqr_passes",
                          "inject_dos", "bf16_filter", "bf16_threshold",
                          "small_dense", "eigh_polish", "refine_filter",
                          "phase_tiers", "wide_rr", "wide_s", "wide_L"))
def solve_fused(H, V0, *, nev, nex, tol, deg0, max_deg, deg_extra=2,
                max_iter=25, lanczos_iter=25, num_lanczos=4,
                optimization=True, precision="highest", cholqr_passes=3,
                cond_shift_threshold=1e8, inject_dos=True,
                bf16_filter=False, bf16_threshold=1e-2,
                small_dense="device", probes=None, eigh_polish=2,
                refine_filter=False, phase_tiers=3,
                H_wide=None, wide_rr=False, wide_s=7, wide_L=8):
    """Fully device-resident Hermitian solve.

    Args:
      H: (N, N) Hermitian.  In ``wide_rr`` mode this is the f32 SHADOW
        (the problem precision comes from V0) — the graph then contains
        NO f64 dots, factorizations or eigensolves at all.
      V0: (N, nev+nex) starting block (random or warm start).
      refine_filter: DP-tolerance ladder in-graph — from iteration 1 the
        filter runs the deviation-form refinement recurrence in f32/c64
        (coefficient tables built in-graph by a fori_loop; the RR residual
        VECTORS ride in the loop state) so a 1e-10 serving solve keeps
        its filter FLOPs in f32 (ops/filter.chebyshev_filter_refine
        is the host-driver analogue; reference DP default:
        algorithm/configuration.hpp:53-62).
      H_wide: (slices, sa) — the int8 Ozaki slice stack of the REAL f64
        operator (DenseOperator.H_wide without the (s, L) tail) for
        ``wide_rr`` mode.
      wide_rr: run every full-precision contraction (initial QR, RR
        projection W=H·Q, Grams, rotations, the OA-polished projected
        eigensolve) on the exact-int8-slice GEMM (ops/wide) with f32
        factorizations + wide Newton–Schulz cleanup — a one-dispatch DP
        program with no f64 dot in the graph (opt-in, wide_f64='on').
        Implies the
        refine-ladder filter (there is no f64 H in the graph to filter
        with).
    Returns:
      dict of device arrays: V (N, k) converged-first sorted, ritzv (k,),
      resid (k,), locked, iterations, lowerb, upperb.
    """
    N = H.shape[0]
    k = nev + nex
    pdt = V0.dtype if wide_rr else H.dtype     # problem dtype
    rt = real_dtype(pdt)
    is_sp = not is_double_base(pdt)
    tol = jnp.asarray(tol, rt)
    cols = jnp.arange(k)
    big = jnp.asarray(np.finfo(np.dtype(rt)).max / 4, rt)
    # bf16 storage rung (P10 aggressive mode): real f32 problems only.
    use_bf16_rung = (bf16_filter and is_sp
                     and not jnp.issubdtype(pdt, jnp.complexfloating))
    H_bf = H.astype(jnp.bfloat16) if use_bf16_rung else None
    # DP refinement ladder: f32/c64 shadow of H for the deviation
    # recurrence (the P10 low rung the reference toggles inside Shift,
    # chase_cpu.hpp:384-447 — here it never hands back to f64)
    use_refine = (refine_filter or wide_rr) and not is_sp
    if use_refine:
        from .types import low_precision_dtype
        low_dt = low_precision_dtype(pdt)
        H_lo = H if wide_rr else H.astype(low_dt)
        low_rt = real_dtype(low_dt)

    if wide_rr:
        from .ops.wide import _wide_matmul_presliced, _wide_matmul_impl
        w_slices, w_sa = H_wide

        def fdot_H(B):
            """f64-accurate H @ B on the presliced int8 operator."""
            return _wide_matmul_presliced(w_slices, w_sa, B, s=wide_s,
                                          L=wide_L, cut=wide_L - 1)

        def fdot(Aa, Bb):
            """f64-accurate dynamic A @ B (both operands sliced in-graph;
            i8 params are contraction-independent within the exactness
            window, so one (s, L) serves N- and k-contractions)."""
            return _wide_matmul_impl(Aa, Bb, s=wide_s, L=wide_L,
                                     cut=wide_L - 1, scheme="i8")
    else:
        def fdot_H(B):
            return jnp.matmul(H, B, precision=precision)

        def fdot(Aa, Bb):
            return jnp.matmul(Aa, Bb, precision=precision)

    def _qr_pass(Q, use_shift):
        """One CholQR round (optionally diagonally shifted).  The Gram is
        column-equilibrated (factor D⁻¹GD⁻¹, D = √diag G, the scaling
        folded into the trsm — ops/qr.cholqr has the rationale): the
        refine ladder's output columns carry norms p(λ_j) spanning many
        decades, and without the equilibration that spread alone pushes
        the Gram past Cholesky range."""
        G = jnp.matmul(Q.conj().T, Q, precision=precision)
        d = jnp.sqrt(jnp.abs(jnp.diagonal(G).real)).astype(rt)
        d = jnp.where(d > 0, d, jnp.ones_like(d))
        G = G / (d[:, None] * d[None, :]).astype(G.dtype)
        nrmf = jnp.sum(jnp.abs(jnp.diagonal(G).real))
        coef = np.sqrt(N) if not is_sp else 10.0
        shift = jnp.where(use_shift,
                          coef * np.finfo(np.dtype(rt)).eps * nrmf,
                          jnp.zeros((), rt))
        G = G + shift.astype(G.dtype) * jnp.eye(G.shape[0], dtype=G.dtype)
        L = jnp.linalg.cholesky(G)
        p_ok = jnp.isfinite(L.real).all()
        L = jnp.where(p_ok, L, jnp.eye(G.shape[0], dtype=G.dtype))
        Q = jax.lax.linalg.triangular_solve(
            L, Q / d[None, :].astype(Q.dtype), left_side=False, lower=True,
            transpose_a=True, conjugate_a=True)
        return Q, p_ok

    def gram_qr(V, shift_on):
        """Static shifted-CholQR chain (cholqr_passes rounds, shift only on
        round 0 when shift_on) + in-graph Householder rescue.

        The pass count is static: selecting it in-graph with ``lax.cond``
        (the reference's cholQR1/2/shifted selection,
        chase_cpu.hpp:649-723) puts conditionals inside the solve
        while_loop, which serialize XLA's schedule, to save Gram+trsm
        rounds that are <1% of an iteration's FLOPs.  The host driver
        keeps the cond-driven selection in host control flow."""
        Q, ok = _qr_pass(V, shift_on)
        for _ in range(2, cholqr_passes + 1):
            Q, o2 = _qr_pass(Q, jnp.bool_(False))
            ok = ok & o2
        Q = jax.lax.cond(ok, lambda q: q,
                         lambda q: jnp.linalg.qr(q, mode="reduced")[0], Q)
        return Q

    def _qr_pass_wide(Q, use_shift):
        """One CholQR round with NO f64 dots or factorizations: the Gram
        on the wide int8 GEMM (f64-accurate), equilibrated, factored in
        f32 (native Cholesky), the explicit triangular inverse applied
        back through the wide GEMM.  A non-PD f32 Gram retries once with
        a large relative shift (repeat-shifted CholQR) instead of an
        in-graph f64 Householder."""
        G = fdot(Q.T, Q)
        d = jnp.sqrt(jnp.abs(jnp.diagonal(G)))
        d = jnp.where(d > 0, d, jnp.ones_like(d))
        G = G / (d[:, None] * d[None, :])
        nrmf = jnp.sum(jnp.abs(jnp.diagonal(G)))
        shift = jnp.where(use_shift,
                          np.sqrt(N) * np.finfo(np.dtype(rt)).eps * nrmf,
                          jnp.zeros((), rt))
        kk = G.shape[0]
        I32 = jnp.eye(kk, dtype=jnp.float32)
        G32 = (G + shift * jnp.eye(kk, dtype=G.dtype)).astype(jnp.float32)
        L32 = jnp.linalg.cholesky(G32)
        p_ok = jnp.isfinite(L32).all()
        L32b = jnp.linalg.cholesky(G32 + jnp.asarray(1e-4, jnp.float32)
                                   * I32)
        ok_b = jnp.isfinite(L32b).all()
        L32 = jnp.where(p_ok, L32, jnp.where(ok_b, L32b, I32))
        Linv = jax.lax.linalg.triangular_solve(
            L32, I32, left_side=True, lower=True)
        M = Linv.T.astype(rt) / d[:, None]
        return fdot(Q, M), p_ok | ok_b

    def gram_qr_wide(V, shift_on):
        """cholqr_passes wide rounds + one wide Newton–Schulz cleanup
        (Q ← Q(I − E/2), E = QᵀQ − I): the f32 factorizations floor the
        per-pass orthogonality at ~√k·eps_f32; the NS step squares that
        to the f64 floor using only wide (int8) matmuls."""
        Q, _ = _qr_pass_wide(V, shift_on)
        for _ in range(2, cholqr_passes + 1):
            Q, _ = _qr_pass_wide(Q, jnp.bool_(False))
        E = fdot(Q.T, Q) - jnp.eye(Q.shape[1], dtype=rt)
        return Q - fdot(Q, 0.5 * E)

    if wide_rr:
        gram_qr_fn, qr_pass_fn = gram_qr_wide, _qr_pass_wide
    else:
        gram_qr_fn, qr_pass_fn = gram_qr, _qr_pass

    # ---- init: orthonormalize V0 -----------------------------------------
    V = gram_qr_fn(V0.astype(pdt), jnp.bool_(False))

    # ---- Lanczos + DoS (device) -------------------------------------------
    m = max(2, min(k, N // 2, lanczos_iter) - (min(k, N // 2, lanczos_iter) % 2))
    # probe count can never exceed the block width (nev+nex < num_lanczos
    # would slice fewer columns than the scan carry expects)
    nv = probes.shape[1] if probes is not None else min(num_lanczos, k)

    # Spectral-bound estimation precision: f32 in wide mode (bounds need
    # ~1e-7 fidelity; keeps the m×m tridiagonal eigh out of f64 — the
    # wide_rr graph must carry NO f64 eigensolves at all)
    lz_rt = jnp.float32 if wide_rr else rt

    def lz_step(carry, _):
        v0, v1, beta_prev = carry
        w = jnp.matmul(H, v1, precision=precision)
        alpha = jnp.sum(v1.conj() * w, axis=0).real.astype(lz_rt)
        w = w - alpha[None, :].astype(w.dtype) * v1 \
              - beta_prev[None, :].astype(w.dtype) * v0
        beta = jnp.linalg.norm(w, axis=0).real.astype(lz_rt)
        safe = jnp.where(beta > 0, beta, jnp.ones((), lz_rt))
        return (v1, w / safe[None, :].astype(w.dtype), beta), \
            (alpha, beta, v1[:, -1])

    # Warm starts pass fresh random probes: a Krylov space seeded with the
    # previous problem's converged eigenvectors underestimates the drifted
    # lambda_max and the filter then amplifies the unwanted end.
    probes = (V[:, :nv] if probes is None else probes).astype(H.dtype)
    nrm = jnp.linalg.norm(probes, axis=0).real
    probes = probes / nrm[None, :].astype(probes.dtype)
    _, (alphas, betas, basis) = jax.lax.scan(
        lz_step, (jnp.zeros_like(probes), probes, jnp.zeros((nv,), lz_rt)),
        None, length=m)

    theta, tvecs = _eigh_tridiag_batched(alphas, betas[:-1])
    tau = jnp.abs(tvecs[:, 0, :]) ** 2
    lam, lowerb0, upperb = _dos_bounds(theta, tau, betas[-1], k, N)

    # DoS starting vectors from the last probe (no interspersing).
    # Skipped for warm starts (inject_dos=False): clobbering the caller's
    # converged eigenvector columns would defeat the warm subspace
    # (host driver analogue: mode='A' runs the bounds-only Lanczos).
    theta_last = theta[-1]
    if inject_dos:
        exceeds = theta_last > lowerb0
        idx = jnp.where(exceeds.any(),
                        jnp.maximum(jnp.argmax(exceeds) - 1, 0), 0)
        idx = jnp.minimum(idx, k - 1)
        dmask = jnp.arange(m) < idx
        Vd = jnp.matmul(basis.T, (tvecs[-1] * dmask[None, :]).astype(H.dtype),
                        precision=precision)
        head = jnp.where(dmask[None, :], Vd, V[:, :m])
        V = V.at[:, :m].set(head)
        tl_pad = theta_last[jnp.minimum(cols, m - 1)]
        ritzv = jnp.where(cols < idx, tl_pad, lam).astype(rt)
        ritzv = ritzv.at[k - 1].set(lowerb0.astype(rt))
    else:
        ritzv = jnp.full((k,), lam, rt).at[k - 1].set(lowerb0.astype(rt))

    lowerb = jnp.max(ritzv)
    resid = jnp.full((k,), big, rt)
    resid_last = jnp.full((k,), big, rt)
    degrees = jnp.full((k,), min(deg0 + deg0 % 2, max_deg), jnp.int32)

    # ---- main while loop ---------------------------------------------------
    # In-graph observability (single dispatch can't host-log per iteration):
    # filtered-vector count for the analytic FLOP model (performance.hpp),
    # per-iteration block sizes, and the residual history rows the host
    # driver writes under CHASE_SAVE_RESIDUALS (locked slots as -1.0).
    def cond_fn(st):
        (V, Rv, ritzv, resid, resid_last, degrees, locked, it, lowerb,
         filtered, blk_hist, r_hist, e_hist) = st
        return (k - locked > nex) & (it < max_iter)

    def body_fn(st):
        (V, Rv, ritzv, resid, resid_last, degrees, locked, it, lowerb,
         filtered, blk_hist, r_hist, e_hist) = st
        active = cols >= locked

        # lowerb refresh + clamp
        all_small = jnp.where(active, resid, jnp.zeros((), rt)).max() <= 0.5
        lowerb = jnp.where(all_small, ritzv[k - 1], lowerb)
        lowerb = jnp.minimum(lowerb, upperb)
        resid_last = jnp.where(active, jnp.minimum(resid_last, resid),
                               resid_last)

        # -- degrees (vectorized calc_degrees, no sort) --
        def new_degrees(_):
            c = (upperb + lowerb) / 2
            e = (upperb - lowerb) / 2
            t = (ritzv - c) / e
            rho = _cheb_rho(t)
            with jax.numpy_dtype_promotion("standard"):
                val = jnp.abs(jnp.log(resid / tol) / jnp.log(rho))
            # cap in float BEFORE the int cast: finite val > 2^31 (rho ~ 1)
            # would overflow astype(int32) to INT_MIN and silently skip the
            # column in the filter (degree mask never fires on negatives)
            val = jnp.minimum(val, float(max_deg))
            d = jnp.where(jnp.isfinite(val),
                          jnp.ceil(val).astype(jnp.int32), max_deg)
            if is_sp:
                d = jnp.maximum(d, 8)
            d = jnp.minimum(d + deg_extra, max_deg)
            # nex tail copies the last examined column's degree
            d = jnp.where(cols >= k - nex, d[k - nex - 1], d)
            d = d + d % 2
            return jnp.where(active, d, 0).astype(jnp.int32)

        degrees = jax.lax.cond(
            jnp.logical_and(optimization, it > 0), new_degrees,
            lambda _: jnp.where(active, degrees, 0).astype(jnp.int32), None)
        filtered = filtered + jnp.sum(degrees)
        blk_hist = blk_hist.at[it].set(k - locked)

        # -- filter + QR + RR, tier-windowed (static widths, lax.cond) --
        c = (upperb + lowerb) / 2
        e = (upperb - lowerb) / 2
        sigma1 = e / (lam - c)
        dmax = jnp.max(degrees)

        # QR shift decision (scalar; shared by every tier)
        t1 = (ritzv[0] - c) / e
        tk = (ritzv[locked] - c) / e
        rho1, rhok = _cheb_rho(t1), _cheb_rho(tk)
        dmin = jnp.where(active, degrees, max_deg + 2).min()
        logcond = dmin * jnp.log(rhok) + (dmax - dmin) * jnp.log(rho1)
        shift_on = logcond > np.log(cond_shift_threshold)

        if use_bf16_rung:
            min_wanted = jnp.where(active & (cols < nev), resid, big).min()
            # spectral-radius magnitude (signed upperb would never
            # disengage)
            spec_scale = jnp.maximum(jnp.abs(lam), jnp.abs(upperb))
            low_phase = min_wanted > jnp.asarray(bf16_threshold, rt) \
                * spec_scale

        def make_tier(off):
            """Filter → QR → RR at the static window [off, k) — one
            lax.cond branch, selected when ``locked ≥ off``.  off=0 is
            the classic full-width body; larger tiers BCGS-project the
            window against the locked left block (the in-graph analogue
            of ops/qr.orthonormalize_window) and run every phase at
            width k−off."""
            w = k - off
            colsw = jnp.arange(off, k)
            khalf = max(1, w // 2)

            def tier(args):
                V, Rv = args
                Vw = jax.lax.slice_in_dim(V, off, k, axis=1)
                deg_w = jax.lax.slice_in_dim(degrees, off, k)
                ritz_w = jax.lax.slice_in_dim(ritzv, off, k)
                active_w = colsw >= locked
                lw = locked - off       # locked columns inside the window

                # Sort window columns ascending by degree for the
                # two-window filter (stable; locked columns carry degree 0
                # and stay in front — the reference's calc_degrees sort,
                # algorithm.inc:136-193).  The permutation is UNDONE on
                # filter exit: locking-v3's stagnation early-lock compares
                # resid/resid_last positionally across iterations.
                dperm = jnp.argsort(deg_w, stable=True)
                dperm_inv = inverse_permutation(dperm)
                deg_sorted = deg_w[dperm]

                def run_filter(matvec, Vin_unsorted):
                    """Two-window degree-retiring recurrence (P12): the
                    window is permuted ascending by degree, so its left
                    half is final after its max degree — steps beyond it
                    run on the right static half only."""
                    Vin = jnp.take(Vin_unsorted, dperm, axis=1)

                    def fbody(degs):
                        def body(t, carry):
                            Xp, Yc, sigma = carry
                            sigma_new = 1.0 / (2.0 / sigma1 - sigma)
                            Z = (2.0 * sigma_new / e) * (matvec(Yc) - c * Yc) \
                                - (sigma * sigma_new) * Xp
                            Z = jnp.where(degs[None, :] >= t, Z, Yc)
                            return (Yc, Z, sigma_new)
                        return body

                    Y = (sigma1 / e) * (matvec(Vin) - c * Vin)
                    Y = jnp.where(deg_sorted[None, :] >= 1, Y, Vin)
                    dmid = jnp.clip(deg_sorted[khalf - 1], 1, dmax)
                    Xp, Yc, sig = jax.lax.fori_loop(
                        2, dmid + 1, fbody(deg_sorted), (Vin, Y, sigma1))
                    Xp_r = jax.lax.slice_in_dim(Xp, khalf, w, axis=1)
                    Yc_r = jax.lax.slice_in_dim(Yc, khalf, w, axis=1)
                    _, Yc_r, _ = jax.lax.fori_loop(
                        dmid + 1, dmax + 1, fbody(deg_sorted[khalf:]),
                        (Xp_r, Yc_r, sig))
                    Yfull = jnp.concatenate(
                        [jax.lax.slice_in_dim(Yc, 0, khalf, axis=1), Yc_r],
                        axis=1)
                    return jnp.take(Yfull, dperm_inv, axis=1)

                def mv_full(X):
                    return jnp.matmul(H, X, precision=precision)

                if use_bf16_rung:
                    # far-from-converged iterations: bf16 matmul inputs,
                    # f32 accumulation, carry stays f32 (mirrors
                    # ops/filter._hemm_shift)
                    def mv_low(X):
                        return jnp.matmul(H_bf, X.astype(jnp.bfloat16),
                                          precision="default",
                                          preferred_element_type=H.dtype)

                    Vf = jax.lax.cond(
                        low_phase,
                        lambda Vin: run_filter(mv_low, Vin),
                        lambda Vin: run_filter(mv_full, Vin), Vw)
                elif use_refine:
                    # -- DP refinement ladder (in-graph
                    # chebyshev_filter_refine on the window) --
                    # Coefficient tables in f64 (exact polynomial
                    # bookkeeping, cheap elementwise work); the deviation
                    # recurrence in f32, seeded by last
                    # iteration's f64 residual vectors.
                    def run_refine(args2):
                        Vin, Rin = args2
                        lams = (ritz_w - c) / e              # (w,) f64

                        def tbody(t, ts):
                            sig, p_prev, p_cur, al, be, inj, p_fin = ts
                            sig_new = 1.0 / (2.0 / sigma1 - sig)
                            al = al.at[t].set(2.0 * sig_new / e)
                            be = be.at[t].set(-sig * sig_new)
                            inj = inj.at[t].set((2.0 * sig_new / e) * p_cur)
                            p_new = (2.0 * sig_new * lams * p_cur
                                     - sig * sig_new * p_prev)
                            p_fin = jnp.where(deg_w >= t, p_new, p_fin)
                            return (sig_new, p_cur, p_new, al, be, inj,
                                    p_fin)

                        p1 = sigma1 * lams
                        p_fin0 = jnp.where(deg_w >= 1, p1,
                                           jnp.ones_like(lams))
                        D = max_deg
                        _, _, _, al, be, inj, p_fin = jax.lax.fori_loop(
                            2, D + 1, tbody,
                            (sigma1, jnp.ones_like(lams), p1,
                             jnp.zeros((D + 1,), rt),
                             jnp.zeros((D + 1,), rt),
                             jnp.zeros((D + 1, w), rt), p_fin0))

                        Rc = Rin.astype(low_dt)
                        cl = c.astype(low_rt)
                        all_ = al.astype(low_rt)
                        bel = be.astype(low_rt)
                        injl = inj.astype(low_rt)
                        Wd = (sigma1 / e).astype(low_rt) * Rc

                        def rbody(t, stw):
                            Wp, Wc = stw
                            Zc = (all_[t] * (jnp.matmul(H_lo, Wc,
                                                        precision=precision)
                                             - cl * Wc)
                                  + bel[t] * Wp + injl[t][None, :] * Rc)
                            Zc = jnp.where(deg_w[None, :] >= t, Zc, Wc)
                            return (Wc, Zc)

                        _, Wd = jax.lax.fori_loop(
                            2, dmax + 1, rbody, (jnp.zeros_like(Rc), Wd))
                        Y = p_fin[None, :].astype(pdt) * Vin \
                            + Wd.astype(pdt)
                        return jnp.where(deg_w[None, :] >= 1, Y, Vin)

                    def run_low0(args2):
                        # iteration 0 (no residual vectors yet): plain
                        # recurrence with the f32 shadow — the classic
                        # DP→SP low phase
                        Vin, _ = args2
                        return run_filter(
                            lambda X: jnp.matmul(
                                H_lo, X.astype(low_dt), precision=precision,
                                preferred_element_type=low_dt
                                if wide_rr else pdt),
                            Vin)

                    Rw_in = jax.lax.slice_in_dim(Rv, off, k, axis=1)
                    Vf = jax.lax.cond(it > 0, run_refine, run_low0,
                                      (Vw, Rw_in))
                else:
                    Vf = run_filter(mv_full, Vw)

                # -- QR on the window --
                if off:
                    # BCGS projection against the locked left block (all
                    # columns [0, off) are locked in this tier), then the
                    # CholQR chain, then BCGS2 re-project + CholQR1 — the
                    # in-graph orthonormalize_window sweep.
                    Lk = jax.lax.slice_in_dim(V, 0, off, axis=1)
                    Cp = fdot(Lk.conj().T, Vf)
                    Vf = Vf - fdot(Lk, Cp)
                Q = gram_qr_fn(Vf, shift_on)
                if off:
                    Cp = fdot(Lk.conj().T, Q)
                    Q = Q - fdot(Lk, Cp)
                    Q, _ = qr_pass_fn(Q, jnp.bool_(False))
                Vw2 = jnp.where(active_w[None, :], Q, Vw)

                # -- RR + residuals (masked window width) --
                Qm = jnp.where(active_w[None, :], Vw2,
                               jnp.zeros((), V.dtype))
                if not is_sp:
                    # renormalize (64-bit only): upstream QR can leave
                    # eps_f32-level column-norm deficits, biasing Ritz
                    # values by λ·η.  SP skips it —
                    # the f32 norm reduction's own √N·eps rounding perturbs
                    # columns above the f32 floor (ops/rr._rr_project).
                    qn = jnp.linalg.norm(Qm, axis=0).real.astype(rt)
                    Qm = Qm / jnp.where(qn > 0, qn, jnp.ones((), rt))[
                        None, :].astype(Qm.dtype)
                W = fdot_H(Qm)
                A = fdot(Qm.conj().T, W)
                pad = pin_value(A, rt)
                A = A + jnp.diag(jnp.where(active_w, jnp.zeros((), rt),
                                           pad)).astype(A.dtype)
                if wide_rr:
                    # f32 eigh + OA polish on wide matmuls: the projected
                    # eigensolve with no f64 eigh in the graph
                    from .ops.rr import eigh_polished_wide
                    w_eig, Z = eigh_polished_wide(
                        A, passes=max(eigh_polish, 3), pin_cut=pad / 2)
                elif small_dense == "host":
                    # host LAPACK f64 eigh via pure_callback
                    def _host_eigh_cb(a):
                        from .ops.rr import host_eigh_f64
                        return host_eigh_f64(a, rt)

                    w_eig, Z = jax.pure_callback(
                        _host_eigh_cb,
                        (jax.ShapeDtypeStruct((w,), rt),
                         jax.ShapeDtypeStruct((w, w), A.dtype)),
                        A, vmap_method="sequential")
                else:
                    # device eigh (+ optional Ogita-Aishima polish passes)
                    from .ops.rr import eigh_polished
                    w_eig, Z = eigh_polished(A, passes=eigh_polish,
                                             precision=precision,
                                             pin_cut=pad / 2)
                w_eig = w_eig.real.astype(rt)
                Vrot = fdot(Qm, Z)
                Wrot = fdot(W, Z)
                R = Wrot - Vrot * w_eig[None, :].astype(V.dtype)
                r_new = jnp.linalg.norm(R, axis=0).real.astype(rt)
                Vrot = jnp.roll(Vrot, lw, axis=1)
                w_eig = jnp.roll(w_eig, lw)
                r_new = jnp.roll(r_new, lw)
                Vw3 = jnp.where(active_w[None, :], Vrot, Vw2)
                V2 = V.at[:, off:].set(Vw3)
                ritz2 = ritzv.at[off:].set(
                    jnp.where(active_w, w_eig, ritz_w))
                resid2 = resid.at[off:].set(
                    jnp.where(active_w, r_new,
                              jax.lax.slice_in_dim(resid, off, k)))
                if use_refine:
                    # residual VECTORS feed the next refine injection
                    Rr = jnp.roll(R, lw, axis=1)
                    Rv2 = Rv.at[:, off:].set(
                        jnp.where(active_w[None, :], Rr,
                                  jax.lax.slice_in_dim(Rv, off, k, axis=1)))
                else:
                    Rv2 = Rv
                return V2, Rv2, ritz2, resid2

            return tier

        tier_fns = [make_tier(o) for o in _tier_offsets(k, phase_tiers)]
        tier_offs = _tier_offsets(k, phase_tiers)

        def _select(i, args):
            if i == len(tier_fns) - 1:
                return tier_fns[i](args)
            return jax.lax.cond(locked >= tier_offs[i + 1],
                                lambda a: _select(i + 1, a),
                                tier_fns[i], args)

        V, Rv, ritzv, resid = _select(0, (V, Rv))
        r_hist = r_hist.at[it].set(
            jnp.where(active, resid, jnp.asarray(-1.0, rt)))

        # -- locking: stable converged-first group sort --
        examined = active & (cols < k - nex)
        stag = (resid >= resid_last) & (resid < 100.0 * tol)
        conv = examined & ((resid <= tol) | stag)
        # early-locked (stagnation) residuals, -1 elsewhere — the perf
        # table's early-lock statistics (performance.hpp:406-448)
        e_row = jnp.where(examined & stag & (resid > tol), resid,
                          jnp.asarray(-1.0, rt))
        e_hist = e_hist.at[it].set(e_row)
        group = jnp.where(cols < locked, 0, jnp.where(conv, 1, 2))
        perm = jnp.argsort(group, stable=True)
        V = jnp.take(V, perm, axis=1)
        if use_refine:
            Rv = jnp.take(Rv, perm, axis=1)
        ritzv = ritzv[perm]
        resid = resid[perm]
        resid_last = resid_last[perm]
        degrees = degrees[perm]
        locked = locked + jnp.sum(conv).astype(locked.dtype)

        return (V, Rv, ritzv, resid, resid_last, degrees, locked, it + 1,
                lowerb, filtered, blk_hist, r_hist, e_hist)

    # residual-vector carry: a 1-column zero placeholder when the refine
    # ladder is off (keeps one state pytree structure)
    Rv0 = jnp.zeros_like(V) if use_refine \
        else jnp.zeros((1, 1), V.dtype)
    state = (V, Rv0, ritzv, resid, resid_last, degrees,
             jnp.int32(0), jnp.int32(0), lowerb.astype(rt),
             jnp.int64(0) if jax.config.jax_enable_x64 else jnp.int32(0),
             jnp.zeros((max_iter,), jnp.int32),
             jnp.full((max_iter, k), -1.0, rt),
             jnp.full((max_iter, k), -1.0, rt))
    (V, Rv, ritzv, resid, resid_last, degrees, locked, it, lowerb,
     filtered, blk_hist, r_hist, e_hist) = \
        jax.lax.while_loop(cond_fn, body_fn, state)

    # ---- final sort of the first nev by Ritz value -------------------------
    order = jnp.argsort(ritzv[:nev], stable=True)
    order_full = jnp.concatenate([order, jnp.arange(nev, k)])
    V = jnp.take(V, order_full, axis=1)
    ritzv = ritzv[order_full]
    resid = resid[order_full]

    return {"V": V, "ritzv": ritzv, "resid": resid, "locked": locked,
            "iterations": it, "lowerb": lowerb, "upperb": upperb,
            "filtered_vecs": filtered, "block_history": blk_hist,
            "resid_history": r_hist, "early_history": e_hist}
