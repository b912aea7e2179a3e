"""Device-resident fused pseudo-Hermitian (BSE) solver: one XLA program.

Counterpart of :mod:`chase_tpu.fused` for ``solve_pseudo``
(algorithm.inc:1834-2220): S-metric Lanczos, H² DoS bounds, and the whole
filter_H2 → K-conjugation → S-QR → pencil-RR → locking-v3 loop inside a
single `lax.while_loop`.  Exploits the symmetric-locking layout
[L | positives | mirrors | R]: the first half (k = nev+nex columns) holds
exactly the locked-left + positive-candidate columns, so the H² filter runs
at *half* width statically; mirrors are regenerated by a traced-index
K-conjugation gather.

Documented deltas vs the host driver (same spirit as fused.py): locking
reorders via stable group-sort; DoS vectors injected without interspersing;
QR is shifted-CholQR with in-graph Householder rescue; the filter runs on
a degree-sorted two-window VIEW that is undone immediately after (P12
retirement with the tail steps on the right static half only) — locking-v3's
stagnation early-lock compares residuals POSITIONALLY against the previous
iteration, so the block itself is never left in degree order (an in-place
sort measurably stalled the solver: 25-iteration stalls where the unsorted
filter locks in 6).  Cluster-aware degree bonuses are fully vectorized.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .ops.blocks import inverse_permutation
from .types import real_dtype, is_double_base
from .ops.pseudo import apply_s

__all__ = ["solve_pseudo_fused"]


def _eigh_tridiag_batched(alphas, betas_off):
    m, nv = alphas.shape
    T = (jnp.zeros((nv, m, m), alphas.dtype)
         .at[:, jnp.arange(m), jnp.arange(m)].set(alphas.T))
    if m > 1:
        i = jnp.arange(m - 1)
        T = T.at[:, i, i + 1].set(betas_off.T)
        T = T.at[:, i + 1, i].set(betas_off.T)
    return jnp.linalg.eigh(T)


def _cheb_rho(t):
    z = t.astype(jnp.complex64 if t.dtype == jnp.float32 else jnp.complex128)
    s = jnp.sqrt(z * z - 1)
    return jnp.maximum(jnp.abs(z - s), jnp.abs(z + s)).real


@partial(jax.jit,
         static_argnames=("nev", "nex", "deg0", "max_deg", "deg_extra",
                          "max_iter", "lanczos_iter", "num_lanczos",
                          "optimization", "cluster_aware", "precision",
                          "cholqr_passes", "small_dense", "inject_dos",
                          "eigh_polish", "bf16_filter", "bf16_threshold",
                          "refine_filter"))
def solve_pseudo_fused(H, V0, *, nev, nex, tol, deg0, max_deg, deg_extra=2,
                       max_iter=25, lanczos_iter=25, num_lanczos=4,
                       optimization=True, cluster_aware=True,
                       precision="highest", cholqr_passes=3,
                       cond_shift_threshold=1e8, small_dense="device",
                       inject_dos=True, probes=None, eigh_polish=0,
                       bf16_filter=False, bf16_threshold=1e-2,
                       refine_filter=False):
    """Fully device-resident BSE solve.

    Args:
      H: (N, N) pseudo-Hermitian (BSE-structured), N even.
      V0: (N, 2·(nev+nex)) starting block (lower rows pre-scaled by caller
          or random).
      bf16_filter: f32 problems — far-from-converged iterations run the H²
        recurrence with bf16 matmul inputs + f32 accumulation (the
        storage rung, mirrors fused.py / ops/pseudo._h2_shift).
      refine_filter: the BSE DP ladder in-graph — from iteration 1 the H²
        filter runs the deviation-form refinement recurrence in f32 seeded
        by the f64 H²-residuals r2 = (H+θ)·r (the pencil-RR residual
        VECTORS ride in the loop state), so a 1e-10 BSE serving solve
        keeps its filter FLOPs in f32
        (ops/pseudo.chebyshev_filter_refine_h2 is the host analogue).
    Returns dict: V (N, 2k), ritzv (2k,), resid (2k,), locked, iterations.
    """
    N = H.shape[0]
    k = nev + nex
    K2 = 2 * k
    rt = real_dtype(H.dtype)
    is_sp = not is_double_base(H.dtype)
    tol = jnp.asarray(tol, rt)
    cols2 = jnp.arange(K2)
    colsk = jnp.arange(k)
    big = jnp.asarray(np.finfo(np.dtype(rt)).max / 4, rt)
    n2 = N // 2
    # precision rungs (P10 on the fused BSE path, parity with fused.py)
    use_bf16_rung = (bf16_filter and is_sp
                     and not jnp.issubdtype(H.dtype, jnp.complexfloating))
    H_bf = H.astype(jnp.bfloat16) if use_bf16_rung else None
    use_refine = refine_filter and not is_sp
    if use_refine:
        from .types import low_precision_dtype
        low_dt = low_precision_dtype(H.dtype)
        H_lo = H.astype(low_dt)
        low_rt = real_dtype(low_dt)

    # ---------------- shared building blocks --------------------------------

    def gram_qr(V, shift_on):
        ok = jnp.bool_(True)
        Q = V
        w = V.shape[1]
        for p in range(cholqr_passes):
            G = jnp.matmul(Q.conj().T, Q, precision=precision)
            if p == 0:
                nrmf = jnp.sum(jnp.abs(jnp.diagonal(G).real))
                coef = np.sqrt(N) if not is_sp else 10.0
                shift = jnp.where(shift_on,
                                  coef * np.finfo(np.dtype(rt)).eps * nrmf,
                                  jnp.zeros((), rt))
                G = G + shift.astype(G.dtype) * jnp.eye(w, dtype=G.dtype)
            L = jnp.linalg.cholesky(G)
            p_ok = jnp.isfinite(L.real).all()
            ok = ok & p_ok
            L = jnp.where(p_ok, L, jnp.eye(w, dtype=G.dtype))
            Q = jax.lax.linalg.triangular_solve(
                L, Q, left_side=False, lower=True, transpose_a=True,
                conjugate_a=True)
        return jax.lax.cond(ok, lambda q: q,
                            lambda q: jnp.linalg.qr(q, mode="reduced")[0], Q)

    def k_conj(V, locked, count):
        """Mirror cols [locked, locked+count) → [K2-locked-count, K2-locked)."""
        shiftc = K2 - 2 * locked - count
        src_idx = jnp.where(
            (cols2 >= K2 - locked - count) & (cols2 < K2 - locked),
            cols2 - shiftc, cols2)
        src = jnp.take(V, src_idx, axis=1)
        Ks = jnp.concatenate([src[n2:], src[:n2]], axis=0).conj()
        wmask = (cols2 >= K2 - locked - count) & (cols2 < K2 - locked)
        return jnp.where(wmask[None, :], Ks, V)

    def pseudo_qr(V, locked, shift_on):
        """[L|act|R] → [L|R|act], S-flip locked, CholQR, restore, undo."""
        # position -> source column
        in_L = cols2 < locked
        in_R = (cols2 >= locked) & (cols2 < 2 * locked)
        perm_to = jnp.where(in_L, cols2,
                            jnp.where(in_R, cols2 + (K2 - 2 * locked),
                                      cols2 - locked))
        inv = inverse_permutation(perm_to)
        Vp = jnp.take(V, perm_to, axis=1)
        rows_low = (jnp.arange(N) >= n2)[:, None]
        flip = rows_low & (cols2 < 2 * locked)[None, :]
        Vf = jnp.where(flip, -Vp, Vp)
        Q = gram_qr(Vf, shift_on)
        Q = jnp.where((cols2 < 2 * locked)[None, :], Vp, Q)
        return jnp.take(Q, inv, axis=1)

    def pencil_rr(V, locked):
        """Masked full-width pseudo Rayleigh–Ritz + residuals (see
        ops/pseudo.rayleigh_ritz_residuals_pseudo for the math)."""
        active = (cols2 >= locked) & (cols2 < K2 - locked)
        u = k - locked
        Q = jnp.where(active[None, :], V, jnp.zeros((), V.dtype))
        W = jnp.matmul(H, Q, precision=precision)
        T = apply_s(W)
        A = jnp.matmul(Q.conj().T, T, precision=precision)
        pad = jnp.where(active, jnp.zeros((), rt), jnp.ones((), rt))
        A = A + jnp.diag(pad).astype(A.dtype)
        L = jnp.linalg.cholesky(A)
        okc = jnp.isfinite(L.real).all()
        L = jnp.where(okc, L, jnp.eye(K2, dtype=A.dtype))
        B = jnp.matmul(Q.conj().T, apply_s(Q), precision=precision)
        B = B - jnp.diag(pad).astype(B.dtype)
        if small_dense == "host":
            # host LAPACK f64 pencil factorization via pure_callback (see
            # the ops/pseudo host path for the math)
            def _pencil_cb(a, b):
                from .ops.pseudo import host_pencil_factor
                th, Xh, _ok = host_pencil_factor(a, b, rt)
                return th, Xh

            theta, X = jax.pure_callback(
                _pencil_cb,
                (jax.ShapeDtypeStruct((K2,), rt),
                 jax.ShapeDtypeStruct((K2, K2), A.dtype)),
                A, B, vmap_method="sequential")
        else:
            C = jax.lax.linalg.triangular_solve(L, B, left_side=True,
                                                lower=True)
            C = jax.lax.linalg.triangular_solve(L, C, left_side=False,
                                                lower=True, transpose_a=True,
                                                conjugate_a=True)
            M = -(C + C.conj().T) / 2
            # The Ogita-Aishima polish buys no iterations at serving
            # tolerances here (the pseudo path's accuracy ceiling is the
            # S-metric pencil, not the eigh vector floor) — default OFF
            # for SP, opt in via config.eigh_polish.
            from .ops.rr import eigh_polished
            w_eig, Z = eigh_polished(M, passes=eigh_polish,
                                     precision=precision)
            w_eig = w_eig.real.astype(rt)
            theta = -1.0 / jnp.where(jnp.abs(w_eig) > 0, w_eig,
                                     jnp.ones((), rt))
            X = jax.lax.linalg.triangular_solve(L, Z, left_side=True,
                                                lower=True, transpose_a=True,
                                                conjugate_a=True)
            nrm = jnp.linalg.norm(X, axis=0).real.astype(rt)
            X = X / jnp.where(nrm > 0, nrm,
                              jnp.ones((), rt))[None, :].astype(X.dtype)
        Vrot = jnp.matmul(Q, X, precision=precision)
        Wrot = jnp.matmul(W, X, precision=precision)
        R = Wrot - Vrot * theta[None, :].astype(V.dtype)
        resid = jnp.linalg.norm(R, axis=0).real.astype(rt)
        Vrot = jnp.roll(Vrot, locked, axis=1)
        theta = jnp.roll(theta, locked)
        resid = jnp.roll(resid, locked)
        write = (cols2 >= locked) & (cols2 < locked + u)
        # residual VECTORS (rolled like everything else) seed the H²
        # refinement ladder's injection
        return (jnp.where(write[None, :], Vrot, V), theta, resid,
                jnp.roll(R, locked, axis=1))

    # ---------------- init + S-Lanczos + H² bounds --------------------------

    V = gram_qr(V0.astype(H.dtype), jnp.bool_(False))

    m = max(2, min(k, N // 2, lanczos_iter)
            - (min(k, N // 2, lanczos_iter) % 2))
    # probe count can never exceed the first-half width (see fused.py)
    nv = probes.shape[1] if probes is not None else min(num_lanczos, k)

    def s_dot(a, b):
        return jnp.sum(a.conj() * apply_s(b), axis=0).real.astype(rt)

    def lz_step(carry, _):
        v0, v1, w, e_prev = carry
        alpha = s_dot(w, w)
        w2 = w - alpha[None, :].astype(w.dtype) * v1 \
               - e_prev[None, :].astype(w.dtype) * v0
        Hw = jnp.matmul(H, w2, precision=precision)
        b2 = s_dot(w2, Hw)
        e_k = jnp.sqrt(jnp.abs(b2))
        safe = jnp.where(e_k > 0, e_k, jnp.ones((), rt))
        v1n = w2 / safe[None, :].astype(w2.dtype)
        wn = Hw / safe[None, :].astype(Hw.dtype)
        return (v1, v1n, wn, e_k), (alpha, e_k, v1[:, -1])

    # warm starts pass fresh random probes (stale-Krylov hazard; fused.py)
    probes = V[:, :nv] if probes is None else probes.astype(H.dtype)
    w0 = jnp.matmul(H, probes, precision=precision)
    b2 = s_dot(probes, w0)
    b0 = jnp.sqrt(jnp.abs(b2))
    safe = jnp.where(b0 > 0, b0, jnp.ones((), rt))
    probes = probes / safe[None, :].astype(probes.dtype)
    w0 = w0 / safe[None, :].astype(w0.dtype)
    _, (alphas, betas, basis) = jax.lax.scan(
        lz_step, (jnp.zeros_like(probes), probes, w0, jnp.zeros((nv,), rt)),
        None, length=m)

    theta_t, tvecs = _eigh_tridiag_batched(alphas, betas[:-1])
    tau = jnp.abs(tvecs[:, 0, :]) ** 2

    abs_t = jnp.abs(theta_t)
    b_sup = (abs_t.max() ** 2).astype(rt)
    mu_1 = (abs_t.min() ** 2).astype(rt)

    # DoS quantile at search_hi = (N/2 - nev - nex - 1)/N
    search = jnp.asarray(min(max((N / 2 - nev - nex - 1) / N, 0.0), 1.0), rt)
    tf = theta_t.reshape(-1)
    wf = tau.reshape(-1)
    order = jnp.argsort(tf)
    ts = tf[order]
    sigma = 0.25
    thresh = 2 * sigma * sigma / 10
    x = ts[:, None] - tf[None, :]
    g = 0.5 * (1 + jax.scipy.special.erf(x / np.sqrt(2 * sigma * sigma)))
    contrib = jnp.where(x > thresh, 1.0, jnp.where(x < -thresh, 0.0, g))
    cdf = (contrib * wf[None, :]).sum(axis=1) / nv
    crossed = cdf > search
    has = crossed.any()
    i = jnp.argmax(crossed)
    n_dos = nv * m
    prev = jnp.where(i > 0, cdf[jnp.maximum(i - 1, 0)], jnp.zeros((), rt))
    take_i = jnp.abs(cdf[i] - search) < jnp.abs(prev - search)
    lam_nn = jnp.where(take_i, ts[i], ts[jnp.maximum(i - 1, 0)])
    lam_nn = jnp.where(has, lam_nn, ts[-1])
    mu_nevnex = (lam_nn ** 2).astype(rt)

    # DoS vectors from the last probe (no interspersing)
    theta_last = theta_t[-1]
    if inject_dos:
        exceeds = theta_last > lam_nn
        idx = jnp.where(exceeds.any(),
                        jnp.maximum(jnp.argmax(exceeds) - 1, 0),
                        jnp.int32(m))
        idx = jnp.minimum(idx, k - 1)
        dmask = jnp.arange(m) < idx
        Vd = jnp.matmul(basis.T,
                        (tvecs[-1] * dmask[None, :]).astype(H.dtype),
                        precision=precision)
        head = jnp.where(dmask[None, :], Vd, V[:, :m])
        V = V.at[:, :m].set(head)

    lambda_1 = mu_1
    lower = mu_nevnex
    ritzv = jnp.full((K2,), jnp.sqrt(mu_1), rt)
    resid = jnp.full((K2,), big, rt)
    resid_last = jnp.full((K2,), big, rt)
    degrees = jnp.full((K2,), min(deg0 + deg0 % 2, max_deg), jnp.int32)

    # ---------------- main loop --------------------------------------------

    def cond_fn(st):
        (V, Rv, ritzv, resid, resid_last, degrees, locked, it, lower,
         new_mu, new_l1, filtered, blk_hist, r_hist, e_hist) = st
        return (locked < nev) & (it < max_iter)

    def body_fn(st):
        (V, Rv, ritzv, resid, resid_last, degrees, locked, it, lower,
         new_mu, new_l1, filtered, blk_hist, r_hist, e_hist) = st
        u = k - locked
        active_k = colsk >= locked          # within the first half

        nm2 = new_mu * new_mu
        lower = jnp.where((it > 0) & (nm2 < lower) & (nm2 > lambda_1),
                          nm2, lower)

        # -- degrees (vectorized calc_degrees_pseudo_H2) --
        def new_degrees(_):
            lam2 = ritzv[:k] ** 2
            c_h2 = (b_sup + lower) / 2
            e_h2 = (b_sup - lower) / 2
            t = (lam2 - c_h2) / jnp.where(e_h2 > 0, e_h2, jnp.ones((), rt))
            rho = _cheb_rho(t)
            val = jnp.log(resid[:k] / tol) / jnp.log(rho)
            # cap in float BEFORE the int cast — finite |val| > 2^31 (rho
            # just above 1) would overflow astype(int32) to INT_MIN: the
            # column would silently skip the filter and the filtered-vecs
            # counter would go negative
            val = jnp.minimum(jnp.abs(val), float(max_deg))
            d = jnp.where(jnp.isfinite(val) & (rho > 1),
                          jnp.ceil(val).astype(jnp.int32), max_deg)
            if cluster_aware:
                r = resid[:k]
                nexam = jnp.maximum(u - nex, 1)
                exam = active_k & (colsk < locked + nexam)
                mean_r = jnp.sum(jnp.where(exam, r, 0)) / nexam
                wgt = jnp.minimum(1.0 + jnp.log(1.0 + r / (mean_r + 1e-14)),
                                  2.5)
                dist = jnp.abs(ritzv[:k, None] - ritzv[None, :k])
                near = (dist < jnp.abs(b_sup - lower) * 1e-6) \
                    & exam[None, :] & exam[:, None] \
                    & ~jnp.eye(k, dtype=bool)
                dens = jnp.sum(jnp.where(near, wgt[None, :]
                                         / (dist + 1e-14), 0), axis=1)
                nn = jnp.sum(near, axis=1)
                spatial = jnp.where(nn > 0, 1.0 + jnp.log(1.0 + dens * 0.1),
                                    1.0)
                fac = spatial * wgt
                fac = jnp.where((nn > 2) & (r > 2.0 * mean_r), fac * 1.2, fac)
                fac = jnp.where(r > 10.0 * tol, fac * 1.15, fac)
                fac = jnp.clip(fac, 0.5, 3.0)
                # cluster factors apply to EXAMINED columns only — the host
                # computes detect_eigenvalue_clusters over u−nex columns and
                # leaves the nex tail at factor 1 (solver_pseudo.py:84-125,
                # algorithm.inc:19-133).  Inflating tail degrees is also
                # actively harmful: tail Ritz values sit near/inside the
                # damping band, where extra degree only amplifies gap modes
                # excluded by a DoS `lower` overestimate (measured: a 2.5×
                # tail-degree inflation tipped a marginal N=200 BSE ladder
                # solve from 4-iteration convergence into f32 overflow).
                fac = jnp.where(exam, fac, 1.0)
                d = (d * fac).astype(jnp.int32)
                stag = (r <= 10.0 * tol) & (
                    jnp.abs(r - resid_last[:k]) / (r + 1e-14) < 0.1)
                d = jnp.where(stag, d + 6, d)
                d = jnp.where(jnp.abs(ritzv[:k])
                              < jnp.abs(b_sup - lower) * 0.1, d + 2, d)
            d = jnp.minimum(d + deg_extra, max_deg)
            if is_sp:
                d = jnp.maximum(d, 8)
            d = d + d % 2
            return jnp.where(active_k, d, 0).astype(jnp.int32)

        deg_k = jax.lax.cond(
            jnp.logical_and(optimization, it > 0), new_degrees,
            lambda _: jnp.where(active_k, degrees[:k], 0).astype(jnp.int32),
            None)
        # HEMM_H2 = 2 matvecs per recurrence step (host driver counts 2x)
        filtered = filtered + 2 * jnp.sum(deg_k)
        blk_hist = blk_hist.at[it].set(u)

        # -- H² filter on the first half (static half width) --
        c = (b_sup + lower) / 2
        e = (b_sup - lower) / 2
        e = jnp.where(e > 0, e, jnp.abs(b_sup - lower) / 2 + 1e-30)
        sigma1 = e / (lambda_1 - c)
        Vh = V[:, :k]

        def h2(X):
            return jnp.matmul(H, jnp.matmul(H, X, precision=precision),
                              precision=precision) - c * X

        # Two-window degree retirement (P12, as in fused.py:run_filter):
        # the half-block is viewed ascending by degree, the left window
        # retires after its max degree, and the tail steps run on the
        # right static half only.  The permutation is UNDONE immediately
        # after the filter, so locking-v3's positional resid/resid_last
        # stagnation pairing (and the K-conjugation mirror layout) see the
        # original column order — this is what makes retirement safe here
        # where an in-place degree sort measurably stalled the solver.
        dmax = jnp.max(deg_k)
        dperm = jnp.argsort(deg_k, stable=True)
        dperm_inv = inverse_permutation(dperm)
        deg_sorted = deg_k[dperm]

        def run_filter(h2_fn, Vh_in):
            Vin = jnp.take(Vh_in, dperm, axis=1)

            def fbody(degs):
                def body(t, carry):
                    Xp, Yc, sigma = carry
                    tau_s = 1.0 / (2.0 / sigma1 - sigma)
                    Z = (2.0 * tau_s / e) * h2_fn(Yc) - (sigma * tau_s) * Xp
                    Z = jnp.where(degs[None, :] >= t, Z, Yc)
                    return (Yc, Z, tau_s)
                return body

            Y = (sigma1 / e) * h2_fn(Vin)
            Y = jnp.where(deg_sorted[None, :] >= 1, Y, Vin)
            khalf = k // 2
            dmid = jnp.clip(deg_sorted[khalf - 1], 1, dmax)  # ascending
            Xp, Yc, sig = jax.lax.fori_loop(
                2, dmid + 1, fbody(deg_sorted), (Vin, Y, sigma1))
            Xp_r = jax.lax.slice_in_dim(Xp, khalf, k, axis=1)
            Yc_r = jax.lax.slice_in_dim(Yc, khalf, k, axis=1)
            _, Yc_r, _ = jax.lax.fori_loop(
                dmid + 1, dmax + 1, fbody(deg_sorted[khalf:]),
                (Xp_r, Yc_r, sig))
            return jnp.take(
                jnp.concatenate(
                    [jax.lax.slice_in_dim(Yc, 0, khalf, axis=1), Yc_r],
                    axis=1),
                dperm_inv, axis=1)

        if use_bf16_rung:
            # bf16 storage rung: both matmuls of HEMM_H2 take bf16 inputs,
            # f32 accumulation, the carry stays f32 (H-space gate on
            # the spectral-radius magnitude √b_sup, like solver_pseudo)
            def h2_bf(X):
                W = jnp.matmul(H_bf, X.astype(jnp.bfloat16),
                               precision="default",
                               preferred_element_type=H.dtype)
                return jnp.matmul(H_bf, W.astype(jnp.bfloat16),
                                  precision="default",
                                  preferred_element_type=H.dtype) - c * X

            min_wanted = jnp.where(active_k & (colsk < nev), resid[:k],
                                   big).min()
            spec = jnp.sqrt(jnp.maximum(b_sup, jnp.zeros((), rt)))
            low_phase = min_wanted > jnp.asarray(bf16_threshold, rt) * spec
            Yf = jax.lax.cond(low_phase,
                              lambda Vin: run_filter(h2_bf, Vin),
                              lambda Vin: run_filter(h2, Vin), Vh)
        elif use_refine:
            # -- BSE DP ladder in-graph (chebyshev_filter_refine_h2):
            # f64 coefficient tables (exact polynomial bookkeeping) at the
            # expansion points μ = θ²; the deviation recurrence runs on the
            # f32 shadow, seeded by the f64 H²-residuals r2 = (H + θ)·r
            # built from last iteration's pencil-RR residual vectors.
            def run_refine(args):
                Vin, Rfull = args
                lams = (ritzv[:k] ** 2 - c) / e              # (k,) f64

                def tbody(t, ts):
                    sig, p_prev, p_cur, al, be, inj, p_fin = ts
                    sig_new = 1.0 / (2.0 / sigma1 - sig)
                    al = al.at[t].set(2.0 * sig_new / e)
                    be = be.at[t].set(-sig * sig_new)
                    inj = inj.at[t].set((2.0 * sig_new / e) * p_cur)
                    p_new = (2.0 * sig_new * lams * p_cur
                             - sig * sig_new * p_prev)
                    p_fin = jnp.where(deg_k >= t, p_new, p_fin)
                    return (sig_new, p_cur, p_new, al, be, inj, p_fin)

                p1 = sigma1 * lams
                p_fin0 = jnp.where(deg_k >= 1, p1, jnp.ones_like(lams))
                D = max_deg
                _, _, _, al, be, inj, p_fin = jax.lax.fori_loop(
                    2, D + 1, tbody,
                    (sigma1, jnp.ones_like(lams), p1,
                     jnp.zeros((D + 1,), rt), jnp.zeros((D + 1,), rt),
                     jnp.zeros((D + 1, k), rt), p_fin0))

                # ONE f64 HEMM: H²-residuals from the H-residuals
                Rh = Rfull[:, :k]
                R2 = jnp.matmul(H, Rh, precision=precision) \
                    + ritzv[:k][None, :].astype(H.dtype) * Rh
                Rc = R2.astype(low_dt)
                cl = c.astype(low_rt)
                all_ = al.astype(low_rt)
                bel = be.astype(low_rt)
                injl = inj.astype(low_rt)
                Wd = (sigma1 / e).astype(low_rt) * Rc

                def rbody(t, stw):
                    Wp, Wc = stw
                    h2w = jnp.matmul(
                        H_lo, jnp.matmul(H_lo, Wc, precision=precision),
                        precision=precision) - cl * Wc
                    Zc = all_[t] * h2w + bel[t] * Wp \
                        + injl[t][None, :] * Rc
                    Zc = jnp.where(deg_k[None, :] >= t, Zc, Wc)
                    return (Wc, Zc)

                _, Wd = jax.lax.fori_loop(2, dmax + 1, rbody,
                                          (jnp.zeros_like(Rc), Wd))
                Y = p_fin[None, :].astype(H.dtype) * Vin \
                    + Wd.astype(H.dtype)
                return jnp.where(deg_k[None, :] >= 1, Y, Vin)

            def run_low0(args):
                # iteration 0 (no residual vectors yet): plain H²
                # recurrence with the f32 shadow — the classic low phase
                Vin, _ = args

                def h2_low(X):
                    W = jnp.matmul(H_lo, X.astype(low_dt),
                                   precision=precision,
                                   preferred_element_type=H.dtype)
                    return jnp.matmul(H_lo, W.astype(low_dt),
                                      precision=precision,
                                      preferred_element_type=H.dtype) \
                        - c * X

                return run_filter(h2_low, Vin)

            Yf = jax.lax.cond(it > 0, run_refine, run_low0, (Vh, Rv))
        else:
            Yf = run_filter(h2, Vh)
        V = V.at[:, :k].set(Yf)

        # -- K-conjugation: regenerate mirrors --
        V = k_conj(V, locked, u)

        # -- cond → QR shift flag (squared space) --
        t_1 = (lambda_1 - c) / e
        t_k = jnp.where(it > 0, (ritzv[locked] ** 2 - c) / e, t_1)
        rho1, rhok = _cheb_rho(t_1), _cheb_rho(t_k)
        dmin = jnp.where(active_k, deg_k, max_deg + 2).min()
        logcond = dmin * jnp.log(rhok) + (dmax - dmin) * jnp.log(rho1)
        shift_on = logcond > np.log(cond_shift_threshold)

        V = pseudo_qr(V, locked, shift_on)

        # -- pencil RR + residuals --
        V, th, rs, Rnew = pencil_rr(V, locked)
        active2 = (cols2 >= locked) & (cols2 < locked + u)
        if use_refine:
            # residual VECTORS feed the next iteration's H² refinement
            Rv = jnp.where(active2[None, :], Rnew, Rv)
        ritzv = jnp.where(active2, th, ritzv)
        resid = jnp.where(active2, rs, resid)
        r_hist = r_hist.at[it].set(
            jnp.where(active_k, resid[:k], jnp.asarray(-1.0, rt)))

        # -- bound refresh from sorted active θ --
        masked = jnp.where(active2[:k] if False else
                           (active_k), ritzv[:k], big)
        srt = jnp.sort(masked)
        q95 = jnp.maximum((u * 95) // 100 - 1, 0)
        new_mu = srt[q95]
        new_l1 = srt[0]

        # -- locking v3 (index order, stable group sort) --
        exam = active_k & (colsk < k - nex)
        r_k = resid[:k]
        stag = (r_k > tol) & (r_k >= resid_last[:k]) & \
            (r_k <= 1000.0 * tol) & (it >= 4)
        conv = exam & ((r_k <= tol) | stag)
        e_hist = e_hist.at[it].set(
            jnp.where(exam & stag & (r_k > tol), r_k,
                      jnp.asarray(-1.0, rt)))
        group = jnp.where(colsk < locked, 0, jnp.where(conv, 1, 2))
        perm_k = jnp.argsort(group, stable=True)
        perm2 = jnp.concatenate([perm_k, jnp.arange(k, K2)])
        V = jnp.take(V, perm2, axis=1)
        if use_refine:
            Rv = jnp.take(Rv, perm2, axis=1)
        ritzv = ritzv.at[:k].set(ritzv[:k][perm_k])
        resid = resid.at[:k].set(r_k[perm_k])
        resid_last = resid_last.at[:k].set(r_k[perm_k])   # v3 semantics
        degrees = degrees.at[:k].set(deg_k[perm_k])
        nc = jnp.sum(conv).astype(locked.dtype)

        # mirror the newly locked pairs into the right-end locked region
        V = jax.lax.cond(nc > 0, lambda v: k_conj(v, locked, nc),
                         lambda v: v, V)
        locked = locked + nc
        return (V, Rv, ritzv, resid, resid_last, degrees, locked, it + 1,
                lower, new_mu, new_l1, filtered, blk_hist, r_hist, e_hist)

    # residual-vector carry: 1-column zero placeholder when the ladder is
    # off (keeps one state pytree structure, like fused.py)
    Rv0 = jnp.zeros_like(V) if use_refine else jnp.zeros((1, 1), V.dtype)
    state = (V, Rv0, ritzv, resid, resid_last, degrees, jnp.int32(0),
             jnp.int32(0), lower.astype(rt), jnp.sqrt(mu_nevnex).astype(rt),
             jnp.sqrt(mu_1).astype(rt),
             jnp.int64(0) if jax.config.jax_enable_x64 else jnp.int32(0),
             jnp.zeros((max_iter,), jnp.int32),
             jnp.full((max_iter, k), -1.0, rt),
             jnp.full((max_iter, k), -1.0, rt))
    (V, _Rv, ritzv, resid, resid_last, degrees, locked, it, lower,
     _nm, _nl, filtered, blk_hist, r_hist, e_hist) = \
        jax.lax.while_loop(cond_fn, body_fn, state)

    # ---- final: positive ascending first over the first k entries ----------
    vals = ritzv[:k]
    keys = jnp.where(vals > 0, jnp.zeros((), rt), jnp.ones((), rt))
    order = jnp.lexsort((vals, keys))
    order2 = jnp.concatenate([order, jnp.arange(k, K2)])
    V = jnp.take(V, order2, axis=1)
    ritzv = ritzv.at[:k].set(vals[order])
    resid = resid.at[:k].set(resid[:k][order])

    return {"V": V, "ritzv": ritzv, "resid": resid, "locked": locked,
            "iterations": it, "lowerb": lower, "upperb": b_sup,
            "filtered_vecs": filtered, "block_history": blk_hist,
            "resid_history": r_hist, "early_history": e_hist}
