"""Pseudo-Hermitian (BSE) solver driver.

JAX redesign of ``Algorithm<T>::solve_pseudo``
(algorithm/algorithm.inc:1834-2220): subspace of 2·(nev+nex) columns laid
out [locked_L | positive candidates u | K-mirrors u | locked_R], Chebyshev
filtering on H², S-orthogonalizing QR, Hermitianized-pencil Rayleigh–Ritz
keeping the positive half, index-order locking (v3) with mirror
regeneration via K-conjugation.

Same static-shape discipline as the Hermitian driver (solver.py): filter on
a bucketed window, RR/QR at full width with masks/pads, host-side
bookkeeping, one small device→host transfer per iteration.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import ChaseConfig
from .device import precision_rung
from .logger import get_logger
from .perf import PerfData
from .types import is_complex_dtype, is_double_base
from .parallel.operator import DenseOperator
from .solver import SolveResult, _col_block
from .ops.blocks import (permute_cols, slice_cols, update_cols,
                         set_head_cols, scale_lower_rows)
from .ops import lanczos as lz
from .ops import pseudo as ps
from .ops.qr import (orthonormalize, orthonormalize_pseudo,
                     cholqr as qrops_cholqr)

__all__ = ["solve_pseudo"]


# --------------------------------------------------------------------------
# host-side bookkeeping (pseudo variants)
# --------------------------------------------------------------------------

def detect_eigenvalue_clusters(ritzv, resid, tol, n, upperb, lowerb):
    """Residual-weighted spatial clustering → per-vector degree factors in
    [0.5, 3.0], 1-2-1 smoothed.  Port of algorithm.inc:19-133."""
    if n <= 0:
        return np.ones(0)
    factors = np.ones(n)
    cluster_threshold = abs(upperb - lowerb) * 1e-6
    mean_res = float(np.mean(resid[:n]))
    rel = resid[:n] / (mean_res + 1e-14)
    weights = np.minimum(1.0 + np.log(1.0 + rel), 2.5)
    for i in range(n):
        d = np.abs(ritzv[i] - ritzv[:n])
        near = (d < cluster_threshold)
        near[i] = False
        neighbors = int(np.sum(near))
        spatial = 1.0
        if neighbors > 0:
            local_density = float(np.sum(weights[near] / (d[near] + 1e-14)))
            spatial = 1.0 + np.log(1.0 + local_density * 0.1)
        combined = spatial * weights[i]
        if neighbors > 2 and resid[i] > 2.0 * mean_res:
            combined *= 1.2
        if resid[i] > 10.0 * tol:
            combined *= 1.15
        factors[i] = min(3.0, max(0.5, combined))
    smoothed = factors.copy()
    for i in range(1, n - 1):
        smoothed[i] = 0.25 * factors[i - 1] + 0.5 * factors[i] \
            + 0.25 * factors[i + 1]
    return np.minimum(3.0, np.maximum(0.5, smoothed))


def calc_degrees_pseudo_h2_host(u, nex, b_sup, lower, tol, ritzv_a, resid_a,
                                resid_last_a, degrees_a, rcfg, is_sp):
    """λ²-based optimal degrees with cluster/stagnation/near-zero bonuses.

    In-place on the active views; port of calc_degrees_pseudo_H2
    (algorithm.inc:196-317).  Returns (deg_max_active, perm_over_active).
    """
    max_deg = rcfg.max_deg
    cluster = rcfg.cluster_aware_degrees
    factors = (detect_eigenvalue_clusters(ritzv_a, resid_a, tol, u - nex,
                                          b_sup, lower)
               if cluster else None)
    c_h2 = (b_sup + lower) / 2
    e_h2 = (b_sup - lower) / 2
    if e_h2 <= 0:
        degrees_a[:u] = max_deg + max_deg % 2
        return max_deg + max_deg % 2, np.arange(u)
    for i in range(u):
        lam2 = float(ritzv_a[i]) ** 2
        r = float(resid_a[i])
        t = (lam2 - c_h2) / e_h2
        z = complex(t) ** 2 - 1.0
        s = np.sqrt(z)
        rho = max(abs(complex(t) - s), abs(complex(t) + s))
        if not np.isfinite(rho) or rho <= 1.0:
            deg = max_deg
        else:
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                lr = np.log(r / tol) / np.log(rho)
            if not np.isfinite(lr):
                deg = max_deg
            else:
                deg = int(np.ceil(abs(float(lr))))
                if cluster:
                    f = factors[i] if i < len(factors) else 1.0
                    deg = int(deg * f)
                    if r <= 10.0 * tol:
                        rel_change = abs(r - float(resid_last_a[i])) / (r + 1e-14)
                        if rel_change < 0.1:
                            deg += 6     # stagnation bonus
                    if abs(float(ritzv_a[i])) < abs(b_sup - lower) * 0.1:
                        deg += 2         # near-zero-λ bonus
                deg = min(deg + rcfg.deg_extra, max_deg)
        if is_sp:
            deg = max(deg, 8)
        degrees_a[i] = deg + deg % 2
    perm = np.argsort(degrees_a[:u], kind="stable")
    degrees_a[:u] = degrees_a[:u][perm]
    ritzv_a[:u] = ritzv_a[:u][perm]
    resid_a[:u] = resid_a[:u][perm]
    return int(np.max(degrees_a[:u])), perm


def locking_pseudo_v3_host(ritzv_a, resid_a, resid_last_a, u, nex, tol,
                           iteration):
    """Index-order locking with 1000·tol stagnation early-lock after
    iteration ≥ 4.  Port of locking_pseudo_v3 (algorithm.inc:730-816)
    including its residLast reshuffle.  In-place; returns
    (new_converged, perm_over_u, early_locked)."""
    resid_last_unconv = resid_a[:u].copy()
    perm = np.arange(u)
    converged = 0
    early = []
    index_unconverged = []
    for k in range(u - nex):
        j = k
        rj = float(resid_a[j])
        stag = (rj > tol and rj >= float(resid_last_a[k])
                and rj <= 1000.0 * tol and iteration >= 4)
        if rj <= tol or stag:
            if stag:
                early.append(rj)
            if j != converged:
                for arr in (resid_a, ritzv_a):
                    arr[j], arr[converged] = arr[converged], arr[j]
                perm[j], perm[converged] = perm[converged], perm[j]
            converged += 1
        else:
            index_unconverged.append(j)
    for k in range(u - nex, u):
        index_unconverged.append(k)
    for i in range(converged, u):
        resid_last_a[i] = resid_last_unconv[index_unconverged[i - converged]]
    return converged, perm, early


def _iter0_degree_cap(lambda_1, lower, b_sup, deg0,
                      dyn_range: float = 1e6) -> int:
    """Iteration-0 H² filter degree cap for reduced-precision filters.

    The first filter has no residual information and runs at a uniform
    degree; its amplification ratio between the wanted edge μ₁=``lambda_1``
    and the damped interval [``lower``, ``b_sup``] is ~rho₁^deg.  Past
    ~``dyn_range`` the damped directions sink below the reduced-precision
    noise floor, the block's columns become numerically dependent and the
    S-QR Gram collapses (eig_min ~1e-19·‖G‖ at N=8192), forcing an f64
    TSQR rescue EVERY solve.  Capping the
    degree keeps the filtered basis inside shifted-CholQR range — the
    reference's Householder fallback is exceptional, not structural
    (chase_cpu.hpp:725-751) — and the discarded compression was below the
    noise floor anyway.  Returns an even cap in [8, deg0].
    """
    if not (lower > lambda_1 and b_sup > lower):
        return deg0
    from .solver import _rho as _rho_fn
    cc0 = (b_sup + lower) / 2.0
    ee0 = (b_sup - lower) / 2.0
    rho1 = _rho_fn((lambda_1 - cc0) / ee0)
    if not np.isfinite(rho1) or rho1 <= 1.0 + 1e-9:
        return deg0
    cap = int(np.log(dyn_range) / np.log(rho1))
    cap = max(8, cap - (cap % 2))
    return min(cap, deg0)


# --------------------------------------------------------------------------
# dispatch-folded segmented H² filters (module-level so tests can hit them
# directly — the solver._filter_windowed analogues on the BSE window)
# --------------------------------------------------------------------------

def _h2_filter_windowed(H_f, V, deg_win, start, B, right, lambda_1, lower,
                        b_sup, precision):
    """Dispatch-folded segmented H² recurrence on a right-aligned window
    ending at column ``right`` (= locked+u in the solve loop).

    ``deg_win`` is the np.int32 degree vector of the initial window (width
    w_pad = len(deg_win)); degree-0 pad columns are restored bit-exactly at
    every write-back.  Returns (V, executed column-steps).  Mirrors
    solver._filter_windowed's bucket-retirement plan with the H² operator
    (algorithm.inc:1012-1064 filter_H2 + :974-1000 retirement).
    """
    from .solver import _shrink_plan
    from .types import filter_carry_dtype as _fcd, real_dtype as _rdtf
    w_pad = len(deg_win)
    carry = _fcd(H_f.dtype, V.dtype)
    crt = _rdtf(carry)
    plan = _shrink_plan(deg_win, B, w_pad)
    lo_ = min(float(lower), float(b_sup))
    up_ = max(float(lower), float(b_sup))
    c_s = np.asarray((up_ + lo_) / 2, crt)
    e_s = np.asarray((up_ - lo_) / 2, crt)
    sig1 = np.asarray(e_s / (np.asarray(lambda_1, crt) - c_s), crt)
    X0, Xp, Yc, sigma = ps.h2_seg_init(
        H_f, V, jnp.int32(start), jnp.asarray(deg_win), c_s, e_s,
        sig1, w_pad=w_pad, precision=precision)
    executed = w_pad
    t_done = 1
    start0 = start
    w_cur = w_pad
    pend_off = 0
    for (t_end, plan_off) in plan:
        if t_end > t_done:
            V, X0, Xp, Yc, sigma = ps.h2_seg_steps(
                H_f, V, X0, Xp, Yc, jnp.asarray(deg_win), sigma,
                sig1, c_s, e_s, jnp.int32(pend_off),
                jnp.int32(start), jnp.int32(t_done + 1),
                jnp.int32(t_end + 1), w_new=w_cur,
                precision=precision)
            pend_off = 0
            executed += w_cur * (t_end - t_done)
            t_done = t_end
        retire_to = start0 + plan_off
        if retire_to < right:
            new_w = right - retire_to
            new_w_pad = min(-(-new_w // B) * B, w_cur)
            new_start = right - new_w_pad
            off2 = new_start - start
            if off2 > 0:
                deg_win = deg_win[off2:]
                start, w_cur = new_start, new_w_pad
                pend_off += off2
    return V, executed


def _h2_refine_windowed(H_f, V, X, R2w, deg_win, start, B, right, a1e, al,
                        be, inj, pf, cc_h2, precision):
    """Dispatch-folded segmented deviation recurrence on H² (the BSE DP
    ladder's filter).  ``X`` is the pre-sliced window (V[:, start:start+w]),
    ``R2w`` its H²-residual seed, tables from ops.filter.refine_tables on
    the H²-space quantities.  Returns (V, executed column-steps).  Mirrors
    solver._filter_refine_windowed (each segment = shrink + steps + combine
    + write-back in ONE program, ops/pseudo.refine_h2_seg_steps)."""
    from .solver import _shrink_plan
    from .types import filter_carry_dtype as _fcd, real_dtype as _rdtf
    w_pad = len(deg_win)
    carry = _fcd(H_f.dtype, V.dtype)
    crt = _rdtf(carry)
    plan = _shrink_plan(deg_win, B, w_pad)
    al_d = jnp.asarray(al, crt)
    be_d = jnp.asarray(be, crt)
    inj_np, pf_np = inj, pf
    cc_d = jnp.asarray(cc_h2, crt)
    X0 = X
    Rc = R2w.astype(carry)
    Wc = jnp.asarray(a1e, crt) * Rc
    Wp = jnp.zeros_like(Rc)
    executed = 0
    t_done = 1
    start0 = start
    w_cur = w_pad
    pend_off = 0
    for (t_end, plan_off) in plan:
        if t_end > t_done:
            V, X0, Wp, Wc, Rc = ps.refine_h2_seg_steps(
                H_f, V, X0, Wp, Wc, Rc, jnp.asarray(deg_win),
                al_d, be_d, jnp.asarray(inj_np, crt),
                jnp.asarray(pf_np), cc_d,
                jnp.int32(pend_off), jnp.int32(start),
                jnp.int32(t_done + 1), jnp.int32(t_end + 1),
                w_new=w_cur, precision=precision)
            pend_off = 0
            executed += w_cur * (t_end - t_done)
            t_done = t_end
        retire_to = start0 + plan_off
        if retire_to < right:
            new_w = right - retire_to
            new_w_pad = min(-(-new_w // B) * B, w_cur)
            new_start = right - new_w_pad
            off2 = new_start - start
            if off2 > 0:
                deg_win = deg_win[off2:]
                inj_np = inj_np[:, off2:]
                pf_np = pf_np[off2:]
                start, w_cur = new_start, new_w_pad
                pend_off += off2
    return V, executed


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def solve_pseudo(op: DenseOperator, nev: int, nex: int,
                 config: Optional[ChaseConfig] = None,
                 V0=None, ritzv0=None, perf: Optional[PerfData] = None,
                 key=None) -> SolveResult:
    """Compute the nev smallest-positive eigenpairs of the pseudo-Hermitian
    (BSE) operator H = S·M (spectrum real, symmetric about 0)."""
    cfg = config or ChaseConfig()
    rcfg = cfg.resolve(op.dtype)
    log = get_logger()
    N, nevex = op.N, nev + nex
    K2 = 2 * nevex
    if N % 2:
        raise ValueError("pseudo-Hermitian problems need even N")
    if nevex > N // 2:
        raise ValueError(f"nev+nex = {nevex} exceeds N/2 = {N // 2}")
    precision = rcfg.matmul_precision
    is_sp = not is_double_base(op.dtype)
    from .solver import resolve_small_dense, resolve_wide
    small_dense, qr_backend = resolve_small_dense(rcfg.small_dense_backend)
    # exact-slice GEMM for the f64 pencil-RR/QR HEMMs (ops/wide), opt-in —
    # the pseudo arm of the wide-f64 policy
    use_wide, small_dense, qr_backend = resolve_wide(
        rcfg, op, is_sp, small_dense, qr_backend)
    # Deviation-form H² refinement eligibility (the BSE DP ladder): DP
    # problems with mixed_precision keep the H² recurrence in f32 forever
    # (the injection carries the f64 information); f32 problems with the
    # bf16 rung keep it in bf16.  Needs pencil-RR residual vectors, so it
    # engages from iteration 1.
    refine_capable = rcfg.refine_filter and (
        (not is_sp and rcfg.mixed_precision)
        or (is_sp and rcfg.bf16_filter and not is_complex_dtype(op.dtype)))
    if use_wide:
        log.info(f"wide-f64 GEMM engaged for the pseudo RR/QR (N={op.N}); "
                 f"disable with wide_f64='off'", "linalg")
        op.engage_wide(drop=refine_capable)
        jax.block_until_ready(op.H_wide[0])   # serialize (see solver.py)
    R_prev = None              # (N, K2) pencil-RR H-residual vectors
    tol = rcfg.tol
    timing = perf is not None
    if perf is not None:
        perf.matrix_type = 1

    def toc(phase, t0, *arrays):
        if timing:
            for a in arrays:
                if hasattr(a, "block_until_ready"):
                    a.block_until_ready()
            perf.add_time(phase, time.perf_counter() - t0)
        return time.perf_counter()

    t_all0 = time.perf_counter()
    t0 = time.perf_counter()

    if rcfg.sym_check:
        from .ops.checks import check_pseudo_hermitian
        # wide mode: probe the f32 shadow — the check needs f32 fidelity
        # only, and touching op.H would re-upload the dropped f64 buffer
        H_probe = op.H_low if use_wide else op.H
        if not check_pseudo_hermitian(H_probe, precision=precision):
            log.warn("input matrix failed the randomized pseudo-hermiticity "
                     "probe (checkPseudoHermicityEasy analogue)")

    # ---- initVecs: random 2·nevex block, lower rows ×0.001, QR ------------
    approx = rcfg.approx and V0 is not None
    if key is None:
        key = jax.random.key(rcfg.seed)
    if V0 is not None:
        V = op.place_block(jnp.asarray(V0, op.dtype))
    else:
        V = op.place_block(jax.random.normal(key, (N, K2), dtype=op.dtype))
        V = scale_lower_rows(V, 0.001)
    if not approx:
        if use_wide:
            # f32 init QR in wide mode (see solver.py: a random block
            # needs no f64-accurate orthonormalization, and the wide
            # GEMM's slicing transients at full 2(nev+nex) width OOM
            # large-N chips)
            V.block_until_ready()      # serialize vs the engage uploads
            Q32, ok32 = qrops_cholqr(V.astype(jnp.float32), passes=2,
                                     precision=precision)
            if bool(ok32):
                V = Q32.astype(op.dtype)
                V.block_until_ready()
            else:
                V = orthonormalize(V, 0, 1.0, rcfg, op.grid,
                                   small_dense=qr_backend)
        else:
            V = orthonormalize(V, 0, 1.0, rcfg, op.grid,
                               small_dense=qr_backend)
    t0 = toc("InitVecs", t0, V)

    deg0 = min(rcfg.deg + rcfg.deg % 2, rcfg.max_deg)
    degrees = np.full(K2, deg0, dtype=np.int64)
    resid = np.full(K2, np.finfo(np.float64).max)
    resid_last = np.full(K2, np.finfo(np.float64).max)
    ritzv = np.zeros(K2, np.float64)

    # ---- Lanczos on H (S-metric) → H² bounds (algorithm.inc:1217-1373) ----
    m = min(nevex, N // 2, rcfg.lanczos_iter)
    m -= m % 2
    m = max(m, 2)
    numvec = min(rcfg.num_lanczos, K2)
    # ANY user-provided basis probes with FRESH random vectors: a Krylov
    # space seeded with converged (or near-converged) eigenvectors breaks
    # down immediately (beta~0), the DoS quantile collapses toward
    # lambda_1, and the H² filter window then SUPPRESSES most of the
    # wanted band (measured: warm solve with 6 exact eigvecs in v0
    # stalled 10/12 columns for 25 iterations with lower=1.078 vs the
    # true 4.107; fresh probes restore 1-iteration re-convergence).
    # Same rationale as solver.py's approx branch; deviation from the
    # reference, which reuses the approximate V for lanczos_for_H2.
    if V0 is not None:
        probes = op.place_block(scale_lower_rows(
            jax.random.normal(jax.random.fold_in(key, 1), (N, numvec),
                              dtype=op.dtype), 0.001))
    else:
        probes = V[:, :numvec]
    # wide mode: spectral-bound estimation runs on the f32 shadow (bounds
    # need ~1e-7 relative fidelity; see solver.py's wide Lanczos rationale)
    H_lz = op.H_low if use_wide else op.H
    alphas, betas, basis = ps.lanczos_scan_pseudo(
        H_lz, probes.astype(H_lz.dtype), m=m, precision=precision,
        want_basis=True)
    a_np = np.asarray(alphas, np.float64)
    b_np = np.asarray(betas, np.float64)
    t0 = toc("Lanczos", t0, alphas)
    theta, tau, ritzV_last = lz.lanczos_tridiag_host(a_np, b_np)

    abs_t = np.abs(theta)
    b_sup = float(abs_t.max()) ** 2
    mu_1 = float(abs_t.min()) ** 2
    upperb = b_sup

    # DoS quantile in H-space: search_hi = (N/2 - nev - nex - 1)/N
    search_hi = (N / 2 - nev - nex - 1) / N
    search_hi = min(max(search_hi, 0.0), 1.0)
    theta_flat = theta.reshape(-1)
    tau_flat = tau.reshape(-1)
    order = np.argsort(theta_flat)
    theta_sorted = theta_flat[order]
    sigma = 0.25
    thresh = 2 * sigma * sigma / 10
    from scipy.special import erf

    def G(x):
        return 0.5 * (1 + erf(x / np.sqrt(2 * sigma * sigma)))

    lam_nevnex = float(theta_sorted[-1])
    prev = 0.0
    n_dos = numvec * m
    for i in range(n_dos):
        x = theta_sorted[i]
        lo = x < (theta_flat - thresh)
        hi = x > (theta_flat + thresh)
        mid = ~(lo | hi)
        curr = float(np.sum(tau_flat[hi])
                     + np.sum(tau_flat[mid] * G(x - theta_flat[mid])))
        curr /= numvec
        if curr > search_hi:
            if abs(curr - search_hi) < abs(prev - search_hi):
                lam_nevnex = float(theta_sorted[i])
            else:
                lam_nevnex = float(theta_sorted[i - 1] if i > 0
                                   else theta_sorted[i])
            break
        prev = curr
        lam_nevnex = float(theta_sorted[i])
    mu_nevnex = lam_nevnex ** 2

    # DoS starting vectors from the last probe's basis
    theta_last = theta[-1]
    idx = 0
    for i in range(m):
        if theta_last[i] > lam_nevnex:
            idx = i - 1
            break
        idx = i + 1
    idx = max(idx, 0)
    idx = min(idx, nevex - 1)
    if V0 is not None:
        # keep the caller's warm subspace intact — no DoS vector injection
        # (fused drivers already skip it for warm starts)
        idx = 0
    if idx > 0:
        mask = jnp.asarray(np.arange(m) < idx)
        Vd = lz.lanczos_dos_vectors(basis, jnp.asarray(ritzV_last), mask,
                                    precision=precision)
        V = set_head_cols(V, Vd, mask)
    ritzv[:idx] = theta_last[:idx] ** 2
    ritzv[idx:nevex - 1] = mu_1
    ritzv[nevex - 1] = mu_nevnex
    if idx > 1:
        perm = np.arange(K2)
        for i in range(1, idx):
            j = i * (nevex // idx)
            perm[i], perm[j] = perm[j], perm[i]
            ritzv[i], ritzv[j] = ritzv[j], ritzv[i]
        V = permute_cols(V, jnp.asarray(perm))

    # Release the Lanczos locals (H_lz pins the f32 shadow through later
    # QR/RR on transient-shadow wide solves — solver.py analogue, r5)
    H_lz = basis = probes = Vd = None
    op.drop_shadow()

    mu_1 = float(np.min(ritzv[:nevex - 1])) if nevex > 1 else float(ritzv[0])
    mu_nevnex = float(ritzv[nevex - 1])
    upperb = upperb * rcfg.upperb_scale if upperb > 0 \
        else upperb / rcfg.upperb_scale
    lambda_1 = mu_1
    lower = mu_nevnex
    new_mu_nevex = lower
    new_lambda_1 = lambda_1
    b_sup = upperb
    lower = lower * rcfg.decaying_rate
    log.info(f"solve_pseudo H² bounds: lambda_1={lambda_1:.6e} "
             f"lower={lower:.6e} b_sup={b_sup:.6e} (DoS idx={idx})")

    # -- iteration-0 degree cap (kills the structural BSE QR breakdown) --
    # The first H² filter runs before any residuals exist and, on the
    # mixed-precision ladder, in a reduced dtype.  Its amplification ratio
    # between the wanted edge (μ₁) and the damped interval is ~rho₁^deg: past
    # ~1e6 the damped directions sink under the reduced filter's noise floor,
    # every column compresses onto the same dominant eigendirections, and the
    # S-QR Gram collapses (eig_min ~1e-19·‖G‖ at N=8192), forcing an f64 TSQR
    # rescue EVERY solve.  Capping deg₀ so rho₁^deg₀ ≲ 1e6 keeps the filtered
    # basis inside shifted-CholQR's range; compression beyond the noise floor
    # bought nothing anyway (the RR step can only extract what survives
    # precision).  The reference's fallback is exceptional, not structural
    # (chase_cpu.hpp:725-751) — this restores that property.
    reduced_iter0 = (refine_capable
                     or (rcfg.mixed_precision and not is_sp)
                     or (rcfg.bf16_filter and is_sp))
    if reduced_iter0:
        cap = _iter0_degree_cap(lambda_1, lower, b_sup, deg0)
        if cap < deg0:
            log.info(
                f"iteration-0 H² degree capped {deg0} -> {cap} "
                f"(keeps the reduced-precision filtered basis "
                f"CholQR-able)", "algorithm")
            deg0 = cap
            degrees[:] = deg0

    locked = 0
    unconverged = nevex
    iteration = 0
    early_all: list = []

    resid_file = None
    if rcfg.save_residuals:
        resid_file = open(rcfg.save_residuals, "w")
        resid_file.write("iteration,residual\n")

    # ring eligibility (auto like the Hermitian driver; see solver.py)
    from .solver import _ring_mode
    ring_mode = (_ring_mode(op.grid, N)
                 if rcfg.ring_filter is not False else None)
    if ring_mode is not None and rcfg.ring_filter is None:
        log.info(f"H² ring filter auto-enabled ({ring_mode} schedule); "
                 f"opt out with ring_filter=False", "linalg")

    # ---- main loop (algorithm.inc:1963-2170) -------------------------------
    while locked < nev and unconverged > 0 and iteration < rcfg.max_iter:
        u = unconverged
        act = slice(locked, locked + u)

        if iteration > 0:
            nm2 = new_mu_nevex * new_mu_nevex
            nl2 = new_lambda_1 * new_lambda_1
            del nl2  # reference computes but leaves lambda_1 fixed
            if lambda_1 < nm2 < lower:
                lower = nm2
        log.info(f"pseudo iteration {iteration}: lambda_1={lambda_1:.6e} "
                 f"lower={lower:.6e} b_sup={b_sup:.6e} unconverged={u}")

        # -- degrees --
        if rcfg.optimization and iteration != 0:
            _, perm = calc_degrees_pseudo_h2_host(
                u, nex, b_sup, lower, tol, ritzv[act], resid[act],
                resid_last[act], degrees[act], rcfg, is_sp)
            if not np.array_equal(perm, np.arange(u)):
                full_perm = np.arange(K2)
                full_perm[act] = locked + perm
                V = permute_cols(V, jnp.asarray(full_perm))
                if R_prev is not None:
                    R_prev = permute_cols(R_prev, jnp.asarray(full_perm))

        # -- filter on H² over the positive-candidate window --
        B = _col_block(rcfg.col_block, nevex)
        w_pad = min(nevex, -(-u // B) * B)
        # window right-aligned at locked+u
        start = max(0, locked + u - w_pad)
        offset = locked - start
        deg_win = np.zeros(w_pad, np.int32)
        deg_win[offset:] = degrees[act]
        # Mixed-precision ladder (P10) on the BSE path: while the active
        # block is far from converged the H² recurrence takes a reduced-
        # precision H.  f32 problems: the bf16 storage rung — bf16 matmul
        # inputs, f32 accumulation, carry stays f32
        # (ops/pseudo._h2_shift).  64-bit problems: the f32/c64 shadow
        # (whole recurrence in the reduced dtype) — the reference's DP→SP
        # filter switch (chase_cpu.hpp:384-447) applied to HEMM_H2.
        # Gates mirror solver.py: residuals are H-space (‖Hv−λv‖), so the
        # bf16 relative gate scales by |λ|_max ≈ √b_sup.
        min_resid = (float(np.min(resid[locked:nev])) if locked < nev
                     else 0.0)
        spec_scale = float(np.sqrt(max(b_sup, 0.0)))
        use_bf16 = (rcfg.bf16_filter and is_sp and locked < nev
                    and not is_complex_dtype(op.dtype)
                    and min_resid > rcfg.bf16_filter_threshold * spec_scale)
        use_low = (not use_bf16 and rcfg.mixed_precision and not is_sp
                   and locked < nev
                   and min_resid > rcfg.mixed_precision_threshold)
        use_refine = refine_capable and R_prev is not None
        if use_refine:
            # deviation-form H² ladder: fast-dtype recurrence seeded by the
            # f64 H²-residuals — no threshold, never hands back to f64 H
            use_low = use_bf16 = False
            # bf16 transient rebuild on memory-tight large-N wide solves
            # (operator.H_filter); H_low (f32) otherwise
            H_f = op.H_filter if use_wide else op.H_low
            f_precision = "default" if is_sp else precision
        elif use_low and use_wide:
            H_f = op.H_filter        # bf16 rebuild in transient mode
            f_precision = "default"
        else:
            H_f = op.H_low if (use_bf16 or use_low) else op.H
            f_precision = "default" if use_bf16 else precision
        if use_refine or ring_mode is not None:
            # the ring paths and the refine seed need the explicit window
            # slice; the dispatch-folded classic path slices in-program
            X = slice_cols(V, jnp.int32(start), w_pad)
        if use_refine:
            from .ops import filter as filt
            ritz_win = np.zeros(w_pad, np.float64)
            ritz_win[offset:] = ritzv[act]
            # H²-space tables: expansion points μ = θ², interval
            # [lower, b_sup], amplification point μ₁ = lambda_1
            a1e, al, be, inj, pf = filt.refine_tables(
                ritz_win ** 2, deg_win, lambda_1, lower, b_sup,
                rcfg.max_deg)
            theta_win = jnp.asarray(ritz_win, op.real_dtype)
            Rw = slice_cols(R_prev, jnp.int32(start), w_pad)
            # ONE f64-accurate HEMM turns the pencil-RR H-residuals into
            # H²-residuals: r2 = (H + θ)·r
            if use_wide:
                R2w = ps.h2_residual_wide(op.H_wide, Rw, theta_win)
            else:
                R2w = ps.h2_residual(op.H, Rw, theta_win,
                                     precision=precision)
            cc_h2 = (b_sup + lower) / 2.0
            if ring_mode is not None:
                from .parallel.ring import (
                    chebyshev_filter_refine_h2_ring,
                    chebyshev_filter_refine_h2_ring2d)
                ring_fn = (chebyshev_filter_refine_h2_ring
                           if ring_mode == "1d"
                           else chebyshev_filter_refine_h2_ring2d)
                X = ring_fn(op.grid, H_f, X, R2w, jnp.asarray(deg_win),
                            a1e, al, be, inj, pf, cc_h2,
                            jnp.int32(int(deg_win.max())),
                            precision=f_precision)
                V = update_cols(V, X, jnp.int32(start))
                f_executed = w_pad * int(deg_win.max())
            else:
                # dispatch-folded segmented deviation recurrence on H²
                # (mirrors solver._filter_refine_windowed): each segment
                # = shrink + steps + combine + write-back in ONE program
                V, f_executed = _h2_refine_windowed(
                    H_f, V, X, R2w, deg_win, start, B, locked + u,
                    a1e, al, be, inj, pf, cc_h2, f_precision)
        elif ring_mode is not None:
            # H² filter as the ring collective matmul (P11 on the BSE
            # path): 1D software-pipelined ring or the 2D ping-pong with
            # S-flip-corrected Hᴴ steps (Hᴴ = S·H·S)
            from .parallel.ring import (chebyshev_filter_h2_ring,
                                        chebyshev_filter_h2_ring2d)
            ring_fn = (chebyshev_filter_h2_ring if ring_mode == "1d"
                       else chebyshev_filter_h2_ring2d)
            X = ring_fn(op.grid, H_f, X, jnp.asarray(deg_win),
                        np.asarray(lambda_1, op.real_dtype),
                        np.asarray(lower, op.real_dtype),
                        np.asarray(b_sup, op.real_dtype),
                        jnp.int32(int(deg_win.max())),
                        precision=f_precision)
            V = update_cols(V, X, jnp.int32(start))
            f_executed = w_pad * int(deg_win.max())
        else:
            # dispatch-folded segmented H² recurrence (_filter_windowed's
            # plan on the pseudo window; degree-0 pad columns restored
            # bit-exactly at every write-back)
            V, f_executed = _h2_filter_windowed(
                H_f, V, deg_win, start, B, locked + u, lambda_1, lower,
                b_sup, f_precision)
        if perf is not None:
            # H² = 2 matvecs per recurrence step
            perf.add_filtered_vecs(2 * int(np.sum(degrees[act])),
                                   rung=precision_rung(H_f.dtype, f_precision),
                                   low=use_refine or use_bf16 or use_low,
                                   executed=2 * f_executed)
            perf.add_iter_blocksize(u)
        t0 = toc("Filter", t0, V)
        H_f = None           # drop the local bf16-rebuild reference too
        op.drop_shadow()     # transient-shadow headroom for wide QR/RR

        # -- K-conjugation: mirror [locked, locked+u) → right of active --
        src_idx = np.arange(K2)
        wmask = np.zeros(K2, bool)
        dst = np.arange(K2 - locked - u, K2 - locked)
        src_idx[dst] = np.arange(locked, locked + u)
        wmask[dst] = True
        V = ps.k_conjugate_cols(V, jnp.asarray(src_idx), jnp.asarray(wmask))
        t0 = toc("ApplyKconjugate", t0, V)

        # -- cond estimate (squared space, algorithm.inc:2034-2060) --
        cc = (b_sup + lower) / 2
        ee = (b_sup - lower) / 2
        if ee <= 0:
            ee = abs(lower - b_sup) / 2 or 1.0
        t_1 = (lambda_1 - cc) / ee
        t_k = ((float(ritzv[locked]) ** 2 - cc) / ee) if iteration > 0 else t_1
        from .solver import _rho
        rho_1, rho_k = _rho(t_1), _rho(t_k)
        dmax = int(np.max(degrees[act]))
        with np.errstate(over="ignore"):
            cond = float(rho_k ** degrees[locked]
                         * rho_1 ** (dmax - degrees[locked]))
        if not np.isfinite(cond):
            cond = np.finfo(np.float64).max

        # -- QR (S-orthogonalizing against locked) --
        V = orthonormalize_pseudo(V, locked, cond, rcfg, op.grid,
                                  small_dense=qr_backend)
        t0 = toc("Qr", t0, V)

        # -- pseudo RR + residuals (fused) --
        # wide mode: the pencil projection runs on the slices; touching
        # op.H would re-upload the buffer engage_wide dropped
        H_wide_arg = op.H_wide if use_wide else None
        H_rr = None if use_wide else op.H
        rr_out = ps.rayleigh_ritz_residuals_pseudo(
            H_rr, V, jnp.int32(locked), precision=precision,
            small_dense=small_dense, polish=rcfg.polish_passes(),
            want_vectors=refine_capable, H_wide=H_wide_arg)
        if refine_capable:
            V, th_dev, rs_dev, R_prev, ok = rr_out
        else:
            V, th_dev, rs_dev, ok = rr_out
        if not bool(ok):
            log.warn("pseudo-RR Cholesky of QᴴSHQ failed — subspace drifted; "
                     "results this iteration may be poor", "linalg")
        ritzv[act] = np.asarray(th_dev, np.float64)[act]
        resid[act] = np.asarray(rs_dev, np.float64)[act]
        t0 = toc("Rr", t0, V)

        # -- phantom ± pair purge (reference keeps disabled; config gate) --
        if rcfg.phantom_purge:
            rv = ritzv[act]
            n_neg = int(np.sum(rv < 0))
            n_pos = u - n_neg
            reinit = []
            for kk in range(min(nex, n_neg, n_pos)):
                i, j = n_neg - 1 - kk, n_neg + kk
                la, lb = abs(rv[i]), abs(rv[j])
                ratio = lb / (la + 1e-30) if la < lb else la / (lb + 1e-30)
                if ratio > 1.5:
                    reinit += [i, j]
            if reinit:
                log.debug(f"[purge] reinitializing {len(reinit)} outlier "
                          f"± pair column(s)")
                key, sub = jax.random.split(key)
                R = jax.random.normal(sub, V.shape, dtype=op.dtype)
                wm = np.zeros(K2, bool)
                wm[locked + np.asarray(reinit)] = True
                V = jnp.where(jnp.asarray(wm)[None, :], R, V)

        if resid_file is not None:
            for _ in range(locked):
                resid_file.write(f"{iteration},-1.0\n")
            for rr_ in resid[act][np.argsort(ritzv[act], kind="stable")]:
                resid_file.write(f"{iteration},{rr_}\n")

        # -- bound refresh from sorted active Ritz values --
        srt = np.argsort(ritzv[act], kind="stable")
        q95 = max(int(u * 0.95) - 1, 0)
        new_mu_nevex = float(ritzv[act][srt[q95]]) * rcfg.decaying_rate
        new_lambda_1 = float(ritzv[act][srt[0]])

        # -- locking (v3) --
        new_converged, perm, early = locking_pseudo_v3_host(
            ritzv[act], resid[act], resid_last[act], u, nex, tol, iteration)
        early_all.extend(early)
        if new_converged:
            if not np.array_equal(perm, np.arange(u)):
                full_perm = np.arange(K2)
                full_perm[act] = locked + perm
                V = permute_cols(V, jnp.asarray(full_perm))
                if R_prev is not None:
                    R_prev = permute_cols(R_prev, jnp.asarray(full_perm))
            # mirror the newly locked pairs into the right-end locked region
            src_idx = np.arange(K2)
            wmask = np.zeros(K2, bool)
            dst = np.arange(K2 - locked - new_converged, K2 - locked)
            src_idx[dst] = np.arange(locked, locked + new_converged)
            wmask[dst] = True
            V = ps.k_conjugate_cols(V, jnp.asarray(src_idx),
                                    jnp.asarray(wmask))
        locked += new_converged
        unconverged -= new_converged
        iteration += 1
        t0 = toc("Resids_Locking", t0, V)
        log.info(f"  -> new_converged={new_converged} locked={locked}")

    if resid_file is not None:
        resid_file.close()

    # ---- final reorder: positive ascending first (algorithm.inc:2175-2216)
    n_reorder = max(locked + unconverged, 1)
    vals = ritzv[:n_reorder]
    keys = np.where(vals > 0, 0, 1)
    order = np.lexsort((vals, keys))
    if not np.array_equal(order, np.arange(n_reorder)):
        full_perm = np.arange(K2)
        full_perm[:n_reorder] = order
        V = permute_cols(V, jnp.asarray(full_perm))
        ritzv[:n_reorder] = vals[order]
        resid[:n_reorder] = resid[:n_reorder][order]

    if timing:
        V.block_until_ready()
        perf.add_time("All", time.perf_counter() - t_all0)

    return SolveResult(
        ritzv=ritzv[:nev].copy(), V=V, resid=resid[:nev].copy(),
        iterations=iteration, locked=locked,
        converged=bool(locked >= nev),
        upperb=float(b_sup), lowerb=float(lower), perf=perf,
        ritzv_full=ritzv.copy(), early_locked=early_all)
