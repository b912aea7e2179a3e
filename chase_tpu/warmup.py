"""Parallel program warmup: precompile a solve's XLA programs up front.

A cold ``eigsh`` at a new (N, nev+nex, dtype, config) pays one XLA
compilation per width-bucketed phase program, and the host driver discovers
those widths lazily (one per locking milestone) so the compilations run
SEQUENTIALLY across iterations.

Compilations for DIFFERENT programs can overlap when issued from several
threads.  ``warmup`` therefore enumerates every bucket width the solve can
visit and compiles the filter / window-QR / window-RR / full-width programs
from a thread pool, using cheap well-conditioned dummy operands
(identity-column blocks, degree-2 filters) so each compiled program also
executes once and lands in the runtime cache.

The reference has no analogue — its kernels are eagerly available; this is
an answer to XLA's compile-at-first-shape model (SURVEY §7 risk 1: bounded
program count makes exhaustive warmup FEASIBLE).

Usage::

    op = chase_tpu.DenseOperator(H)
    chase_tpu.warmup(op, nev, nex, config=cfg)   # once, parallel compiles
    res = chase_tpu.eigsh(op, nev, nex, config=cfg)   # no compile stalls

Warmup is best-effort: individual job failures are logged and skipped (the
solve then just compiles that program on first use).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .config import ChaseConfig
from .logger import get_logger
from .parallel import DenseOperator
from .ops import qr as qrops
from .ops import rr as rrops
from .ops import lanczos as lz
from . import solver as _solver
from .device import memory_bytes

__all__ = ["warmup"]


def _mem_capped_workers(max_workers: int, op, K: int, max_w: int) -> int:
    """Concurrency cap so concurrent warmup-job transients fit the device.

    Each job executes once with real operands: the filter jobs hold ~3
    carries of N×w plus a donated V copy of N×K, so 8 concurrent jobs at
    the north-star shape (N=30000, w=3000) are ~14 GB of transients on
    top of the resident operator; running out of memory there would also
    starve the solve that follows.  Budget 70% of device memory minus the
    resident operator state across however many jobs fit."""
    N = op.N
    G = 1 if op.grid is None else op.grid.nprocs
    itemsize = np.dtype(op.dtype).itemsize
    resident = (itemsize + 2) * float(N) * N / G   # problem buffer + low rung
    if getattr(op, "_H_wide", None) is not None or itemsize >= 8:
        resident = max(resident, 12.0 * float(N) * N / G)  # slices + shadow
    per_job = (3.0 * max_w + K) * N * itemsize / G
    budget = 0.7 * memory_bytes() - resident
    fit = int(budget // max(per_job, 1.0))
    return max(1, min(max_workers, fit))


def _warmup_pseudo(op, nev, nex, rcfg, max_workers):
    """Pseudo-Hermitian (BSE) phase-program warmup: H² filter width
    buckets (ring-aware), the S-aware QR, the pencil RR and the S-metric
    Lanczos.  Mirrors solver_pseudo's program set."""
    from .ops import pseudo as ps
    from .ops.blocks import slice_cols, permute_cols

    log = get_logger()
    precision = rcfg.matmul_precision
    nevex = nev + nex
    K2 = 2 * nevex
    N = op.N
    B = _solver._col_block(rcfg.col_block, nevex)
    widths = sorted({min(nevex, -(-u // B) * B)
                     for u in range(1, nevex + 1)}, reverse=True)
    V = op.place_block(jnp.eye(N, K2, dtype=op.dtype))
    ring_mode = (_solver._ring_mode(op.grid, N)
                 if rcfg.ring_filter is not False else None)

    is_sp = not rcfg.is_double
    is_cplx = np.issubdtype(np.dtype(op.dtype), np.complexfloating)
    # mirror solver_pseudo's mixed-precision ladder: the bf16 storage rung
    # (f32 problems) or the f32/c64 shadow (64-bit problems) compiles a
    # second filter program per width
    low_rung = (rcfg.bf16_filter and is_sp and not is_cplx) or \
        (rcfg.mixed_precision and not is_sp)
    refine_capable = rcfg.refine_filter and (
        (not is_sp and rcfg.mixed_precision)
        or (is_sp and rcfg.bf16_filter and not is_cplx))

    small_dense, qr_backend = _solver.resolve_small_dense(
        rcfg.small_dense_backend)
    use_wide, small_dense, qr_backend = _solver.resolve_wide(
        rcfg, op, is_sp, small_dense, qr_backend)
    if use_wide:
        op.engage_wide(drop=refine_capable)

    from .types import filter_carry_dtype as _fcd, real_dtype as _rdtf
    from .ops.blocks import update_cols

    def filter_job(w_pad, low=False):
        deg_win = np.full(w_pad, 2, np.int32)
        X = slice_cols(V, jnp.int32(0), w_pad)
        H_f = op.H_low if low else op.H
        f_precision = "default" if (low and is_sp) else precision
        if ring_mode is not None:
            from .parallel.ring import (chebyshev_filter_h2_ring,
                                        chebyshev_filter_h2_ring2d)
            fn = (chebyshev_filter_h2_ring if ring_mode == "1d"
                  else chebyshev_filter_h2_ring2d)
            out = fn(op.grid, H_f, X, jnp.asarray(deg_win), 0.5, 1.0,
                     4.0 * N * N, jnp.int32(2), precision=f_precision)
            out.block_until_ready()
            return
        # dispatch-folded kernels (h2_seg_init + h2_seg_steps) — the
        # programs solver_pseudo's non-ring filter actually runs
        crt = _rdtf(_fcd(H_f.dtype, V.dtype))
        dwin = jnp.asarray(deg_win)
        c_s = np.asarray(0.5 * (1.0 + 4.0 * N * N), crt)
        e_s = np.asarray(0.5 * (4.0 * N * N - 1.0), crt)
        sig1 = np.asarray(e_s / (np.asarray(0.5, crt) - c_s), crt)
        X0, Xp, Yc, sigma = ps.h2_seg_init(
            H_f, V, jnp.int32(0), dwin, c_s, e_s, sig1, w_pad=w_pad,
            precision=f_precision)
        out, X0, Xp, Yc, sigma = ps.h2_seg_steps(
            H_f, jnp.array(V, copy=True), X0, Xp, Yc, dwin, sigma, sig1,
            c_s, e_s,
            jnp.int32(0), jnp.int32(0), jnp.int32(2), jnp.int32(3),
            w_new=w_pad, precision=f_precision)
        out.block_until_ready()

    def refine_job(w_pad):
        from .ops import filter as filt
        deg_win = np.full(w_pad, 2, np.int32)
        ritz_win = np.full(w_pad, 0.5, np.float64)
        a1e, al, be, inj, pf = filt.refine_tables(
            ritz_win ** 2, deg_win, 0.5, 1.0, 4.0 * N * N, rcfg.max_deg)
        X = slice_cols(V, jnp.int32(0), w_pad)
        Rw = slice_cols(V, jnp.int32(0), w_pad)
        theta_win = jnp.asarray(ritz_win, op.real_dtype)
        if use_wide:
            R2w = ps.h2_residual_wide(op.H_wide, Rw, theta_win)
        else:
            R2w = ps.h2_residual(op.H, Rw, theta_win, precision=precision)
        f_precision = "default" if is_sp else precision
        if ring_mode is not None:
            from .parallel.ring import (chebyshev_filter_refine_h2_ring,
                                        chebyshev_filter_refine_h2_ring2d)
            fn = (chebyshev_filter_refine_h2_ring if ring_mode == "1d"
                  else chebyshev_filter_refine_h2_ring2d)
            out = fn(op.grid, op.H_low, X, R2w, jnp.asarray(deg_win), a1e,
                     al, be, inj, pf, 0.5 * (1.0 + 4.0 * N * N),
                     jnp.int32(2), precision=f_precision)
            out.block_until_ready()
            return
        carry = _fcd(op.H_low.dtype, V.dtype)
        crt = _rdtf(carry)
        dwin = jnp.asarray(deg_win)
        Rc = R2w.astype(carry)
        Wc = jnp.asarray(a1e, crt) * Rc
        out, X0, Wp, Wc, Rc = ps.refine_h2_seg_steps(
            op.H_low, jnp.array(V, copy=True), X, jnp.zeros_like(Rc),
            Wc, Rc, dwin,
            jnp.asarray(al, crt), jnp.asarray(be, crt),
            jnp.asarray(inj, crt), jnp.asarray(pf), jnp.asarray(0.5, crt),
            jnp.int32(0), jnp.int32(0), jnp.int32(2), jnp.int32(3),
            w_new=w_pad, precision=f_precision)
        out.block_until_ready()

    def qr_job(cond):
        # the solve passes the QR backend here (solver_pseudo.py), NOT the
        # eigh backend — under 'auto' off-CPU for f64 those differ
        # (host eigh / device CholQR) and the warmed program must match.
        # locked=0 covers the initial QR; locked>0 adds only cheap
        # gather/flip programs around the same CholQR chain.
        out = qrops.orthonormalize_pseudo(V, nevex // 2, cond, rcfg,
                                          op.grid, small_dense=qr_backend)
        out.block_until_ready()
        out = qrops.orthonormalize_pseudo(V, 0, cond, rcfg, op.grid,
                                          small_dense=qr_backend)
        out.block_until_ready()

    def rr_job():
        hw = op.H_wide if use_wide else None
        H_rr = None if use_wide else op.H
        out = ps.rayleigh_ritz_residuals_pseudo(
            H_rr, V, jnp.int32(0), precision=precision,
            small_dense=small_dense,
            polish=rcfg.polish_passes(),
            want_vectors=refine_capable, H_wide=hw)
        out[0].block_until_ready()

    def lanczos_job():
        m = max(2, min(nevex, N // 2, rcfg.lanczos_iter))
        m -= m % 2
        probes = op.place_block(
            jnp.eye(N, min(rcfg.num_lanczos, K2), dtype=op.dtype))
        H_lz = op.H_low if use_wide else op.H   # mirror solver_pseudo
        a, b, _ = ps.lanczos_scan_pseudo(H_lz, probes.astype(H_lz.dtype),
                                         m=m, precision=precision)
        b.block_until_ready()

    def aux_job():
        out = permute_cols(V, jnp.arange(K2))
        out.block_until_ready()
        src = jnp.arange(K2)
        out = ps.k_conjugate_cols(V, src, jnp.zeros(K2, bool))
        out.block_until_ready()
        # the init-vector RNG + lower-half damping programs
        # (solver_pseudo's random start, chase_cpu.hpp:310-321)
        from .ops.blocks import scale_lower_rows
        out = scale_lower_rows(
            jax.random.normal(jax.random.key(rcfg.seed), (N, K2),
                              dtype=op.dtype), 0.001)
        out.block_until_ready()

    # wide mode with the refine ladder: the H² filter never touches f64 H
    skip_f64_filter = use_wide and refine_capable
    jobs = [] if skip_f64_filter else \
        [(f"h2-filter:{w}", lambda w=w: filter_job(w)) for w in widths]
    if low_rung:
        jobs += [(f"h2-filter-low:{w}", lambda w=w: filter_job(w, low=True))
                 for w in widths]
    if refine_capable:
        jobs += [(f"h2-refine:{w}", lambda w=w: refine_job(w))
                 for w in widths]
    # all three cond-driven CholQR chains (see the hermitian warmup)
    qr_conds = (0.5 * rcfg.cholqr1_threshold, 2.0 * rcfg.cholqr1_threshold,
                10.0 * rcfg.cholqr_shift_threshold)
    jobs += [(f"pseudo-qr:c{c:.0e}", lambda c=c: qr_job(c))
             for c in qr_conds]
    jobs += [("pencil-rr", rr_job),
             ("s-lanczos", lanczos_job), ("aux", aux_job)]
    failed = 0
    max_workers = _mem_capped_workers(max_workers, op, K2,
                                      max(widths) if widths else K2)
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = {ex.submit(fn): name for name, fn in jobs}
        for fut, name in futs.items():
            try:
                fut.result()
            except Exception as e:
                failed += 1
                log.warn(f"pseudo warmup job '{name}' failed "
                         f"({type(e).__name__}): "
                         f"{str(e).splitlines()[0][:100] if str(e) else ''}",
                         "perf")
    log.info(f"pseudo warmup: {len(jobs) - failed}/{len(jobs)} programs "
             f"compiled (widths {widths}, B={B})", "perf")
    return {"programs": len(jobs), "failed": failed, "widths": widths}


def _bucket_widths(nevex: int, B: int):
    """Every w_pad the window machinery can produce: multiples of B capped
    at nevex (solver._window_pad)."""
    widths = set()
    for locked in range(0, nevex + 1):
        w_pad, _ = _solver._window_pad(nevex, locked, B)
        if w_pad > 0:
            widths.add(w_pad)
    return sorted(widths, reverse=True)


def warmup(H, nev: int, nex: Optional[int] = None, *, config=None,
           grid=None, max_workers: int = 8, fused: bool = False) -> dict:
    """Precompile the phase programs an ``eigsh`` solve will need.

    Args:
      H: the operator — a DenseOperator (reused across solves) or an (N, N)
         array (placed once here; pass the same DenseOperator to eigsh to
         amortize).
      nev, nex: the solve's block geometry (must match the later call).
      config: the ChaseConfig the solve will use (width buckets, precision
         and backend selection all follow it).
      max_workers: thread-pool width for concurrent compilations.
      fused: also precompile the one-dispatch ``eigsh_fused`` program(s):
         the cold variant and the warm-start (sequence member) variant —
         a dummy solve with an immediately-satisfied tolerance executes
         each whole program once (tol is traced, so the cached executable
         serves every later tolerance).

    Returns a dict: {"programs": n_jobs, "failed": n_failed, "widths": [...]}.
    """
    cfg = config or ChaseConfig()
    if nex is None:
        nex = max(1, int(0.4 * nev))
    if not isinstance(H, DenseOperator):
        from .api import _use_real_pair, embed_complex_operator
        if _use_real_pair(H, cfg):
            # the solve would route this complex problem through the
            # real-pair embedding — warming the native complex programs
            # would compile a set the solve never runs.  Warm the embedded
            # REAL problem instead (same shapes/shardings → the executable
            # cache serves the solve's own embedding).  For a complex BSE
            # problem pass embed_complex_operator(H, pseudo=True) yourself
            # (a raw matrix does not carry pseudo-ness).
            op = embed_complex_operator(H, grid=grid)
            return warmup(op, 2 * nev, 2 * nex, config=config, grid=grid,
                          max_workers=max_workers, fused=fused)
    op = H if isinstance(H, DenseOperator) else DenseOperator(H, grid=grid)
    rcfg = cfg.resolve(op.dtype)
    nevex = nev + nex
    N = op.N
    log = get_logger()
    precision = rcfg.matmul_precision
    is_sp = not rcfg.is_double

    if op.pseudo_hermitian:
        return _warmup_pseudo(op, nev, nex, rcfg, max_workers)

    B = _solver._col_block(rcfg.col_block, nevex)
    widths = _bucket_widths(nevex, B)
    polish = rcfg.polish_passes()

    # small_dense resolution mirroring solver.solve's auto policy
    small_dense, qr_backend = _solver.resolve_small_dense(
        rcfg.small_dense_backend)
    # ... including the wide-f64 override (one shared policy — the warmed
    # programs must match the solve's exactly)
    use_wide, small_dense, qr_backend = _solver.resolve_wide(
        rcfg, op, is_sp, small_dense, qr_backend)
    if use_wide:
        # mirror solver.solve: slice up front while the device is empty; drop
        # the device f64 buffer when the refine ladder owns the filter
        op.engage_wide(drop=rcfg.refine_filter and rcfg.mixed_precision)

    # cheap well-conditioned dummies; identity columns make every CholQR
    # Gram the identity (no rescue-path detours), and degree-2 filters
    # execute in two trips of the SAME traced-trip program a real solve
    # runs.  place_block pins the canonical V sharding — on a grid the
    # programs are sharding-specialized, so an unsharded dummy would
    # compile the WRONG programs.
    V = op.place_block(jnp.eye(N, nevex, dtype=op.dtype))
    rdt = op.real_dtype
    lam, lo, up = -1.0, 0.0, 1.0

    jobs = []

    is_cplx = np.issubdtype(np.dtype(op.dtype), np.complexfloating)
    low_rung = (rcfg.bf16_filter and is_sp and not is_cplx) or \
        (rcfg.mixed_precision and not is_sp)
    # mirror solver.solve's refine eligibility exactly
    refine_capable = rcfg.refine_filter and (
        (not is_sp and rcfg.mixed_precision)
        or (is_sp and rcfg.bf16_filter and not is_cplx))

    # ring dispatch mirrors solver.solve (auto-on for eligible grids)
    ring_mode = (_solver._ring_mode(op.grid, N)
                 if rcfg.ring_filter is not False else None)

    def filter_job(w_pad, low):
        locked = nevex - w_pad
        degrees_act = np.full(nevex - locked, 2, np.int32)
        H_f = op.H_low if low else op.H
        f_precision = "default" if (low and is_sp) else precision
        if ring_mode is not None:
            from .parallel.ring import (chebyshev_filter_ring,
                                        chebyshev_filter_ring2d)
            from .ops.blocks import slice_cols
            w_pad2, start = _solver._window_pad(nevex, locked, B)
            deg_win = np.full(w_pad2, 2, np.int32)
            ring_fn = (chebyshev_filter_ring if ring_mode == "1d"
                       else chebyshev_filter_ring2d)
            Xw = slice_cols(V, jnp.int32(start), w_pad2)
            out = ring_fn(op.grid, H_f, Xw, jnp.asarray(deg_win), lam,
                          lo, up, 2, precision=f_precision)
        else:
            # V copy: the folded segment programs DONATE their V argument
            out, _ = _solver._filter_windowed(H_f, jnp.array(V, copy=True),
                                              degrees_act, locked,
                                              nevex, B, lam, lo, up, rdt,
                                              f_precision)
        out.block_until_ready()

    def refine_job(w_pad):
        locked = nevex - w_pad
        degrees_act = np.full(nevex - locked, 2, np.int32)
        ritzv_act = np.zeros(nevex - locked, np.float64)
        # sharding-pinned dummy: the real solve's R_prev is zeros_like(V)
        # (sharded like V) and the compiled program is sharding-specialized
        R = jnp.zeros_like(V)
        f_precision = "default" if is_sp else precision
        out, _ = _solver._filter_refine_windowed(
            op.H_low, jnp.array(V, copy=True), R, ritzv_act, degrees_act,
            locked, nevex, B, lam, lo, up, rcfg.max_deg, f_precision,
            grid=op.grid, ring_mode=ring_mode)
        out.block_until_ready()

    # The solve's QR routes by runtime condition estimate to THREE distinct
    # static chains (CholQR1 / CholQR2 / shiftedCholQR2, ops/qr.py:476-481)
    # — warming only one leaves the other two compiling cold in the first
    # solve
    qr_conds = (0.5 * rcfg.cholqr1_threshold,      # → CholQR1
                2.0 * rcfg.cholqr1_threshold,      # → CholQR2
                10.0 * rcfg.cholqr_shift_threshold)  # → shiftedCholQR2

    def qr_job(w_pad, cond=10.0):
        locked = nevex - w_pad
        w_pad2, start = _solver._window_pad(nevex, locked, B)
        if rcfg.shrink_subspace and start > 0:
            out = qrops.orthonormalize_window(V, start, w_pad2, locked, cond,
                                              rcfg, op.grid,
                                              small_dense=qr_backend)
        else:
            out = qrops.orthonormalize(V, locked, cond, rcfg, op.grid,
                                       small_dense=qr_backend)
        out.block_until_ready()

    def rr_job(w_pad):
        locked = nevex - w_pad
        w_pad2, start = _solver._window_pad(nevex, locked, B)
        hw = op.H_wide if use_wide else None
        H_rr = None if use_wide else op.H
        if rcfg.shrink_subspace and start > 0:
            from .ops.blocks import slice_cols
            Vw = slice_cols(V, jnp.int32(start), w_pad2)
            out = rrops.rayleigh_ritz_residuals(
                H_rr, Vw, jnp.int32(locked - start), precision=precision,
                small_dense=small_dense, want_vectors=refine_capable,
                polish=polish, H_wide=hw)
        else:
            out = rrops.rayleigh_ritz_residuals(
                H_rr, V, jnp.int32(locked), precision=precision,
                small_dense=small_dense, want_vectors=refine_capable,
                polish=polish, H_wide=hw)
        out[0].block_until_ready()

    def lanczos_job():
        # want_basis=True matches the COLD solve's program (the DoS vector
        # extraction needs the basis); also compiles lanczos_dos_vectors
        m = max(2, min(nevex, N // 2, rcfg.lanczos_iter))
        m -= m % 2
        probes = op.place_block(
            jnp.eye(N, min(rcfg.num_lanczos, nevex), dtype=op.dtype))
        H_lz = op.H_low if use_wide else op.H   # mirror solver.solve
        a, b, basis = lz.lanczos_scan(H_lz, probes.astype(H_lz.dtype), m=m,
                                      want_basis=True, precision=precision)
        b.block_until_ready()
        ritzV = np.eye(m, dtype=np.float64)
        mask = jnp.asarray(np.arange(m) < 1)
        vd = lz.lanczos_dos_vectors(basis, jnp.asarray(ritzV), mask,
                                    precision=precision)
        vd.block_until_ready()

    # auxiliary programs the solve dispatches outside the phase kernels: the
    # hermiticity probe, the column permutes (degree sort / locking /
    # final sort — one program), and the DoS head injection.
    def aux_jobs():
        from .ops.blocks import permute_cols, set_head_cols
        if rcfg.sym_check:
            from .ops.checks import check_hermitian
            check_hermitian(op.H_low if use_wide else op.H,
                            precision=precision)
        out = permute_cols(V, jnp.arange(nevex))
        out.block_until_ready()
        m = max(2, min(nevex, N // 2, rcfg.lanczos_iter))
        m -= m % 2
        Vd = op.place_block(jnp.eye(N, m, dtype=op.dtype))
        out = set_head_cols(V, Vd, jnp.asarray(np.arange(m) < 1))
        out.block_until_ready()
        # the init-vector RNG program (solver.solve's random start)
        out = jax.random.normal(jax.random.key(rcfg.seed), (N, nevex),
                                dtype=op.dtype)
        out.block_until_ready()

    def fused_job(warm: bool):
        from .api import eigsh_fused
        v0 = np.asarray(jnp.eye(N, nevex, dtype=op.dtype)) if warm else None
        eigsh_fused(op, nev, nex, tol=float(np.finfo(np.float32).max),
                    config=cfg, v0=v0)

    # wide mode with the refine ladder: the filter NEVER touches f64 H
    # (iteration 1 runs the low rung, iterations 2+ the refine recurrence)
    # — compiling the f64 filter program would re-upload the buffer
    # engage_wide just dropped
    skip_f64_filter = (use_wide and rcfg.mixed_precision
                       and rcfg.refine_filter)
    for w in widths:
        if not skip_f64_filter:
            jobs.append((f"filter:{w}", lambda w=w: filter_job(w, False)))
        if low_rung:
            jobs.append((f"filter-low:{w}",
                         lambda w=w: filter_job(w, True)))
        if refine_capable:
            jobs.append((f"refine:{w}", lambda w=w: refine_job(w)))
        for cond in qr_conds:
            jobs.append((f"qr:{w}:c{cond:.0e}",
                         lambda w=w, cond=cond: qr_job(w, cond)))
        jobs.append((f"rr:{w}", lambda w=w: rr_job(w)))
    jobs.append(("lanczos", lanczos_job))
    jobs.append(("aux", aux_jobs))
    if fused:
        jobs.append(("fused-cold", lambda: fused_job(False)))
        jobs.append(("fused-warm", lambda: fused_job(True)))

    failed = 0
    max_workers = _mem_capped_workers(max_workers, op, nevex,
                                      max(widths) if widths else nevex)
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = {ex.submit(fn): name for name, fn in jobs}
        for fut, name in futs.items():
            try:
                fut.result()
            except Exception as e:  # best-effort: solve compiles it later
                failed += 1
                log.warn(f"warmup job '{name}' failed ({type(e).__name__}): "
                         f"{str(e).splitlines()[0][:100] if str(e) else ''}",
                         "perf")
    log.info(f"warmup: {len(jobs) - failed}/{len(jobs)} programs compiled "
             f"(widths {widths}, B={B})", "perf")
    return {"programs": len(jobs), "failed": failed, "widths": widths}
