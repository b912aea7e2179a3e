"""Chebyshev-accelerated subspace iteration driver (Hermitian path).

JAX redesign of ``algorithm/algorithm.inc:1376-1788``
(Algorithm<T>::solve): degrees → filter → QR → RR → residuals → locking
until ``unconverged ≤ nex``.  The control flow stays on host exactly like
the reference's replicated scalar driver (SURVEY §3.1: "the driver itself
is replicated scalar control flow on every rank"); device work happens in
a handful of jitted phase programs with *static* shapes:

* V is always the full N×(nev+nex) block; locked columns stay in place and
  are protected by masks (no shrinking GEMM widths — SURVEY §7 risk 1).
* The filter runs on a right-aligned window whose width is padded up to a
  multiple of ``config.col_block``; the few locked columns caught in the
  window get degree 0 (untouched).  One XLA program per width bucket.
* Per iteration exactly one small device→host transfer (ritz values +
  residuals) feeds the locking/degree decisions.

Host-side bookkeeping (calc_degrees, locking, DoS quantile) mirrors the
reference's semantics including its quirks (stable-ordering aside); column
swaps become one functional gather per iteration.
"""

from __future__ import annotations

import dataclasses
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
from .ops import filter as filt
from .ops import lanczos as lz
from .ops import qr as qrops
from .ops import rr as rrops

__all__ = ["solve", "SolveResult"]


from .ops.blocks import (
    permute_cols as _permute_cols,
    slice_cols as _slice_cols,
    update_cols as _update_cols,
    set_head_cols as _set_head_cols,
)


def resolve_small_dense(backend: str):
    """Materialize the small_dense policy: (eigh_backend, qr_backend).

    'auto' keeps both on the device (cuSOLVER on a GPU, LAPACK on the
    CPU); an explicit 'host' or 'device' applies to both phases."""
    backend = "device" if backend == "auto" else backend
    return backend, backend


def resolve_wide(rcfg, op, is_sp: bool, small_dense: str, qr_backend: str):
    """Shared wide-f64 GEMM policy (exact-slice RR/QR HEMMs, ops/wide)
    for solve() and warmup.warmup() — one definition so the warmed programs
    always match the solve's.  Returns (use_wide, small_dense, qr_backend).

    Engages only on ``wide_f64='on'`` ('auto' resolves to the native f64
    GEMM), and only for real-f64 operators: the wide kernels have no
    complex/f32 variants, so 'on' for another dtype is ignored with a log
    line rather than crashing mid-solve in engage_wide.
    """
    eligible = not is_sp and not is_complex_dtype(op.dtype)
    use_wide = eligible and rcfg.wide_f64 == "on"
    if rcfg.wide_f64 == "on" and not eligible:
        get_logger().info(
            f"wide_f64='on' ignored: operator dtype {np.dtype(op.dtype)} "
            f"is not real f64", "linalg")
    if use_wide:
        qr_backend = "wide"
        if small_dense == "device":
            small_dense = "host"     # the wide RR path pairs with host eigh
    return use_wide, small_dense, qr_backend


def _ring_mode(grid, N: int):
    """Which explicit collective-matmul filter fits this grid: '1d' for
    row-stripe meshes (p, 1), '2d' for r×c meshes with r·c | N, else None
    (GSPMD windowed filter)."""
    if grid is None:
        return None
    r = grid.shape.get("r", 1)
    c = grid.shape.get("c", 1)
    if c == 1 and r > 1 and N % r == 0:
        return "1d"
    if r > 1 and c > 1 and N % (r * c) == 0:
        return "2d"
    return None


def _col_block(cfg_block, nevex: int) -> int:
    """Filter-window bucket width.  Each distinct window width compiles its
    own XLA program, so `None` auto-sizes to a multiple of 64 that bounds a
    solve at ~8 distinct widths no matter how large nev+nex is."""
    if cfg_block is None:
        cfg_block = max(64, 64 * (-(-nevex // (8 * 64))))
    return max(1, min(int(cfg_block), nevex))


def _window_pad(nevex: int, locked: int, B: int):
    """Right-aligned active window padded up to a whole B bucket:
    returns (w_pad, start).  ONE definition shared by the filter, the
    refinement filter and the QR/RR shrink — they must agree or the
    refine filter's injected residuals desynchronize from the RR window
    that produced them."""
    w_pad = min(nevex, -(-(nevex - locked) // B) * B)
    return w_pad, nevex - w_pad


def _shrink_plan(deg_win, B, w_pad):
    """Bucket-retirement plan over a degree-ascending window: list of
    (complete_through_step, retired_left_offset) pairs, ending with
    (deg_max, w_pad).  Shared by the direct and refine segmented filters
    — the shrunken widths reuse the same B buckets, so no new XLA
    programs compile."""
    plan = []
    deg_max = int(deg_win.max())
    for p in range(B, w_pad, B):
        if deg_win[p - 1] < deg_win[p]:
            step = int(deg_win[p - 1])
            if step < 1:
                continue
            if plan and step == plan[-1][0]:
                plan[-1][1] = p
            elif not plan or step > plan[-1][0]:
                plan.append([step, p])
    plan.append([deg_max, w_pad])
    return plan


def _filter_windowed(H_f, V, degrees_act, locked, nevex, B, lam, lo, up,
                     rdt, precision):
    """Degree-retiring segmented filter (P12 true FLOP savings).

    The active columns are sorted ascending by degree (calc_degrees does
    that), so retirement happens from the left.  We run the 3-term
    recurrence on a right-aligned window and *shrink* the window whenever a
    whole ``B``-column bucket has retired — the shrunken widths hit the same
    bucket sizes as the initial windows, so no new XLA programs compile.
    Within a segment, per-column degree masks handle sub-bucket retirement
    exactly.
    """
    w_pad, start = _window_pad(nevex, locked, B)
    offset = locked - start
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[offset:] = degrees_act
    plan = _shrink_plan(deg_win, B, w_pad)

    from .types import filter_carry_dtype as _fcd, real_dtype as _rdt
    carry = _fcd(H_f.dtype, V.dtype)
    rdt = _rdt(carry)         # scalars follow the recurrence carry dtype
    lam = np.asarray(lam, rdt)
    lo_ = np.asarray(lo, rdt)
    up_ = np.asarray(up, rdt)
    c = (up_ + lo_) / 2
    e = (up_ - lo_) / 2
    sigma1 = e / (lam - c)

    # Dispatch-folded segments (ops/filter.filter_seg_*): slice + init is
    # ONE program, each (shrink + steps + masked write-back) is ONE —
    # 2-4 dispatches per iteration instead of ~12
    X0, Xp, Yc, sigma = filt.filter_seg_init(
        H_f, V, jnp.int32(start), jnp.asarray(deg_win), c, e, sigma1,
        w_pad=w_pad, precision=precision)
    executed = w_pad                      # init step runs the full window
    t_done = 1
    start0 = start             # V-column of the initial window's left edge
    pend_off = 0               # shrink offset staged for the next segment
    for (t_end, plan_off) in plan:
        if t_end > t_done:
            V, X0, Xp, Yc, sigma = filt.filter_seg_steps(
                H_f, V, X0, Xp, Yc, jnp.asarray(deg_win), sigma, sigma1,
                c, e, jnp.int32(pend_off), jnp.int32(start),
                jnp.int32(t_done + 1), jnp.int32(t_end + 1),
                w_new=w_pad, precision=precision)
            pend_off = 0
            executed += w_pad * (t_end - t_done)
            t_done = t_end
        # plan offsets are positions in the INITIAL window; convert to the
        # absolute V-column boundary, then shrink relative to the CURRENT
        # window (the window's right edge is pinned at nevex).  The shrink
        # itself is folded into the NEXT segment program (static new
        # width, traced offset).
        retire_to = start0 + plan_off
        if retire_to < nevex:
            new_w = nevex - retire_to
            new_w_pad = min(-(-new_w // B) * B, w_pad)
            new_start = nevex - new_w_pad
            off2 = new_start - start
            if off2 > 0:
                deg_win = deg_win[off2:]
                start, w_pad = new_start, new_w_pad
                pend_off += off2
    return V, executed


def _filter_windowed_unfolded(H_f, V, degrees_act, locked, nevex, B, lam,
                              lo, up, rdt, precision):
    """Multi-dispatch variant of :func:`_filter_windowed` (explicit
    slice / init / steps / write-back programs, ~12 dispatches/iteration).
    Kept behind ``config.folded_filter=False`` so the per-dispatch overhead
    stays A/B-able against the folded default.  Numerically identical
    recurrence."""
    w_pad, start = _window_pad(nevex, locked, B)
    offset = locked - start
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[offset:] = degrees_act
    plan = _shrink_plan(deg_win, B, w_pad)

    from .types import filter_carry_dtype as _fcd, real_dtype as _rdt
    carry = _fcd(H_f.dtype, V.dtype)
    rdt = _rdt(carry)
    lam = np.asarray(lam, rdt)
    lo_ = np.asarray(lo, rdt)
    up_ = np.asarray(up, rdt)
    c = (up_ + lo_) / 2
    e = (up_ - lo_) / 2
    sigma1 = e / (lam - c)

    X = _slice_cols(V, jnp.int32(start), w_pad)
    X0 = X
    dwin = jnp.asarray(deg_win)
    Xp, Yc, sigma = filt.filter_carry_init(H_f, X.astype(carry), dwin,
                                           c, e, sigma1,
                                           precision=precision)
    executed = w_pad
    t_done = 1
    start0 = start
    for (t_end, plan_off) in plan:
        if t_end > t_done:
            Xp, Yc, sigma = filt.filter_steps(
                H_f, Xp, Yc, dwin, sigma, sigma1, c, e,
                jnp.int32(t_done + 1), jnp.int32(t_end + 1),
                precision=precision)
            executed += w_pad * (t_end - t_done)
            t_done = t_end
        Yw = jnp.where(dwin[None, :] >= 1, Yc.astype(V.dtype), X0)
        V = _update_cols(V, Yw, jnp.int32(start))
        retire_to = start0 + plan_off
        if retire_to < nevex:
            new_w = nevex - retire_to
            new_w_pad = min(-(-new_w // B) * B, w_pad)
            new_start = nevex - new_w_pad
            off2 = new_start - start
            if off2 > 0:
                Xp = _slice_cols(Xp, jnp.int32(off2), new_w_pad)
                Yc = _slice_cols(Yc, jnp.int32(off2), new_w_pad)
                X0 = _slice_cols(X0, jnp.int32(off2), new_w_pad)
                deg_win = deg_win[off2:]
                dwin = jnp.asarray(deg_win)
                start, w_pad = new_start, new_w_pad
    return V, executed


def _filter_refine_windowed(H_f, V, R, ritzv_act, degrees_act, locked, nevex,
                            B, lam, lo, up, max_deg, precision,
                            grid=None, ring_mode=None):
    """Deviation-form refinement filter on the padded active window.

    Applies the SAME polynomial as _filter_windowed but factored as
    y = p(λ_j)v_j + [p(Hs) − p(λs_j)]v_j with the bracket recurrence running
    in H_f's fast dtype and seeded by the f64 RR residual vectors R — the
    mixed-precision ladder that reaches 1e-10 with the FLOPs staying low
    precision (see ops/filter.chebyshev_filter_refine).

    With ``ring_mode`` ('1d'/'2d') the recurrence's HEMMs run as the
    explicit ring collective matmul (P10 × P11 composed: grids keep the
    overlap schedule on the DP ladder).
    """
    w_pad, start = _window_pad(nevex, locked, B)
    offset = locked - start
    deg_win = np.zeros(w_pad, np.int32)
    deg_win[offset:] = degrees_act
    ritz_win = np.zeros(w_pad, np.float64)
    ritz_win[offset:] = ritzv_act
    deg_max = int(deg_win.max())
    alpha1_e, alphas, betas, inj, p_final = filt.refine_tables(
        ritz_win, deg_win, lam, lo, up, max_deg)
    X = _slice_cols(V, jnp.int32(start), w_pad)
    Rw = _slice_cols(R, jnp.int32(start), w_pad)
    cc = (up + lo) / 2.0
    if ring_mode is not None:
        from .parallel.ring import (chebyshev_filter_refine_ring,
                                    chebyshev_filter_refine_ring2d)
        ring_fn = (chebyshev_filter_refine_ring if ring_mode == "1d"
                   else chebyshev_filter_refine_ring2d)
        Y = ring_fn(grid, H_f, X, Rw, jnp.asarray(deg_win), alpha1_e,
                    alphas, betas, inj, p_final, cc, jnp.int32(deg_max),
                    precision=precision)
        return _update_cols(V, Y, jnp.int32(start)), w_pad * deg_max

    # dispatch-folded segmented deviation recurrence: same bucket plan as
    # _filter_windowed, each (shrink + steps + combine + write-back) ONE
    # program (ops/filter.refine_seg_steps)
    from .types import filter_carry_dtype as _fcd, real_dtype as _rdtf
    carry = _fcd(H_f.dtype, V.dtype)
    crt = _rdtf(carry)
    plan = _shrink_plan(deg_win, B, w_pad)
    al_d = jnp.asarray(alphas, crt)
    be_d = jnp.asarray(betas, crt)
    inj_np, pf_np = inj, p_final
    cc_d = jnp.asarray(cc, crt)
    X0, Wp, Wc, Rc = filt.refine_seg_init(
        H_f, V, R, jnp.int32(start), alpha1_e, w_pad=w_pad)
    executed = 0
    t_done = 1
    start0 = start
    pend_off = 0
    for (t_end, plan_off) in plan:
        if t_end > t_done:
            V, X0, Wp, Wc, Rc = filt.refine_seg_steps(
                H_f, V, X0, Wp, Wc, Rc, jnp.asarray(deg_win), al_d, be_d,
                jnp.asarray(inj_np, crt), jnp.asarray(pf_np), cc_d,
                jnp.int32(pend_off), jnp.int32(start),
                jnp.int32(t_done + 1), jnp.int32(t_end + 1),
                w_new=w_pad, precision=precision)
            pend_off = 0
            executed += w_pad * (t_end - t_done)
            t_done = t_end
        retire_to = start0 + plan_off
        if retire_to < nevex:
            new_w = nevex - retire_to
            new_w_pad = min(-(-new_w // B) * B, w_pad)
            new_start = nevex - new_w_pad
            off2 = new_start - start
            if off2 > 0:
                deg_win = deg_win[off2:]
                inj_np = inj_np[:, off2:]
                pf_np = pf_np[off2:]
                start, w_pad = new_start, new_w_pad
                pend_off += off2
    return V, executed


# --------------------------------------------------------------------------
# host-side algorithm bookkeeping
# --------------------------------------------------------------------------

def _rho(t: float) -> float:
    """Chebyshev ellipse radius max|t ± sqrt(t²-1)| (complex-safe)."""
    z = complex(t) ** 2 - 1.0
    s = np.sqrt(z)
    return float(max(abs(complex(t) - s), abs(complex(t) + s)))


def calc_degrees_host(unconverged, nex, upperb, lowerb, tol,
                      ritzv_a, resid_a, degrees_a, rcfg, is_sp):
    """Per-vector optimal filter degrees + sort-by-degree permutation.

    In-place on the active views; mirrors algorithm.inc:136-193.
    Returns (deg_of_last_column, perm_over_active).
    """
    c = (upperb + lowerb) / 2
    e = (upperb - lowerb) / 2
    n_opt = unconverged - nex
    max_deg = rcfg.max_deg
    for i in range(n_opt):
        t = (ritzv_a[i] - c) / e
        rho = max(abs(t - np.sqrt(abs(t * t - 1))),
                  abs(t + np.sqrt(abs(t * t - 1))))
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            val = abs(np.log(resid_a[i] / tol) / np.log(rho))
        deg = max_deg if not np.isfinite(val) else int(np.ceil(val))
        if is_sp:
            deg = max(deg, 8)
        degrees_a[i] = min(deg + rcfg.deg_extra, max_deg)
    degrees_a[n_opt:unconverged] = degrees_a[max(n_opt - 1, 0)]
    for i in range(unconverged):
        degrees_a[i] += degrees_a[i] % 2
    perm = np.argsort(degrees_a[:unconverged], kind="stable")
    degrees_a[:unconverged] = degrees_a[:unconverged][perm]
    ritzv_a[:unconverged] = ritzv_a[:unconverged][perm]
    resid_a[:unconverged] = resid_a[:unconverged][perm]
    # NOTE: residLast intentionally NOT permuted — mirrors the commented-out
    # swap at algorithm.inc:188.
    return int(degrees_a[unconverged - 1]), perm


def locking_host(ritzv_a, resid_a, resid_last_a, n_examine, tol,
                 is_sym=True):
    """Residual-based locking with early-lock of stagnating pairs.

    In-place on the active views; literal functional mirror of
    algorithm.inc:519-578 including its walk-while-swapping aliasing.
    Returns (new_converged, perm_over_active, early_locked_residuals).
    """
    w = len(ritzv_a)
    index = np.argsort(ritzv_a[:n_examine], kind="stable")
    perm = np.arange(w)
    converged = 0
    early = []
    for k in range(n_examine):
        j = int(index[k])
        rj = resid_a[j]
        stagnating = (is_sym and rj >= resid_last_a[j] and rj < 100.0 * tol)
        if rj <= tol or stagnating:
            if is_sym and rj > tol and stagnating:
                early.append(float(rj))
            if j != converged:
                for arr in (resid_a, resid_last_a, ritzv_a):
                    arr[j], arr[converged] = arr[converged], arr[j]
                perm[j], perm[converged] = perm[converged], perm[j]
            converged += 1
    return converged, perm, early


# --------------------------------------------------------------------------
# result container
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SolveResult:
    ritzv: np.ndarray          # (nev,) converged eigenvalues, ascending
    V: jax.Array               # (N, nev+nex) device block; first nev = evecs
    resid: np.ndarray          # (nev,) residual norms
    iterations: int
    locked: int
    converged: bool
    upperb: float
    lowerb: float
    perf: Optional[PerfData] = None
    ritzv_full: Optional[np.ndarray] = None   # all nev+nex Ritz values
    early_locked: Optional[list] = None


# --------------------------------------------------------------------------
# main driver
# --------------------------------------------------------------------------

def solve(op: DenseOperator, nev: int, nex: int,
          config: Optional[ChaseConfig] = None,
          V0=None, ritzv0=None, perf: Optional[PerfData] = None,
          key=None) -> SolveResult:
    """Compute the nev lowest eigenpairs of the Hermitian operator `op`.

    Args:
      op: DenseOperator (possibly grid-sharded).
      nev, nex: wanted eigenpairs / extra search directions.
      config: ChaseConfig (defaults per dtype).
      V0: optional (N, nev+nex) starting subspace.  With
          ``config.approx=True`` this is the warm start of a problem
          sequence and ``ritzv0`` must hold the previous Ritz values.
      perf: optional PerfData to fill with phase timings/FLOPs.

    Returns: SolveResult.
    """
    cfg = config or ChaseConfig()
    rcfg = cfg.resolve(op.dtype)
    log = get_logger()
    N, nevex = op.N, nev + nex
    if nevex > N:
        raise ValueError(f"nev+nex = {nevex} exceeds N = {N}")
    precision = rcfg.matmul_precision
    is_sp = not is_double_base(op.dtype)
    tol = rcfg.tol
    timing = perf is not None
    # small projected eigh: on the device unless small_dense_backend='host'
    # asks for the split-sync host LAPACK eigh (redundant heevd analogue, P8)
    small_dense, qr_backend = resolve_small_dense(rcfg.small_dense_backend)
    # exact-slice GEMM for the f64 RR/QR HEMMs (ops/wide), opt-in
    use_wide, small_dense, qr_backend = resolve_wide(
        rcfg, op, is_sp, small_dense, qr_backend)
    if use_wide:
        log.info(f"wide-f64 GEMM engaged for RR/QR (N={N}); disable with "
                 f"wide_f64='off'", "linalg")
        # Slice NOW, while device memory holds nothing but H: one donating
        # program
        # builds the bf16 slices + the f32 shadow, and — when the refine
        # ladder keeps the filter off f64 H for the whole solve — frees
        # the 8-byte buffer (operator.engage_wide)
        op.engage_wide(drop=rcfg.refine_filter and rcfg.mixed_precision)
        # Serialize the prologue on async runtimes: letting the slice
        # upload, shadow rebuild, sym-check and init-QR programs pile up
        # in flight overlaps their transients in device memory.
        jax.block_until_ready(op.H_wide[0])

    def toc(phase, t0, *arrays):
        if timing:
            for a in arrays:
                if hasattr(a, "block_until_ready"):
                    a.block_until_ready()
            perf.add_time(phase, time.perf_counter() - t0)
        return time.perf_counter()

    t_all0 = time.perf_counter()

    if rcfg.sym_check:
        from .ops.checks import check_hermitian
        # wide mode: probe the f32 shadow — a hermiticity CHECK needs only
        # f32 fidelity, and the f64 buffer may have been dropped
        H_probe = op.H_low if use_wide else op.H
        if not check_hermitian(H_probe, precision=precision):
            log.warn("input matrix failed the randomized hermiticity probe "
                     "(checkSymmetryEasy analogue) — results may be invalid")
        del H_probe
        op.drop_shadow()   # transient mode: free until the filter needs it

    # ---- initVecs (chase_cpu.hpp:296-327) --------------------------------
    t0 = time.perf_counter()
    approx = rcfg.approx and V0 is not None
    if key is None:
        key = jax.random.key(rcfg.seed)
    if V0 is not None:
        V = op.place_block(jnp.asarray(V0, op.dtype))
    else:
        V = op.place_block(jax.random.normal(key, (N, nevex), dtype=op.dtype))
    if not approx:
        if use_wide:
            # Random-basis init QR needs no f64 accuracy: a Gaussian block
            # is well-conditioned (cond ≈ (√N+√k)/(√N−√k)), Lanczos probes
            # renormalize internally, and every later phase
            # re-orthonormalizes at full precision.  f32 CholQR here skips
            # the wide GEMM's O(GB) slicing transients at full nev+nex
            # width.
            V.block_until_ready()      # serialize vs the engage uploads
            Q32, ok32 = qrops.cholqr(V.astype(jnp.float32), passes=2,
                                     precision=precision)
            if bool(ok32):
                V = Q32.astype(op.dtype)
                V.block_until_ready()
            else:
                V = qrops.orthonormalize(V, 0, 1.0, rcfg, op.grid,
                                         small_dense=qr_backend)
        else:
            V = qrops.orthonormalize(V, 0, 1.0, rcfg, op.grid,
                                     small_dense=qr_backend)
    t0 = toc("InitVecs", t0, V)

    deg0 = min(rcfg.deg + rcfg.deg % 2, rcfg.max_deg)
    degrees = np.full(nevex, deg0, dtype=np.int64)
    resid = np.full(nevex, np.finfo(np.float64).max)
    resid_last = np.full(nevex, np.finfo(np.float64).max)

    # ---- Lanczos spectral estimation (algorithm.inc:1438-1446) ------------
    m = min(nevex, N // 2, rcfg.lanczos_iter)
    m -= m % 2
    m = max(m, 2)
    numvec = min(rcfg.num_lanczos, nevex)
    if not approx:
        # wide mode: spectral-bound estimation runs on the f32 shadow
        # (bounds need ~1e-7 relative fidelity; the f64 buffer may have
        # been dropped)
        H_lz = op.H_low if use_wide else op.H
        if V0 is not None:
            # user-provided basis: probe with FRESH random vectors — a
            # Krylov space seeded with (near-)converged eigenvectors
            # breaks down immediately and the DoS bounds collapse (same
            # pathology as the approx branch below; measured on the
            # pseudo driver: 10/12 columns stalled for 25 iterations)
            probes = op.place_block(
                jax.random.normal(jax.random.fold_in(key, 1), (N, numvec),
                                  dtype=op.dtype))
        else:
            probes = V[:, :numvec]
        alphas, betas, basis = lz.lanczos_scan(
            H_lz, probes.astype(H_lz.dtype), m=m,
            precision=precision, want_basis=True)
        a_np, b_np = np.asarray(alphas, np.float64), np.asarray(betas, np.float64)
        t0 = toc("Lanczos", t0, alphas)
        theta, tau, ritzV_last = lz.lanczos_tridiag_host(a_np, b_np)
        upperb = lz.upper_bound(theta, b_np[-1])
        lam, lowerb = lz.dos_lower_bound(theta, tau, nevex, N)
        # extract DoS vectors below lowerb (algorithm.inc:1160-1189)
        theta_last = theta[-1]
        idx = 0
        for i in range(m):
            if theta_last[i] > lowerb:
                idx = i - 1
                break
        idx = max(idx, 0)
        idx = min(idx, nevex - 1)
        if V0 is not None:
            # keep the caller's warm subspace intact — no DoS injection
            idx = 0
        if idx > 0:
            mask = jnp.asarray(np.arange(m) < idx)
            Vd = lz.lanczos_dos_vectors(basis, jnp.asarray(ritzV_last),
                                        mask, precision=precision)
            V = _set_head_cols(V, Vd, mask)
        ritzv = np.empty(nevex, np.float64)
        ritzv[:idx] = theta_last[:idx]
        ritzv[idx:nevex - 1] = lam
        ritzv[nevex - 1] = lowerb
        if idx > 1:
            perm = np.arange(nevex)
            for i in range(1, idx):
                j = i * (nevex // idx)
                perm[i], perm[j] = perm[j], perm[i]
                ritzv[i], ritzv[j] = ritzv[j], ritzv[i]
            V = _permute_cols(V, jnp.asarray(perm))
        log.debug(f"Lanczos: m={m} numvec={numvec} idx={idx} "
                  f"upperb={upperb:.6e} lowerb={lowerb:.6e}")
    else:
        if ritzv0 is None:
            raise ValueError("approx mode needs ritzv0 from a previous solve")
        # Bounds-only Lanczos from a FRESH random probe.  The reference
        # starts from the user's approximate eigenvector
        # (cpu/lanczos.hpp:227-252) — but a Krylov space seeded with a
        # converged eigenvector of the *previous* problem barely explores
        # the drifted spectrum and underestimates lambda_max, and a filter
        # interval that misses the true spectral top AMPLIFIES the
        # unwanted end (Chebyshev grows outside [lowerb, upperb]).
        # Observed: divergence after a few warm-started sequence members.
        probe = op.place_block(
            jax.random.normal(jax.random.fold_in(key, 1), (N, 1),
                              dtype=op.dtype))
        H_lz = op.H_low if use_wide else op.H
        alphas, betas, _ = lz.lanczos_scan(
            H_lz, probe.astype(H_lz.dtype), m=m, precision=precision,
            want_basis=False)
        a_np, b_np = np.asarray(alphas, np.float64), np.asarray(betas, np.float64)
        t0 = toc("Lanczos", t0, alphas)
        theta, _, _ = lz.lanczos_tridiag_host(a_np, b_np, want_vectors=False)
        upperb = lz.upper_bound(theta, b_np[-1])
        ritzv = np.asarray(ritzv0, np.float64).copy()
    # Release the Lanczos locals: on memory-tight transient-shadow wide
    # solves the H_lz reference alone pins the 4·N² f32 shadow through
    # every later QR/RR; basis is another m·numvec·N block.
    H_lz = basis = probes = probe = Vd = None
    op.drop_shadow()

    # sign-aware scaling (reference applies this in the pseudo path,
    # algorithm.inc:1920-1927; extended to the Hermitian driver here):
    # scaling must push a negative upperb toward zero-crossing correctly
    upperb = upperb * rcfg.upperb_scale if upperb > 0 \
        else upperb / rcfg.upperb_scale

    lowerb = float(np.max(ritzv)) * rcfg.decaying_rate
    lam_filter = float(np.min(ritzv))

    locked = 0
    unconverged = nevex
    iteration = 0
    early_all: list = []

    # Deviation-form refinement eligibility (the mixed-precision ladder):
    # DP problems with mixed_precision keep the filter FLOPs in f32/c64
    # forever; f32 problems with the bf16 rung keep them in bf16.  Needs
    # Ritz values + residual vectors, so it engages from iteration 1.
    refine_capable = rcfg.refine_filter and (
        (not is_sp and rcfg.mixed_precision)
        or (is_sp and rcfg.bf16_filter and not is_complex_dtype(op.dtype)))
    R_prev = None              # (N, nevex) RR residual vectors, problem dtype

    # ring_filter None = auto: engage whenever the grid admits a schedule
    # (overlap-by-default like the reference's nccl hemm); True = explicit
    # request (warn if it cannot engage); False = opt out
    ring_req = rcfg.ring_filter is not False
    ring_mode_cfg = _ring_mode(op.grid, N) if ring_req else None
    if rcfg.ring_filter is True and op.grid is not None \
            and ring_mode_cfg is None:
        log.warn(f"ring_filter requested but no ring schedule fits this "
                 f"grid (shape {op.grid.shape}, N={N}) — falling back "
                 f"to the GSPMD windowed filter", "linalg")
    elif ring_mode_cfg is not None and rcfg.ring_filter is None:
        log.info(f"ring filter auto-enabled ({ring_mode_cfg} schedule, grid "
                 f"{op.grid.shape}); opt out with ring_filter=False",
                 "linalg")
    resid_file = None
    if rcfg.save_residuals:
        # per-iteration residual history CSV (CHASE_SAVE_RESIDUALS,
        # algorithm.inc:1467-1488): locked slots logged as -1.0
        resid_file = open(rcfg.save_residuals, "w")
        resid_file.write("iteration,residual\n")

    # ---- main loop (algorithm.inc:1491-1722) ------------------------------
    while unconverged > nex and iteration < rcfg.max_iter:
        act = slice(locked, nevex)

        # lowerb refresh once everything is somewhat converged (isSym branch)
        if np.all(resid[act] <= 0.5):
            lowerb = float(ritzv[nevex - 1])
        log.info(f"iteration {iteration}: lambda={lam_filter:.6e} "
                 f"lowerb={lowerb:.6e} upperb={upperb:.6e} "
                 f"unconverged={unconverged}")
        if lowerb > upperb:
            log.warn("lowerb > upperb — clamping (algorithm.inc:1524)")
            lowerb = upperb

        resid_last[act] = np.minimum(resid_last[act], resid[act])

        # -- degrees (algorithm.inc:1540) --
        if rcfg.optimization and iteration != 0:
            _, perm = calc_degrees_host(
                unconverged, nex, upperb, lowerb, tol,
                ritzv[act], resid[act], degrees[act], rcfg, is_sp)
            if not np.array_equal(perm, np.arange(unconverged)):
                full_perm = np.concatenate(
                    [np.arange(locked), locked + perm])
                V = _permute_cols(V, jnp.asarray(full_perm))
                if R_prev is not None:
                    R_prev = _permute_cols(R_prev, jnp.asarray(full_perm))

        # -- filter (algorithm.inc:1546) --
        B = _col_block(rcfg.col_block, nevex)
        # Mixed-precision ladder (P10): while the active block is far from
        # converged, run the filter in reduced precision.  64-bit problems
        # drop to f32/c64 (the reference's DP→SP switch); 32-bit problems
        # drop from 'highest' (full f32) to 'high' (TF32 on the H100).
        min_resid = (float(np.min(resid[locked:nev])) if locked < nev
                     else 0.0)
        use_low = (rcfg.mixed_precision and locked < nev
                   and min_resid > rcfg.mixed_precision_threshold)
        # bf16 storage rung (f32 problems only; complex has no bf16 pair):
        # far-from-converged iterations take bf16 matmul inputs with f32
        # accumulation, the carry staying f32 (ops/filter._hemm_shift).
        # gate on the spectral-radius MAGNITUDE: a signed upperb (negative-
        # definite spectrum) would make the RHS negative and the rung would
        # never disengage
        spec_scale = max(abs(lam_filter), abs(upperb))
        use_bf16 = (rcfg.bf16_filter and is_sp and locked < nev
                    and not is_complex_dtype(op.dtype)
                    and min_resid > rcfg.bf16_filter_threshold * spec_scale)
        use_refine = refine_capable and R_prev is not None
        # select H_f lazily: touching op.H when this iteration's filter
        # doesn't need f64 would re-upload the buffer engage_wide dropped
        f_precision = precision
        if use_refine:
            # deviation-form ladder: fast-dtype recurrence, f64-residual
            # injection — no threshold, never hands back to the slow dtype.
            # H_filter = H_low (f32) normally; the bf16 transient rebuild
            # on memory-tight large-N wide solves (operator.H_filter).
            use_low = use_bf16 = False
            H_f = op.H_filter if use_wide else op.H_low
            f_precision = "default" if is_sp else precision
        elif use_bf16:
            H_f = op.H_low           # bf16 shadow of the f32 operator
            f_precision = "default"
        elif use_low:
            if is_sp:
                H_f = op.H
                f_precision = "high"
            else:
                # transient-shadow wide solves run the classic low phase
                # on the bf16 rebuild too (iteration 0 needs only coarse
                # filtering; carry stays f32 — types.filter_carry_dtype)
                H_f = op.H_filter if use_wide else op.H_low
                if use_wide:
                    f_precision = "default"
        else:
            H_f = op.H
        ring_mode = ring_mode_cfg
        if use_refine:
            V, f_executed = _filter_refine_windowed(
                H_f, V, R_prev, ritzv[act], degrees[act], locked, nevex, B,
                lam_filter, lowerb, upperb, rcfg.max_deg, f_precision,
                grid=op.grid, ring_mode=ring_mode)
        elif ring_mode is not None:
            # explicit collective-matmul filter (P11): V chunks circulate
            # the ring overlapped with the local dots.  1D row-stripe
            # meshes use the single-axis ring; near-square 2D meshes the
            # ping-pong A/B-parity schedule (P4).  Runs on the padded
            # right-aligned window (P12 bucket savings survive
            # distribution); per-column degree masks handle sub-bucket
            # retirement inside the window.  Mixed-precision H shadows are
            # supported (the carry follows filter_carry_dtype).
            from .parallel.ring import (chebyshev_filter_ring,
                                        chebyshev_filter_ring2d)
            w_pad_f, start_f = _window_pad(nevex, locked, B)
            deg_win = np.zeros(w_pad_f, np.int32)
            deg_win[locked - start_f:] = degrees[act]
            ring_fn = (chebyshev_filter_ring if ring_mode == "1d"
                       else chebyshev_filter_ring2d)
            Xw = _slice_cols(V, jnp.int32(start_f), w_pad_f)
            Yw = ring_fn(
                op.grid, H_f, Xw, jnp.asarray(deg_win), lam_filter,
                lowerb, upperb, int(deg_win.max()), precision=f_precision)
            V = _update_cols(V, Yw, jnp.int32(start_f))
            f_executed = w_pad_f * int(deg_win.max())
        else:
            filter_fn = (_filter_windowed if rcfg.folded_filter
                         else _filter_windowed_unfolded)
            V, f_executed = filter_fn(
                H_f, V, degrees[act], locked, nevex, B, lam_filter, lowerb,
                upperb, op.real_dtype, f_precision)
        if perf is not None:
            perf.add_filtered_vecs(int(np.sum(degrees[act])),
                                   rung=precision_rung(H_f.dtype, f_precision),
                                   low=use_refine or use_bf16 or use_low,
                                   executed=f_executed)
            perf.add_iter_blocksize(unconverged)
        t0 = toc("Filter", t0, V)
        # transient-shadow mode (large-N wide): free the f32 shadow AND the
        # local H_f reference (it pins the 2·N² bf16 rebuild otherwise) so
        # the wide QR/RR slicing transients have device-memory headroom; next
        # iteration's filter rebuilds from the slice stack
        H_f = None
        op.drop_shadow()

        # -- condition estimate for QR selection (algorithm.inc:1549-1565) --
        cc = (upperb + lowerb) / 2
        ee = (upperb - lowerb) / 2
        rho_1 = _rho((float(ritzv[0]) - cc) / ee)
        rho_k = _rho((float(ritzv[locked]) - cc) / ee)
        with np.errstate(over="ignore"):
            cond = float(rho_k ** degrees[locked]
                         * rho_1 ** (int(np.max(degrees[act]))
                                     - degrees[locked]))
        if not np.isfinite(cond):
            cond = np.finfo(np.float64).max

        # -- QR + RR, shrunk to the padded active window once columns lock
        # (reference shrinks every post-filter phase, algorithm.inc:1712-18;
        # window widths reuse the filter's B buckets → bounded programs) --
        w_pad_rr, win_start = _window_pad(nevex, locked, B)
        use_window = rcfg.shrink_subspace and win_start > 0

        if use_window:
            V = qrops.orthonormalize_window(V, win_start, w_pad_rr, locked,
                                            cond, rcfg, op.grid,
                                            small_dense=qr_backend)
        else:
            V = qrops.orthonormalize(V, locked, cond, rcfg, op.grid,
                                     small_dense=qr_backend)
        t0 = toc("Qr", t0, V)

        # -- RR + residuals (fused) --
        # wide mode: RR runs entirely on the slices; passing op.H would
        # re-upload the f64 buffer engage_wide just freed
        H_wide_arg = op.H_wide if use_wide else None
        H_rr = None if use_wide else op.H
        if use_window:
            Vw = _slice_cols(V, jnp.int32(win_start), w_pad_rr)
            rr_out = rrops.rayleigh_ritz_residuals(
                H_rr, Vw, jnp.int32(locked - win_start), precision=precision,
                small_dense=small_dense, want_vectors=refine_capable,
                polish=rcfg.polish_passes(), H_wide=H_wide_arg)
            if refine_capable:
                Vw, ritz_dev, resid_dev, Rw = rr_out
                if R_prev is None:
                    R_prev = jnp.zeros_like(V)
                R_prev = _update_cols(R_prev, Rw, jnp.int32(win_start))
            else:
                Vw, ritz_dev, resid_dev = rr_out
            V = _update_cols(V, Vw, jnp.int32(win_start))
            lw = locked - win_start
            ritzv[act] = np.asarray(ritz_dev, np.float64)[lw:]
            resid[act] = np.asarray(resid_dev, np.float64)[lw:]
        else:
            rr_out = rrops.rayleigh_ritz_residuals(
                H_rr, V, jnp.int32(locked), precision=precision,
                small_dense=small_dense, want_vectors=refine_capable,
                polish=rcfg.polish_passes(), H_wide=H_wide_arg)
            if refine_capable:
                V, ritz_dev, resid_dev, R_prev = rr_out
            else:
                V, ritz_dev, resid_dev = rr_out
            ritzv[act] = np.asarray(ritz_dev, np.float64)[act]
            resid[act] = np.asarray(resid_dev, np.float64)[act]
        t0 = toc("Rr", t0, V)

        if resid_file is not None:
            for _ in range(locked):
                resid_file.write(f"{iteration},-1.0\n")
            for rr_ in resid[act][np.argsort(ritzv[act], kind="stable")]:
                resid_file.write(f"{iteration},{rr_}\n")

        # -- locking (algorithm.inc:1692-1718) --
        n_examine = unconverged - nex
        new_converged, perm, early = locking_host(
            ritzv[act], resid[act], resid_last[act], n_examine, tol,
            is_sym=True)
        early_all.extend(early)
        if new_converged and not np.array_equal(perm, np.arange(unconverged)):
            full_perm = np.concatenate([np.arange(locked), locked + perm])
            V = _permute_cols(V, jnp.asarray(full_perm))
            if R_prev is not None:
                R_prev = _permute_cols(R_prev, jnp.asarray(full_perm))
        locked += new_converged
        unconverged -= new_converged
        iteration += 1
        t0 = toc("Resids_Locking", t0, V)
        log.info(f"  -> new_converged={new_converged} locked={locked}")

    if resid_file is not None:
        resid_file.close()

    # ---- final eigenvalue sort (algorithm.inc:1726-1774) -------------------
    order = np.argsort(ritzv[:nev], kind="stable")
    if not np.array_equal(order, np.arange(nev)):
        full_perm = np.concatenate([order, np.arange(nev, nevex)])
        V = _permute_cols(V, jnp.asarray(full_perm))
        ritzv[:nev] = ritzv[order]
        resid[:nev] = resid[order]

    if timing:
        V.block_until_ready()
        perf.add_time("All", time.perf_counter() - t_all0)

    return SolveResult(
        ritzv=ritzv[:nev].copy(), V=V, resid=resid[:nev].copy(),
        iterations=iteration, locked=locked,
        converged=bool(unconverged <= nex),
        upperb=float(upperb), lowerb=float(lowerb), perf=perf,
        ritzv_full=ritzv.copy(), early_locked=early_all)
