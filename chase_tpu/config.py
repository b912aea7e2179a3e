"""Solver configuration.

JAX analogue of ``algorithm/configuration.hpp`` (ChaseConfig<T>) plus
the runtime env-var knobs scattered through the reference
(CHASE_DISABLE_CHOLQR, CHASE_CHOLQR1_THLD, ... — see SURVEY §5 "Config").
Defaults follow configuration.hpp:174-188 and the type-dispatched tables at
configuration.hpp:34-129.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from . import types as _t

__all__ = ["ChaseConfig"]


def _env_int(name: str, default):
    v = os.environ.get(name)
    return default if v is None else int(v)


def _env_float(name: str, default):
    v = os.environ.get(name)
    return default if v is None else float(v)


@dataclasses.dataclass
class ChaseConfig:
    """All tunables of the solver.

    Geometry (N, nev, nex) lives at the call site (`eigsh`), not here —
    unlike the reference's ChaseConfig(N, nev, nex) — so one config object
    can drive a whole sequence of problems.
    """

    # --- convergence -----------------------------------------------------
    tol: Optional[float] = None          # default: 1e-10 DP / 1e-5 SP per dtype
    max_iter: int = 25                   # configuration.hpp:177

    # --- Chebyshev filter ------------------------------------------------
    deg: Optional[int] = None            # initial degree (20 DP / 10 SP)
    max_deg: Optional[int] = None        # degree cap (36 DP / 18 SP)
    deg_extra: int = 2                   # configuration.hpp:176
    optimization: bool = True            # per-vector degree optimization ('S' mode)
    # SP filter inside a DP solve (P10, the reference's DP->SP switch).
    # None (default) resolves to off: every supported platform has native
    # f64 GEMMs, so a DP solve runs its filter in f64.  True engages the
    # ladder (f32 filter, then the deviation-form refinement once Ritz
    # values exist); env CHASE_MIXED_PRECISION=0/1 overrides.
    mixed_precision: Optional[bool] = None
    mixed_precision_threshold: float = 1e-3  # chase_cpu.hpp:395 resid cutoff
    # bf16 storage rung for f32 problems: while the active block's residual
    # exceeds bf16_filter_threshold * upperb (i.e. relative to the spectral
    # radius estimate; the bf16 basis-quality floor sits at ~eps_bf16 =
    # 0.8e-2 relative), the filter HEMM takes bf16 inputs with f32
    # accumulation (the recurrence carry stays f32).  One rung below the
    # reference's DP->SP switch; env CHASE_BF16_FILTER=1 enables it.
    bf16_filter: bool = False
    bf16_filter_threshold: float = 1e-2
    # Deviation-form refinement filter (the DP-tolerance ladder): once Ritz
    # values + residual vectors exist (iteration >= 1), the reduced-precision
    # filter runs on the deviation w = p(Hs)v - p(λs)v with the f64 residual
    # injected (ops/filter.chebyshev_filter_refine).  Noise then scales with
    # the CURRENT ERROR, not eps_low·||H||, so a mixed-precision solve reaches
    # the full 1e-10 DP tolerance with the filter FLOPs staying in f32/bf16 —
    # the reference instead switches the filter back to DP below resid 1e-3
    # (chase_cpu.hpp:384-447).  Engages with mixed_precision (DP problems)
    # or bf16_filter (f32 problems); env CHASE_REFINE_FILTER=0 disables.
    refine_filter: bool = True
    # Ogita-Aishima eigenvector polish passes for the in-graph projected
    # eigensolve (ops/rr.eigh_polished).  None = 0: the device eigensolver
    # is LAPACK-quality on every supported platform (see
    # ResolvedConfig.polish_passes); the polish is for eigensolvers with an
    # eigenvector-residual floor.  Env CHASE_EIGH_POLISH forces a value.
    eigh_polish: Optional[int] = None

    # --- spectral estimator ----------------------------------------------
    lanczos_iter: Optional[int] = None   # 25 DP / 12 SP
    num_lanczos: int = 4                 # stochastic probe vectors
    decaying_rate: float = 1.0           # lowerb scale (configuration.hpp:178)
    upperb_scale: float = 1.0

    # --- orthogonalization -------------------------------------------------
    cholqr: bool = True                  # False => Householder QR always
    cholqr1_threshold: Optional[float] = None  # cond below which CholQR1 is enough
    qr_hi_prec: bool = True              # QR in wider dtype for SP problems
                                         # (QR_DOUBLE_PRECISION analogue)
    # post-QR orthogonality validation (reference CHASE_QR_CHECK_ORTHO,
    # nccl/householder_qr.hpp:292): computes ||Q^H Q - I||_max after every
    # orthonormalization and warns past 100x the dtype eps.  Debug aid.
    qr_check_ortho: bool = False
    # N above which the unshifted CholQR variants switch to the panelized
    # Gram-Schmidt CholQR (reference MINIMAL_N_INVOKE_MODIFIED_GRAM_
    # SCHMIDT_QR = 100000, Impl/config/config.hpp:9)
    mgs_qr_min_n: int = 100_000

    # --- warm start / sequences -------------------------------------------
    approx: bool = False                 # mode='A': reuse caller's V as subspace

    # --- misc ---------------------------------------------------------------
    cluster_aware_degrees: bool = True   # pseudo-Hermitian degree clustering
    sym_check: bool = True               # randomized (pseudo-)hermiticity probe
    seed: int = 1337                     # RNG seed for initVecs (reference: mt19937(1337))
    # per-iteration residual history CSV (CHASE_SAVE_RESIDUALS analogue);
    # env var overrides, value is the output path
    save_residuals: Optional[str] = None
    # pseudo: reinit outlier ± pairs (reference keeps this disabled at the
    # call site, algorithm.inc:2081)
    phantom_purge: bool = False

    # --- compilation and dispatch ----------------------------------------
    # Column-width bucket for the filter window: active widths are padded up
    # to a multiple of this so XLA sees few distinct shapes (SURVEY §7
    # risk 1).  None (default) = auto: multiples of 64 sized so a solve
    # compiles at most ~8 distinct filter widths regardless of nev+nex.
    col_block: Optional[int] = None
    # Dispatch-folded segmented filter (ops/filter.filter_seg_*): window
    # slice + init step run as ONE XLA program and each (shrink + steps +
    # masked write-back) as one — 2-4 dispatches/iteration instead of ~12.
    # False keeps the multi-dispatch path for A/B runs.  Env
    # CHASE_FOLDED_FILTER=0/1 overrides.
    folded_filter: bool = True
    # matmul precision for f32 inputs: "highest" keeps full f32 arithmetic
    # (on the H100 "high" and "default" both run TF32 — device.py).
    matmul_precision: str = "highest"
    # Where the small dense eigensolve (RR) / cholesky runs: "auto"
    # (default) | "device" | "host".  auto = device on every supported
    # platform; "host" round-trips the k x k problem to host LAPACK in f64
    # (split-sync, the reference's RR_DOUBLE_PRECISION analogue).
    small_dense_backend: str = "auto"
    # Shrink QR/RR/residuals to the padded active window as columns lock
    # (the reference shrinks every post-filter phase to the unconverged
    # block, algorithm.inc:1712-1718).  Window widths reuse the filter's
    # col_block buckets so XLA compiles a bounded set of programs.
    shrink_subspace: bool = True
    # Explicit ring collective-matmul filter (P11): overlaps V-chunk
    # transfers with local dots instead of GSPMD's all-gather-then-dot
    # lowering ('1d' ring on (p, 1) meshes, 2D ping-pong on r×c meshes with
    # r·c | N).  None (default) = AUTO: on whenever the grid shape admits a
    # ring schedule (semantics identical either way; the reference does not
    # make users opt into overlap — nccl/hemm.hpp:95-266).  True forces the
    # request (warns if no schedule fits); False opts out
    # (CHASE_RING_FILTER=0/1 overrides).
    ring_filter: Optional[bool] = None
    # Exact-slice GEMM for the f64 RR/QR HEMMs (ops/wide, Ozaki scheme):
    # "auto" (default) resolves to the native f64 GEMM; "on" routes the
    # N-contraction f64 HEMMs of real f64 solves through int8/bf16 slices;
    # "off" is native.
    wide_f64: str = "auto"
    # Static phase-window tiers inside the fused (one-dispatch) solver:
    # the while-loop body branches over up to this many right-aligned
    # window widths so filter/QR/RR shrink as columns lock (the in-graph
    # P12 — fused._tier_offsets).  1 = the classic full-width body; more
    # tiers trade compile time (every tier compiles its own phase
    # programs) for late-iteration FLOPs.  Env CHASE_FUSED_TIERS overrides.
    fused_tiers: int = 3
    # Complex problems: "auto" (default) and "native" keep complex dtypes
    # end to end; "real_pair" solves the real symplectic embedding
    # J = [[Hr,-Hi],[Hi,Hr]] with purely real arithmetic (ops/realpair.py),
    # which also opens the bf16 rung to complex problems.
    complex_backend: str = "auto"

    def resolve(self, dtype) -> "ResolvedConfig":
        """Bind dtype-dependent defaults and env overrides."""
        tol = self.tol if self.tol is not None else _t.default_tol(dtype)
        deg = self.deg if self.deg is not None else _t.default_deg(dtype)
        max_deg = self.max_deg if self.max_deg is not None else _t.default_max_deg(dtype)
        lanczos_iter = (self.lanczos_iter if self.lanczos_iter is not None
                        else _t.default_lanczos_iter(dtype))
        cholqr = self.cholqr
        if os.environ.get("CHASE_DISABLE_CHOLQR"):
            cholqr = not bool(int(os.environ["CHASE_DISABLE_CHOLQR"]))
        is_dp = _t.is_double_base(dtype)
        chol1_thld = self.cholqr1_threshold
        if chol1_thld is None:
            chol1_thld = 2e1 if is_dp else 1e1   # chase_cpu.hpp:668-671
        chol1_thld = _env_float("CHASE_CHOLQR1_THLD", chol1_thld)
        chol_upper = 1e8 if is_dp else 1e4       # shiftedCholQR2 threshold
        save_residuals = os.environ.get("CHASE_SAVE_RESIDUALS",
                                        self.save_residuals)
        bf16_filter = self.bf16_filter
        if os.environ.get("CHASE_BF16_FILTER"):
            bf16_filter = bool(int(os.environ["CHASE_BF16_FILTER"]))
        mixed_precision = self.mixed_precision
        if os.environ.get("CHASE_MIXED_PRECISION"):
            mixed_precision = bool(int(os.environ["CHASE_MIXED_PRECISION"]))
        if mixed_precision is None:
            mixed_precision = False      # auto: native f64 on cpu and gpu
        refine_filter = self.refine_filter
        if os.environ.get("CHASE_REFINE_FILTER"):
            refine_filter = bool(int(os.environ["CHASE_REFINE_FILTER"]))
        qr_check_ortho = self.qr_check_ortho
        if os.environ.get("CHASE_QR_CHECK_ORTHO"):
            qr_check_ortho = bool(int(os.environ["CHASE_QR_CHECK_ORTHO"]))
        eigh_polish = self.eigh_polish
        if os.environ.get("CHASE_EIGH_POLISH"):
            eigh_polish = int(os.environ["CHASE_EIGH_POLISH"])
        ring_filter = self.ring_filter
        if os.environ.get("CHASE_RING_FILTER"):
            ring_filter = bool(int(os.environ["CHASE_RING_FILTER"]))
        fused_tiers = _env_int("CHASE_FUSED_TIERS", self.fused_tiers)
        folded_filter = self.folded_filter
        if os.environ.get("CHASE_FOLDED_FILTER"):
            folded_filter = bool(int(os.environ["CHASE_FOLDED_FILTER"]))
        return ResolvedConfig(
            base=self, tol=float(tol), deg=int(deg), max_deg=int(max_deg),
            lanczos_iter=int(lanczos_iter), cholqr=cholqr,
            cholqr1_threshold=float(chol1_thld),
            cholqr_shift_threshold=float(chol_upper),
            save_residuals=save_residuals,
            bf16_filter=bf16_filter,
            mixed_precision=mixed_precision,
            refine_filter=refine_filter,
            qr_check_ortho=qr_check_ortho,
            eigh_polish=eigh_polish,
            ring_filter=ring_filter,
            fused_tiers=int(fused_tiers),
            folded_filter=folded_filter,
            is_double=is_dp,
        )


@dataclasses.dataclass
class ResolvedConfig:
    """ChaseConfig with dtype-dependent defaults materialized."""
    base: ChaseConfig
    tol: float
    deg: int
    max_deg: int
    lanczos_iter: int
    cholqr: bool
    cholqr1_threshold: float
    cholqr_shift_threshold: float
    save_residuals: Optional[str] = None
    bf16_filter: bool = False
    mixed_precision: bool = False        # resolved (None = auto in the base)
    refine_filter: bool = True
    qr_check_ortho: bool = False
    eigh_polish: Optional[int] = None    # None = no polish (polish_passes)
    ring_filter: Optional[bool] = None   # None = auto (on for eligible grids)
    fused_tiers: int = 3                 # static phase-window tiers (fused)
    folded_filter: bool = True           # dispatch-folded segment programs
    is_double: bool = True               # problem base precision (resolve())

    def __getattr__(self, name):
        return getattr(self.base, name)

    def polish_passes(self) -> int:
        """Eigh-polish passes; 0 unless eigh_polish / CHASE_EIGH_POLISH
        force a value.  LAPACK (CPU) and cuSOLVER (GPU) eigensolvers already
        return eigenvectors at working precision; on top of them the polish
        only adds the pinned-slot noise of the projected matrix to the
        Ritz vectors (orthogonality 1e-15 -> 1e-12 at N=3000 f64)."""
        if self.eigh_polish is not None:
            return int(self.eigh_polish)
        return 0
