"""Phase timers + analytic FLOP model.

JAX analogue of the reference's ``algorithm/performance.hpp``
(ChasePerfData: 8 timed phases, analytic FLOP counters at
performance.hpp:135-293, table printer at 352-451) and of the
PerformanceDecoratorChase wrapper.  Timing here is wall-clock around
``block_until_ready`` of each jitted phase; the FLOP formulas mirror the
reference's closed-form model so filter GFLOP/s numbers are comparable.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

from .types import is_complex_dtype

__all__ = ["PerfData", "PhaseTimer"]

PHASES = ("All", "InitVecs", "Lanczos", "Filter", "ApplyKconjugate",
          "Qr", "Rr", "Resids_Locking")


@dataclass
class PerfData:
    """Accumulates per-phase wall time and the analytic FLOP counters."""

    timings: Dict[str, float] = field(default_factory=lambda: {p: 0.0 for p in PHASES})
    iter_count: int = 0
    iter_blocksizes: List[int] = field(default_factory=list)
    filtered_vecs: int = 0     # sum over filter HEMM calls of columns touched
    filtered_vecs_low: int = 0  # subset filtered in a REDUCED precision (P10)
    # EXECUTED filter column-steps (window width × recurrence steps summed
    # over segments, H² steps counted twice): the static-shape windows run
    # retired/padded columns until their bucket completes, so executed ≥
    # useful (filtered_vecs) — the ratio is the structural masking waste
    # the in-solve effective rate divides by
    filtered_vecs_executed: int = 0
    # filtered_vecs by the hardware rung each filter call ran in
    # (device.precision_rung of its operator dtype and precision=)
    filtered_vecs_by_rung: Dict[str, int] = field(default_factory=dict)
    matrix_type: int = 0       # 0 = (real)symmetric/Hermitian, 1 = pseudo-Hermitian

    def add_time(self, phase: str, seconds: float):
        self.timings[phase] = self.timings.get(phase, 0.0) + seconds

    def add_iter_blocksize(self, block: int):
        self.iter_blocksizes.append(int(block))
        self.iter_count += 1

    def add_filtered_vecs(self, n: int, *, rung: str, low: bool = False,
                          executed=None):
        self.filtered_vecs += int(n)
        self.filtered_vecs_by_rung[rung] = \
            self.filtered_vecs_by_rung.get(rung, 0) + int(n)
        if low:
            self.filtered_vecs_low += int(n)
        self.filtered_vecs_executed += int(n if executed is None
                                           else executed)

    def filter_window_efficiency(self):
        """useful / executed filter column-steps (1.0 = zero masking
        waste, the reference's per-vector retirement)."""
        if self.filtered_vecs_executed <= 0:
            return None
        return self.filtered_vecs / self.filtered_vecs_executed

    def low_flop_fraction(self, N: int, lanczos_iter: int, num_lanczos: int,
                          dtype) -> float:
        """Fraction of the solve's analytic FLOPs executed in a REDUCED
        precision (the mixed-precision-ladder success metric: the DP
        north-star demands 1e-10 residuals with the bulk of FLOPs below
        f64).  Filter FLOPs are attributed by the dtype they actually ran
        in; every other phase is counted at the problem precision."""
        total = self.get_flops(N, lanczos_iter, num_lanczos, dtype)
        f = self._factor(dtype)
        low = 2.0 * f * N * float(self.filtered_vecs_low) * N / 1e9
        return low / total if total > 0 else 0.0

    # -- analytic FLOP model (performance.hpp:135-293) ---------------------
    def _factor(self, dtype) -> int:
        return 4 if is_complex_dtype(dtype) else 1

    def get_filter_flops(self, N: int, dtype) -> float:
        """GFLOPs of the filter: 2·factor·N²·filtered_vecs (+BSE flips)."""
        f = self._factor(dtype)
        flop = 2.0 * f * N * self.filtered_vecs * N
        if self.matrix_type == 1:
            flop += 2.0 * f * (N / 2) * self.filtered_vecs
        return flop / 1e9

    def get_lanczos_flops(self, N: int, lanczos_iter: int, num_lanczos: int,
                          dtype) -> float:
        f = self._factor(dtype)
        flop = lanczos_iter * 2.0 * N * num_lanczos * N
        if self.matrix_type == 1:
            flop += lanczos_iter * (N / 2) * num_lanczos
        flop += float(lanczos_iter) ** 2 * num_lanczos ** 2
        return flop * f / 1e9

    def get_flops(self, N: int, lanczos_iter: int, num_lanczos: int, dtype) -> float:
        """Total analytic GFLOPs of a solve (mirrors performance.hpp:135-231)."""
        f = self._factor(dtype)
        flop = lanczos_iter * 2.0 * N * num_lanczos * N
        if self.matrix_type == 1:
            flop += lanczos_iter * (N / 2) * num_lanczos
        flop += float(lanczos_iter) ** 2 * num_lanczos ** 2
        first_block = self.iter_blocksizes[0] if self.iter_blocksizes else 0
        for block in self.iter_blocksizes:
            # QR (cholQR2 assumed): syherk + potrf + trsm
            flop += 2.0 * N * block * block + 2.0 * block ** 3 + 2.0 * N * block * block
            if self.matrix_type == 1:
                flop += (first_block - block) * (N / 2)
            # RR: W=H·V, A=WᴴV, heevd, back-GEMM
            flop += 2.0 * N * block * N
            flop += 2.0 * block * block * N
            flop += 4.0 * block ** 3
            if self.matrix_type == 1:
                flop += 2.0 * block * (N / 2) + 2.0 * block ** 3 \
                        + 6.0 * block ** 3 + 3.0 * block * block
            flop += 2.0 * N * block * block
            # residuals: HEMM + axpy + norms
            flop += 2.0 * N * block * N + 3.0 * block * N + N * block
        # filter
        flop += 2.0 * N * self.filtered_vecs * N
        if self.matrix_type == 1:
            flop += 2.0 * self.filtered_vecs * (N / 2)
        return flop * f / 1e9

    def report(self, N: int, lanczos_iter: int, num_lanczos: int, dtype) -> str:
        gflops_all = self.get_flops(N, lanczos_iter, num_lanczos, dtype)
        gflops_filter = self.get_filter_flops(N, dtype)
        t = self.timings
        lines = [
            " | Size  | Iterations | Vecs   |  All       | Lanczos    |"
            " Filter     | QR         | RR         | Resid      |",
            f" | {N:5d} | {self.iter_count:10d} | {self.filtered_vecs:6d} |"
            f" {t['All']:.4e} | {t['Lanczos']:.4e} | {t['Filter']:.4e} |"
            f" {t['Qr']:.4e} | {t['Rr']:.4e} | {t['Resids_Locking']:.4e} |",
        ]
        if t["All"] > 0:
            lines.append(f" | GFLOPS(all) = {gflops_all / t['All']:.4e}")
        if t["Filter"] > 0:
            eff = gflops_filter / t["Filter"]
            lines.append(f" | GFLOPS(filter) = {eff:.4e}")
            mfu = self.filter_mfu(N, dtype)
            if isinstance(mfu, str):
                lines.append(f" | Filter fraction-of-peak: {mfu}")
            elif mfu is not None:
                frac, rung, peak_g = mfu
                lines.append(
                    f" | Filter fraction-of-peak = {100 * frac:.1f}% of the "
                    f"{rung} peak ({peak_g / 1e3:.0f} TFLOP/s)")
            weff = self.filter_window_efficiency()
            if weff is not None:
                lines.append(
                    f" | Filter window efficiency = {100 * weff:.1f}% "
                    f"(useful/executed column-steps; masking waste "
                    f"= {self.filtered_vecs_executed - self.filtered_vecs})")
        return "\n".join(lines)

    def filter_mfu(self, N: int, dtype):
        """(fraction, rung_name, peak_gflops) of the filter phase against
        the published peak of the rung MOST of the filter ran in, as each
        filter call recorded it (the reference prints GFLOPS,
        performance.hpp:352-451; the fraction makes effective-rate
        regressions visible in every perf table).  None when no filter
        ran; the string "peak not known for <kind>" when the device kind
        has no entry in device.PEAKS."""
        from . import device
        t = self.timings.get("Filter", 0.0)
        if t <= 0 or not self.filtered_vecs_by_rung:
            return None
        rung = max(self.filtered_vecs_by_rung,
                   key=self.filtered_vecs_by_rung.get)
        kind = device.identity()["kind"]
        peak = device.peak(rung, kind)
        if peak is None:
            return f"peak not known for {kind}"
        eff = self.get_filter_flops(N, dtype) / t      # GFLOP/s
        return eff / (peak / 1e9), rung, peak / 1e9


class profiler_trace:
    """Context manager around jax.profiler traces — the NVTX-range analogue
    (Impl/chase_gpu/nvtx.hpp SCOPED_NVTX_RANGE).  View with TensorBoard or
    xprof:

        with chase_tpu.perf.profiler_trace("/tmp/chase_trace"):
            chase_tpu.eigsh(H, nev, nex)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        import jax
        jax.profiler.start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        import jax
        jax.profiler.stop_trace()
        return False


class PhaseTimer:
    """Context manager: times a phase, synchronizing on given arrays."""

    def __init__(self, perf: "PerfData | None", phase: str, *sync):
        self.perf = perf
        self.phase = phase
        self.sync = sync
        self.t0 = 0.0

    def __enter__(self):
        if self.perf is not None:
            self.t0 = time.perf_counter()
        return self

    def done(self, *arrays):
        """Block on arrays produced by the phase, then record elapsed time."""
        if self.perf is None:
            return
        for a in arrays:
            if hasattr(a, "block_until_ready"):
                a.block_until_ready()
        self.perf.add_time(self.phase, time.perf_counter() - self.t0)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        return False
