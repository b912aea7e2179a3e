"""Smoke test of the solvers on the GPU, checked against host numpy.

    python chip_smoke.py             # phases a-f on one GPU
    python chip_smoke.py --chips 4   # the 2x2-grid path on four GPUs only

Drives the public entry points (eigsh, eigsh_fused, eigsh_pseudo,
eigsh_sequence) at the problem sizes users run, in one process, and checks
every result against host f64 numpy: the exact spectrum where one is known,
otherwise numpy's eigensolver, plus the true residual ‖Hv − λv‖₂ and the
orthogonality of the eigenvectors.  Prints one JSON line per phase; the last
line is {"ok": true, "device": {...}} only when every phase passed.  Exits
non-zero, without that line, when JAX finds no GPU or any check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


# -- checks against the plain host reference --------------------------------

def spread_columns(n: int, count: int) -> np.ndarray:
    """``count`` column indices spread evenly over [0, n)."""
    return np.unique(np.linspace(0, n - 1, min(count, n)).round().astype(int))


def max_residual(H, V, lam, cols) -> float:
    """max over ``cols`` of the host f64 residual ‖H v_j − λ_j v_j‖₂."""
    Vc = np.asarray(V)[:, cols].astype(np.complex128
                                       if np.iscomplexobj(V) else np.float64)
    lam = np.asarray(lam, np.float64)[cols]
    R = H @ Vc - Vc * lam[None, :]
    return float(np.linalg.norm(R, axis=0).max())


def orth_error(V) -> float:
    """max |VᴴV − I| in host f64."""
    V = np.asarray(V)
    V = V.astype(np.complex128 if np.iscomplexobj(V) else np.float64)
    return float(np.abs(V.conj().T @ V - np.eye(V.shape[1])).max())


def eig_error(got, exact) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(exact, np.float64)).max())


def max_memory_share(peaks) -> float:
    """Largest one device's share of the summed peak memory."""
    peaks = np.asarray(peaks, np.float64)
    return float(peaks.max() / peaks.sum())


def scaled_clement(N: int, dtype) -> np.ndarray:
    """Clement matrix scaled by 1/(N-1) (spectrum in [-1, 1]), in place."""
    from chase_tpu.models import clement
    H = clement(N, dtype=dtype)
    H *= dtype(1.0 / (N - 1))
    return H


def clement_exact(N: int, nev: int) -> np.ndarray:
    from chase_tpu.models import clement_eigenvalues
    return clement_eigenvalues(N)[:nev] / (N - 1)


# -- reporting ----------------------------------------------------------------

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peak_bytes(devices) -> list:
    return [int(d.memory_stats()["peak_bytes_in_use"]) for d in devices]


class Phase:
    """Times one entry-point call and collects its checks."""

    def __init__(self, name: str, precision: str = "highest"):
        self.name = name
        self.precision = precision
        self.checks = {}
        self.extra = {}
        self.t0 = time.perf_counter()

    def solved(self):
        self.wall = time.perf_counter() - self.t0

    def check(self, key: str, value: float, limit: float):
        self.checks[key] = [value, limit]

    def close(self, res, devices):
        ok = bool(res.converged) and all(
            v <= lim for v, lim in self.checks.values())
        emit({"phase": self.name, "wall_s": self.wall,
              "iterations": int(res.iterations),
              "converged": bool(res.converged), "checks": self.checks,
              "max_reported_resid": float(np.max(res.resid)),
              "peak_bytes_in_use": peak_bytes(devices),
              "matmul_precision": self.precision,
              "check_s": time.perf_counter() - self.t0 - self.wall,
              **self.extra, "pass": ok})
        return ok


# -- phases --------------------------------------------------------------------

def dense_checks(ph, H, res, nev, exact, e_lim, r_lim, o_lim, ncols=256):
    ph.check("eig_err", eig_error(res.ritzv, exact), e_lim)
    ph.check("residual", max_residual(H, res.V, res.ritzv,
                                      spread_columns(nev, ncols)), r_lim)
    ph.check("orth", orth_error(np.asarray(res.V)[:, :nev]), o_lim)


def phase_a(chase, devices, grid=None, ring_filter=None, name="a"):
    """DP north star: scaled Clement N=30000, f64, nev=2250, tol=1e-10."""
    N, nev, nex = 30000, 2250, 750
    H = scaled_clement(N, np.float64)
    cfg = chase.ChaseConfig(ring_filter=ring_filter)
    ph = Phase(name)
    res = chase.eigsh(H, nev, nex, tol=1e-10, grid=grid, config=cfg)
    ph.solved()
    dense_checks(ph, H, res, nev, clement_exact(N, nev), 1e-11, 2e-10, 1e-12)
    return ph.close(res, devices), res


def phase_b(chase, devices):
    """Complex Hermitian N=4000, native complex."""
    from chase_tpu.api import _use_real_pair
    from chase_tpu.models import random_hermitian
    N, nev, nex = 4000, 400, 100
    H = random_hermitian(N, np.complex128, seed=0)
    if _use_real_pair(H, chase.ChaseConfig()):
        raise RuntimeError("complex_backend='auto' chose the real-pair path")
    exact = np.linalg.eigvalsh(H)[:nev]
    ph = Phase("b")
    res = chase.eigsh(H, nev, nex, tol=1e-10)
    ph.solved()
    dense_checks(ph, H, res, nev, exact, 1e-9, 2e-10, 1e-12)
    return ph.close(res, devices)


def phase_c(chase, devices):
    """Complex BSE N=2000 (examples/bse_benchmark.py defaults)."""
    from chase_tpu.models import random_pseudo_hermitian
    N, nev, nex = 2000, 100, 40
    H = random_pseudo_hermitian(N, np.complex128, seed=0)
    w = np.sort(np.linalg.eigvals(H).real)
    exact = w[w > 0][:nev]
    ph = Phase("c")
    res = chase.eigsh_pseudo(H, nev, nex, tol=1e-10)
    ph.solved()
    ph.check("eig_err", eig_error(res.ritzv, exact), 1e-8)
    ph.check("residual", max_residual(H, res.V, res.ritzv,
                                      spread_columns(nev, 256)), 2e-10)
    return ph.close(res, devices)


def phase_d(chase, devices):
    """Warm-started complex sequence, N=8000, 3 members."""
    from chase_tpu.models import hermitian_sequence
    N, nev, nex = 8000, 400, 100
    mats = hermitian_sequence(N, 3, np.complex128, seed=0)
    ph = Phase("d")
    results = list(chase.eigsh_sequence(mats, nev, nex, tol=1e-10))
    ph.solved()
    iters = [int(r.iterations) for r in results]
    for i, (H, r) in enumerate(zip(mats, results)):
        ph.check(f"residual_{i + 1}", max_residual(
            H, r.V, r.ritzv, spread_columns(nev, 64)), 2e-10)
    ph.check("warm_iters_minus_first", float(max(iters[1:]) - iters[0]), 0.0)
    ph.extra["member_iterations"] = iters
    res = results[-1]
    res.converged = all(r.converged for r in results)
    return ph.close(res, devices)


def phase_e(chase, devices):
    """Fused one-dispatch driver, scaled Clement N=8192 f32."""
    N, nev, nex = 8192, 512, 256
    H = scaled_clement(N, np.float32)
    ph = Phase("e")
    res = chase.eigsh_fused(H, nev, nex, tol=1e-5)
    ph.solved()
    dense_checks(ph, H.astype(np.float64), res, nev, clement_exact(N, nev),
                 1e-5, 2e-5, 1e-4)
    return ph.close(res, devices)


def phase_f(chase, devices):
    """The opt-in paths kept from earlier platforms, at N=4096."""
    from chase_tpu.models import random_hermitian
    ok = True
    N = 4096
    H = scaled_clement(N, np.float64)
    cfg = chase.ChaseConfig(mixed_precision=True, wide_f64="on",
                            small_dense_backend="host")
    ph = Phase("f_dp_ladder_wide_host")
    res = chase.eigsh(H, 256, 128, tol=1e-10, config=cfg)
    ph.solved()
    dense_checks(ph, H, res, 256, clement_exact(N, 256), 1e-11, 2e-10, 1e-12)
    ok &= ph.close(res, devices)

    Hc = random_hermitian(2048, np.complex128, seed=0)
    exact = np.linalg.eigvalsh(Hc)[:200]
    ph = Phase("f_real_pair")
    res = chase.eigsh(Hc, 200, 50, tol=1e-10,
                      config=chase.ChaseConfig(complex_backend="real_pair"))
    ph.solved()
    dense_checks(ph, Hc, res, 200, exact, 1e-9, 2e-10, 1e-12)
    ok &= ph.close(res, devices)

    H32 = scaled_clement(N, np.float32)
    ph = Phase("f_bf16_filter")
    res = chase.eigsh(H32, 256, 128, tol=1e-5,
                      config=chase.ChaseConfig(bf16_filter=True))
    ph.solved()
    dense_checks(ph, H32.astype(np.float64), res, 256, clement_exact(N, 256),
                 1e-5, 2e-5, 1e-4)
    ok &= ph.close(res, devices)
    return ok


def run_grid(chase, devices) -> bool:
    """Phase a on a 2x2 grid: ring filter (auto) and GSPMD lowering."""
    grid = chase.make_grid()
    ok_ring, r_ring = phase_a(chase, devices, grid=grid, ring_filter=None,
                              name="a_grid_ring")
    ok_gspmd, r_gspmd = phase_a(chase, devices, grid=grid, ring_filter=False,
                                name="a_grid_gspmd")
    peaks = peak_bytes(devices)
    share = max_memory_share(peaks)
    diff = abs(int(r_ring.iterations) - int(r_gspmd.iterations))
    ok = ok_ring and ok_gspmd and share <= 0.6 and diff <= 1
    emit({"phase": "grid_summary", "grid": grid.shape,
          "peak_bytes_in_use": peaks, "max_device_share": [share, 0.6],
          "iteration_diff": [diff, 1], "pass": ok})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees "
              f"{len(devices)} device(s)", file=sys.stderr)
        return 1
    devices = devices[:args.chips]

    import chase_tpu as chase
    from chase_tpu.device import use_compile_cache
    cache = use_compile_cache()
    jax.config.update("jax_enable_x64", True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit({"nvidia_smi": smi, "jax": jax.__version__, "cache_dir": cache,
          "devices": len(devices)})

    t0 = time.perf_counter()
    if args.chips == 4:
        ok = run_grid(chase, devices)
    else:
        ok = phase_a(chase, devices)[0]
        for phase in (phase_b, phase_c, phase_d, phase_e, phase_f):
            ok = phase(chase, devices) and ok
    emit({"total_wall_s": time.perf_counter() - t0, "pass": ok})
    if not ok:
        return 1
    d = jax.devices()[0]
    emit({"ok": True, "device": {"platform": d.platform,
                                 "kind": d.device_kind,
                                 "count": len(devices)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
