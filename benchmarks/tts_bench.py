"""Time-to-solution benchmark on the parity configs (BASELINE.json).

Runs the device-resident fused solver on the single-chip parity configs
and prints wall times (first call includes compilation; the steady-state
number is the cached repeat).

    python benchmarks/tts_bench.py --config clement1000
    python benchmarks/tts_bench.py --config hermitian4000   # c64, nev=400
"""

import argparse
import time

import numpy as np

CONFIGS = {
    # BASELINE parity configs (single-chip scale)
    "clement1000": dict(kind="clement", N=1000, nev=100, nex=40,
                        dtype="float32", tol=1e-4),
    "hermitian4000": dict(kind="random", N=4000, nev=400, nex=100,
                          dtype="complex64", tol=1e-4),
    "bse2000": dict(kind="bse", N=2000, nev=100, nex=40,
                    dtype="complex64", tol=1e-4),
    # compute-bound single-chip config (filter matmul dominates): where the
    # bf16 storage rung pays off
    # absolute tol ~1.2e-5 relative to ||H|| ~ 8191 (f32 floor is ~5e-4 abs)
    "clement8192": dict(kind="clement", N=8192, nev=512, nex=256,
                        dtype="float32", tol=1e-1),
}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=sorted(CONFIGS), default="clement1000")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--bf16", action="store_true",
                   help="enable the bf16 storage filter rung (f32 configs)")
    args = p.parse_args()
    c = CONFIGS[args.config]

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import chase_tpu
    from chase_tpu.models import clement, random_hermitian, \
        random_pseudo_hermitian

    dtype = np.dtype(c["dtype"])
    if c["kind"] == "clement":
        H = clement(c["N"]).astype(dtype)
    elif c["kind"] == "random":
        H = random_hermitian(c["N"], dtype=dtype, seed=0)
    else:
        H = random_pseudo_hermitian(c["N"], dtype=dtype, seed=0)

    _solve = chase_tpu.eigsh_pseudo_fused if c["kind"] == "bse" \
        else chase_tpu.eigsh_fused
    cfg = chase_tpu.ChaseConfig(bf16_filter=args.bf16)

    def solve(H, nev, nex, tol):
        return _solve(H, nev, nex, tol=tol, config=cfg)

    t0 = time.perf_counter()
    res = solve(H, c["nev"], c["nex"], tol=c["tol"])
    t_first = time.perf_counter() - t0
    print(f"[{args.config}] first solve (incl compile): {t_first:.2f}s "
          f"converged={res.converged} iters={res.iterations} "
          f"max_resid={res.resid.max():.2e}")

    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        res = solve(H, c["nev"], c["nex"], tol=c["tol"])
        times.append(time.perf_counter() - t0)
    print(f"[{args.config}] steady-state time-to-solution: "
          f"{min(times):.3f}s (best of {args.repeats}); "
          f"reference sample total: 0.796s (docs/usage.rst:367)")


if __name__ == "__main__":
    main()
