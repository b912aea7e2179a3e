"""BSE (pseudo-Hermitian) scale benchmark on the local accelerator.

The reference's flagship BSE driver is examples/5_bse_benchmark.cpp
(matrix from file + Solve_pseudo); here the matrix is the exact-spectrum
structured BSE generator so correctness is checkable at sizes where a
direct eigendecomposition is impractical.

Host driver with phase-split perf; warm repeats separate compile time
from the solve.  --ab sweeps bf16_filter in one process (compare two
versions only within one run on one card).

    python benchmarks/bse_bench.py                       # N=8192 default
    python benchmarks/bse_bench.py --n 16384 --nev 1024
    python benchmarks/bse_bench.py --ab bf16             # off vs on
"""

import argparse
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(op, nev, nex, tol, cfg, exact, repeats, label):
    import chase_tpu

    walls = []
    for r in range(repeats):
        t0 = time.perf_counter()
        res = chase_tpu.eigsh_pseudo(op, nev, nex, tol=tol, config=cfg,
                                     collect_perf=True)
        wall = time.perf_counter() - t0
        walls.append(wall)
        err = float(np.abs(np.asarray(res.ritzv) - exact).max()
                    / np.abs(exact).max())
        log(f"[{label}] rep {r}: wall {wall:.2f}s iters={res.iterations} "
            f"converged={res.converged} rel_eig_err={err:.2e}")
        if res.perf is not None:
            rcfg = cfg.resolve(np.float32)
            log(res.perf.report(op.N, rcfg.lanczos_iter, rcfg.num_lanczos,
                                np.float32))
    return walls[-1]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--nev", type=int, default=512)
    p.add_argument("--nex", type=int, default=256)
    p.add_argument("--tol", type=float, default=None,
                   help="absolute tolerance (default: 1e-5 relative to "
                        "lam_max, f32-floor-class)")
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--ab", choices=["bf16"], default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import chase_tpu
    from chase_tpu.models import structured_pseudo_hermitian

    N, nev, nex = args.n, args.nev, args.nex
    log(f"building structured BSE N={N} f32 ...")
    t0 = time.perf_counter()
    H, lam = structured_pseudo_hermitian(N, dtype=np.float32, seed=args.seed)
    log(f"  built in {time.perf_counter() - t0:.1f}s  "
        f"lam=[{lam[0]:.3f}, {lam[-1]:.3f}]")
    tol = args.tol if args.tol is not None else 1e-5 * float(lam[-1])
    exact = lam[:nev]

    op = chase_tpu.DenseOperator(H, pseudo_hermitian=True)

    if args.ab == "bf16":
        for bf16 in (False, True):
            cfg = chase_tpu.ChaseConfig(bf16_filter=bf16)
            run(op, nev, nex, tol, cfg, exact, args.repeats,
                f"bf16={bf16}")
    else:
        cfg = chase_tpu.ChaseConfig(bf16_filter=not args.no_bf16)
        run(op, nev, nex, tol, cfg, exact, args.repeats, "default")


if __name__ == "__main__":
    main()
