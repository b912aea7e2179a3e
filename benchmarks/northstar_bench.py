"""North-star benchmark: Clement N=30000, nev=2250, f32, one chip.

The BASELINE.md headline shape (nev=2250 of N=30k).  Host driver with
phase-split perf collection; warm repeats separate compile time from the
solve.  Use --ab to sweep knobs in one process (compare two versions only
within one run on one card).

    python benchmarks/northstar_bench.py                 # shipped config
    python benchmarks/northstar_bench.py --col-block 1500
    python benchmarks/northstar_bench.py --warmup        # time the warmup
                                                         # and the first
                                                         # post-warmup solve
"""

import argparse
import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=30000)
    p.add_argument("--nev", type=int, default=2250)
    p.add_argument("--nex", type=int, default=750)
    p.add_argument("--tol", type=float, default=None,
                   help="absolute tolerance (default: dtype default 1e-5)")
    p.add_argument("--col-block", type=int, default=750)
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--warmup", action="store_true",
                   help="run chase_tpu.warmup first and report the first "
                        "post-warmup solve wall (the serving story)")
    p.add_argument("--matmul-precision", default="highest")
    p.add_argument("--fused", action="store_true",
                   help="solve through eigsh_fused (one-dispatch program "
                        "with phase tiers) instead of the host driver")
    p.add_argument("--fused-tiers", type=int, default=None,
                   help="override fused phase-window tier count")
    p.add_argument("--unfolded", action="store_true",
                   help="round-4 multi-dispatch filter path (A/B control "
                        "for the dispatch-folded segment programs)")
    args = p.parse_args()

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues

    N, nev, nex = args.n, args.nev, args.nex
    log(f"building Clement N={N} f32 ...")
    t0 = time.perf_counter()
    H = np.asarray(clement(N), np.float32)
    log(f"  built in {time.perf_counter() - t0:.1f}s")

    cfg_kwargs = dict(
        col_block=args.col_block,
        bf16_filter=not args.no_bf16,
        matmul_precision=args.matmul_precision,
        folded_filter=not args.unfolded,
    )
    if args.fused_tiers is not None:
        cfg_kwargs["fused_tiers"] = args.fused_tiers
    cfg = chase_tpu.ChaseConfig(**cfg_kwargs)
    op = chase_tpu.DenseOperator(H)

    if args.warmup:
        t0 = time.perf_counter()
        rep = chase_tpu.warmup(op, nev, nex, config=cfg)
        t_wu = time.perf_counter() - t0
        log(f"warmup: {rep} in {t_wu:.1f}s")

    exact = clement_eigenvalues(N)[:nev]
    solve_fn = chase_tpu.eigsh_fused if args.fused else chase_tpu.eigsh
    walls = []
    for r in range(args.repeats + (1 if args.warmup else 0)):
        t0 = time.perf_counter()
        res = solve_fn(op, nev, nex, tol=args.tol, config=cfg,
                       collect_perf=True)
        wall = time.perf_counter() - t0
        walls.append(wall)
        err = float(np.abs(np.asarray(res.ritzv) - exact).max()
                    / np.abs(exact).max())
        log(f"rep {r}: wall {wall:.2f}s iters={res.iterations} "
            f"converged={res.converged} rel_eig_err={err:.2e}")
        if res.perf is not None:
            rcfg = cfg.resolve(np.float32)
            log(res.perf.report(N, rcfg.lanczos_iter, rcfg.num_lanczos,
                                np.float32))
    out = {"metric": "northstar_wall", "value": min(walls[1:] or walls),
           "unit": "s", "walls": walls,
           "config": {"N": N, "nev": nev, "nex": nex,
                      "col_block": args.col_block,
                      "bf16": not args.no_bf16,
                      "folded": not args.unfolded,
                      "driver": "fused" if args.fused else "host"}}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
