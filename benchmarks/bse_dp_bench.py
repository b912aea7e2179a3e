"""On-chip DP BSE benchmark: Solve_pseudo at tol=1e-10 at scale.

Runs the pseudo (BSE) host-driver solve in f64 at the reference's default
DP tolerance (configuration.hpp:53-62, which applies to Solve_pseudo —
algorithm.inc:1834-2220) on a structured pseudo-Hermitian matrix with an
EXACT known spectrum, and reports iterations, the TRUE residual checked
on host against the f64 matrix, the eigenvalue error vs the exact
spectrum, the low-precision FLOP fraction, and wall times.  --mixed 1
(default) runs the deviation-form H² refinement ladder (f32 filter);
--mixed 0 the native f64 filter — the A/B arms of the DP ladder (the
Hermitian twin is dp_ladder_bench.py).

    python benchmarks/bse_dp_bench.py --n 4096 --nev 256 --nex 128
"""

import argparse
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--nev", type=int, default=256)
    p.add_argument("--nex", type=int, default=128)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mixed", type=int, default=1,
                   help="mixed_precision (1=ladder, 0=pure problem dtype)")
    p.add_argument("--repeat", action="store_true",
                   help="run a second (warm) solve and report its wall")
    args = p.parse_args()

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import chase_tpu
    from chase_tpu.models import structured_pseudo_hermitian
    from chase_tpu.parallel.operator import DenseOperator

    N = args.n
    t0 = time.perf_counter()
    H, lam_exact = structured_pseudo_hermitian(N, dtype=np.float64,
                                               seed=args.seed)
    print(f"[gen] structured BSE N={N}: {time.perf_counter()-t0:.1f}s "
          f"(exact positive spectrum known)", flush=True)

    cfg = chase_tpu.ChaseConfig(mixed_precision=bool(args.mixed))
    op = DenseOperator(H, pseudo_hermitian=True)

    t0 = time.perf_counter()
    res = chase_tpu.eigsh_pseudo(op, args.nev, args.nex, tol=args.tol,
                                 config=cfg, collect_perf=True)
    t_first = time.perf_counter() - t0
    rcfg = cfg.resolve(np.float64)
    low_frac = res.perf.low_flop_fraction(
        N, rcfg.lanczos_iter, cfg.num_lanczos, np.float64)
    print(f"[solve] wall={t_first:.1f}s converged={res.converged} "
          f"iters={res.iterations} max_reported={res.resid.max():.3e} "
          f"low_flop_fraction={low_frac:.3f}", flush=True)
    print(res.perf.report(N, rcfg.lanczos_iter, cfg.num_lanczos,
                          np.float64), flush=True)

    # TRUE residual + eigenvalue error against the exact spectrum
    V = np.asarray(res.V)[:, :args.nev]
    lam = np.asarray(res.ritzv)[:args.nev]
    R = H @ V - V * lam
    true_resid = np.linalg.norm(R, axis=0).max()
    eig_err = np.abs(lam - lam_exact[:args.nev]).max()
    print(f"[check] true residual max={true_resid:.3e} "
          f"eig_err={eig_err:.3e} "
          f"orth={np.abs(V.T @ V - np.eye(args.nev)).max():.3e}", flush=True)

    if args.repeat:
        op2 = DenseOperator(H, pseudo_hermitian=True)
        t0 = time.perf_counter()
        res2 = chase_tpu.eigsh_pseudo(op2, args.nev, args.nex, tol=args.tol,
                                      config=cfg)
        print(f"[warm] wall={time.perf_counter()-t0:.1f}s "
              f"iters={res2.iterations}", flush=True)


if __name__ == "__main__":
    main()
