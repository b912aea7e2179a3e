"""On-chip DP refinement-ladder benchmark (tol=1e-10 at scale).

Runs the host-driver solve on a perturbed Clement matrix in f64 at the
reference's default DP tolerance (configuration.hpp:53-62) and reports
iterations, the TRUE residual checked on host against the f64 matrix,
the low-precision FLOP fraction, and wall times.  It runs the opt-in
mixed-precision ladder (f32 filter with the deviation-form refinement);
--wide adds the Ozaki-slice RR/QR GEMMs, the A/B arm against native
f64.

    python benchmarks/dp_ladder_bench.py --n 16384 --nev 512 --nex 256
"""

import argparse
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--nev", type=int, default=512)
    p.add_argument("--nex", type=int, default=256)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeat", action="store_true",
                   help="run a second (warm) solve and report its wall")
    p.add_argument("--scale", action="store_true",
                   help="scale the spectrum to [-1, 1] (tol then reads as "
                        "a RELATIVE residual — the BASELINE semantics; an "
                        "unscaled Clement at N=30000 puts 1e-10 ABSOLUTE "
                        "below the f64 representation floor eps*||H||)")
    p.add_argument("--fused", action="store_true",
                   help="solve through eigsh_fused (one-dispatch program)")
    p.add_argument("--wide", action="store_true",
                   help="wide_f64='on': Ozaki-slice RR/QR GEMMs (with "
                        "--fused, zero f64 ops in the graph)")
    p.add_argument("--no-perturb", action="store_true",
                   help="pure Clement (exact integer spectrum; avoids the "
                        "3x N^2 f64 host-RAM peak of the perturbation at "
                        "N=30000) and check eigenvalues exactly")
    args = p.parse_args()

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import chase_tpu
    from chase_tpu.models import clement, clement_eigenvalues
    from chase_tpu.parallel.operator import DenseOperator

    N = args.n
    t0 = time.perf_counter()
    H = clement(N)
    scale = float(N - 1) if args.scale else 1.0
    if args.scale:
        H = H / scale
    if args.no_perturb:
        exact = clement_eigenvalues(N)[:args.nev] / scale
    else:
        rng = np.random.default_rng(args.seed)
        E = rng.standard_normal((N, N))
        H = (H + 1e-6 * (E + E.T) / 2).astype(np.float64)
        del E
        exact = None
    print(f"[gen] {'pure' if args.no_perturb else 'perturbed'} Clement "
          f"N={N}: {time.perf_counter()-t0:.1f}s", flush=True)

    cfg = chase_tpu.ChaseConfig(mixed_precision=True,
                                wide_f64="on" if args.wide else "auto")
    op = DenseOperator(H)
    solve_fn = chase_tpu.eigsh_fused if args.fused else chase_tpu.eigsh

    t0 = time.perf_counter()
    res = solve_fn(op, args.nev, args.nex, tol=args.tol, config=cfg,
                   collect_perf=True)
    t_first = time.perf_counter() - t0
    rcfg = cfg.resolve(np.float64)
    low_frac = res.perf.low_flop_fraction(
        N, rcfg.lanczos_iter, cfg.num_lanczos, np.float64)
    print(f"[solve] wall={t_first:.1f}s converged={res.converged} "
          f"iters={res.iterations} max_reported={res.resid.max():.3e} "
          f"low_flop_fraction={low_frac:.3f}", flush=True)
    print(res.perf.report(N, rcfg.lanczos_iter, cfg.num_lanczos,
                          np.float64), flush=True)

    # TRUE residual against the host f64 matrix
    V = np.asarray(res.V)[:, :args.nev]
    lam = np.asarray(res.ritzv)[:args.nev]
    R = H @ V - V * lam
    true_resid = np.linalg.norm(R, axis=0).max()
    print(f"[check] true residual max={true_resid:.3e} "
          f"orth={np.abs(V.T @ V - np.eye(args.nev)).max():.3e}", flush=True)
    if exact is not None:
        print(f"[check] eigenvalue error vs exact Clement spectrum: "
              f"{np.abs(lam - exact).max():.3e}", flush=True)

    if args.repeat:
        # serving-warm: programs AND the resident (sliced) operator reused
        t0 = time.perf_counter()
        res2 = solve_fn(op, args.nev, args.nex, tol=args.tol, config=cfg)
        print(f"[warm same-op] wall={time.perf_counter()-t0:.1f}s "
              f"iters={res2.iterations}", flush=True)
        # new-matrix warm: programs reused, operator re-sliced/re-placed
        op2 = DenseOperator(H)
        t0 = time.perf_counter()
        res3 = solve_fn(op2, args.nev, args.nex, tol=args.tol,
                        config=cfg)
        print(f"[warm new-op] wall={time.perf_counter()-t0:.1f}s "
              f"iters={res3.iterations}", flush=True)


if __name__ == "__main__":
    main()
