"""complex128 (z-dtype) DP benchmark: Hermitian and BSE solves at
tol=1e-10, native complex or (--real-pair) through the real symplectic
embedding J (f64, size 2N) — the A/B arms of complex_backend.

The reference's z-dtype end-to-end at DP tolerance is its core test
matrix (tests/chase_serial_solve.cpp:23-120 for Hermitian,
chase_serial_solve_pseudo_bse for BSE).  Checks the TRUE COMPLEX residual
and eigenvalue error on host.

    python benchmarks/complex_dp_bench.py --n 4096 --nev 256 --nex 128
    python benchmarks/complex_dp_bench.py --bse --n 4096 --nev 128 --nex 64
    python benchmarks/complex_dp_bench.py --real-pair --n 4096
"""

import argparse
import time

import numpy as np


def hermitian_z(N, seed=0):
    """Clement matrix under a random diagonal phase rotation: genuinely
    complex c128 with the EXACT Clement spectrum."""
    from chase_tpu.models import clement, clement_eigenvalues
    rng = np.random.default_rng(seed)
    d = np.exp(1j * rng.uniform(0, 2 * np.pi, N))
    H = (d[:, None] * np.asarray(clement(N))) * d.conj()[None, :]
    return H.astype(np.complex128), clement_eigenvalues(N)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--nev", type=int, default=256)
    p.add_argument("--nex", type=int, default=128)
    p.add_argument("--tol", type=float, default=1e-10)
    p.add_argument("--bse", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeat", action="store_true")
    p.add_argument("--real-pair", action="store_true",
                   help="complex_backend='real_pair' (2N real embedding)")
    args = p.parse_args()

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import chase_tpu

    N = args.n
    t0 = time.perf_counter()
    if args.bse:
        from chase_tpu.models import random_pseudo_hermitian
        H = random_pseudo_hermitian(N, dtype=np.complex128, seed=args.seed)
        lam_exact = None
    else:
        H, lam_exact = hermitian_z(N, args.seed)
    print(f"[gen] {'BSE ' if args.bse else ''}c128 N={N}: "
          f"{time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    if args.real_pair:
        op = chase_tpu.embed_complex_operator(H, pseudo=args.bse)
        print(f"[embed] J size {2*N} (f64), placed: "
              f"{time.perf_counter()-t0:.1f}s", flush=True)
    else:
        op = H

    solve = chase_tpu.eigsh_pseudo if args.bse else chase_tpu.eigsh
    t0 = time.perf_counter()
    res = solve(op, args.nev, args.nex, tol=args.tol)
    t_first = time.perf_counter() - t0
    print(f"[solve] wall={t_first:.1f}s converged={res.converged} "
          f"iters={res.iterations} max_reported={res.resid.max():.3e}",
          flush=True)

    V = np.asarray(res.V)[:, :args.nev]
    lam = np.asarray(res.ritzv)[:args.nev]
    R = H @ V - V * lam[None, :]
    true_resid = np.linalg.norm(R, axis=0).max()
    if lam_exact is None:
        ev = np.linalg.eigvals(H)
        lam_exact = np.sort(ev.real[ev.real > 0])
    eig_err = np.abs(lam - lam_exact[:args.nev]).max()
    print(f"[check] TRUE COMPLEX residual max={true_resid:.3e} "
          f"eig_err={eig_err:.3e} "
          f"orth={np.abs(V.conj().T @ V - np.eye(args.nev)).max():.3e}",
          flush=True)

    if args.repeat:
        t0 = time.perf_counter()
        res2 = solve(op, args.nev, args.nex, tol=args.tol)
        print(f"[warm] wall={time.perf_counter()-t0:.1f}s "
              f"iters={res2.iterations}", flush=True)


if __name__ == "__main__":
    main()
