"""Warm-start sequence benchmark — BASELINE parity config #3.

A sequence of correlated Hermitian problems (the reference's flagship
SCF use case): solve #i warm-starts from #i-1's eigenvectors (mode='A').
Reports per-problem iterations + time; the speedup vs a cold solve of the
same matrix is the sequence feature's value.

    python benchmarks/sequence_bench.py --n 8000 --nev 400 --seq 10
"""

import argparse
import sys
import time

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=8000)
    p.add_argument("--nev", type=int, default=400)
    p.add_argument("--nex", type=int, default=100)
    p.add_argument("--seq", type=int, default=10)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--drift", type=float, default=1e-3,
                   help="relative perturbation between sequence members")
    args = p.parse_args()

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import chase_tpu
    from chase_tpu.models import random_hermitian

    dtype = np.dtype(args.dtype)
    tol = args.tol
    if tol is None:
        # reachable absolute tolerance: ~100 eps relative to ||H||~sqrt(N)
        eps = np.finfo(np.dtype(dtype).char.lower()).eps
        tol = 100 * eps * np.sqrt(args.n)
    H = np.asarray(random_hermitian(args.n, dtype=dtype, seed=0))
    rng = np.random.default_rng(1)

    v0 = None
    total_warm = 0.0
    t_cold = None
    iters = []
    for i in range(args.seq):
        if i > 0:
            E = rng.standard_normal((args.n, args.n)).astype(dtype)
            if np.issubdtype(dtype, np.complexfloating):
                E = E + 1j * rng.standard_normal((args.n, args.n)).astype(dtype)
            H = H + (args.drift / np.sqrt(args.n)) * (E + E.conj().T)
        t0 = time.perf_counter()
        res = chase_tpu.eigsh_fused(H.astype(dtype), args.nev, args.nex,
                                    tol=tol, v0=v0)
        dt = time.perf_counter() - t0
        v0 = np.asarray(res.V)
        iters.append(res.iterations)
        log(f"[{i}] {'warm' if i else 'cold'} t={dt:.2f}s "
            f"iters={res.iterations} conv={res.converged} "
            f"maxres={res.resid.max():.2e}")
        if i == 0:
            t_cold = dt
        else:
            total_warm += dt
    warm_avg = total_warm / max(args.seq - 1, 1)
    log(f"cold(first, incl compile)={t_cold:.2f}s  warm avg={warm_avg:.2f}s  "
        f"iters: {iters}")


if __name__ == "__main__":
    main()
