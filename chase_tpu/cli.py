"""Command-line driver.

Equivalent of the reference's ``examples/2_input_output`` (popl-based CLI,
2_input_output.cpp:330-393): solve problems from binary files or generated
matrices, optionally as warm-started sequences, printing the perf table.

    python -m chase_tpu --n 1200 --nev 100 --nex 40 --isMatGen clement
    python -m chase_tpu --n 4000 --nev 256 --path_in H.bin --dtype complex128 \
        --sequence 3 --mode A
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="chase_tpu",
        description="Chebyshev-accelerated subspace eigensolver")
    p.add_argument("--n", type=int, required=True, help="matrix dimension N")
    p.add_argument("--nev", type=int, required=True, help="wanted eigenpairs")
    p.add_argument("--nex", type=int, default=None, help="extra directions")
    p.add_argument("--deg", type=int, default=None, help="initial filter degree")
    p.add_argument("--maxDeg", type=int, default=None)
    p.add_argument("--maxIter", type=int, default=25)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--mode", choices=["R", "A"], default="R",
                   help="R: random start, A: approximate/warm start")
    p.add_argument("--opt", choices=["S", "N"], default="S",
                   help="S: degree optimization on, N: off")
    p.add_argument("--qr", choices=["C", "H"], default="C",
                   help="C: CholQR, H: Householder")
    p.add_argument("--lanczosIter", type=int, default=None)
    p.add_argument("--numLanczos", type=int, default=4)
    p.add_argument("--sequence", type=int, default=1,
                   help="number of correlated problems to solve")
    p.add_argument("--path_in", type=str, default=None,
                   help="binary matrix file (ChASE column-major format); "
                        "for sequences: a prefix formatted with the index")
    p.add_argument("--isMatGen", choices=["clement", "random", "bse"],
                   default=None, help="generate the test matrix instead")
    p.add_argument("--dtype", default="float64",
                   choices=["float32", "float64", "complex64", "complex128"])
    p.add_argument("--pseudo", action="store_true",
                   help="pseudo-Hermitian (BSE) solve")
    p.add_argument("--fused", action="store_true",
                   help="device-resident single-dispatch solver")
    p.add_argument("--grid", action="store_true",
                   help="2D-shard the operator over all devices")
    p.add_argument("--mb", type=int, default=None,
                   help="ScaLAPACK-style block-cyclic block size (with "
                        "--grid): shard the operator in block-cyclic "
                        "ownership order, reading files through the darray "
                        "analogue")
    p.add_argument("--seed", type=int, default=1337)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import chase_tpu
    from chase_tpu.device import use_compile_cache
    use_compile_cache()
    from chase_tpu import io as cio
    from chase_tpu.models import clement, random_hermitian, \
        random_pseudo_hermitian, hermitian_sequence

    dtype = np.dtype(args.dtype)
    cfg = chase_tpu.ChaseConfig(
        deg=args.deg, max_deg=args.maxDeg, max_iter=args.maxIter,
        optimization=(args.opt == "S"), cholqr=(args.qr == "C"),
        lanczos_iter=args.lanczosIter, num_lanczos=args.numLanczos,
        approx=(args.mode == "A"), seed=args.seed)

    grid = chase_tpu.make_grid() if args.grid else None
    layout = None
    if args.mb:
        if grid is None:
            raise SystemExit("--mb (block-cyclic) requires --grid")
        from chase_tpu.parallel.layouts import (BlockCyclicLayout,
                                                PseudoBlockCyclicLayout)
        # pseudo-Hermitian uses the S-metric-preserving per-half variant
        # (PseudoHermitianBlockCyclicMatrix analogue, distMatrix.hpp:3936)
        cls = PseudoBlockCyclicLayout if args.pseudo else BlockCyclicLayout
        layout = cls(args.n, args.mb, grid.shape["r"], grid.shape["c"])

    def get_matrix(i):
        if args.path_in:
            path = args.path_in.format(i) if "{" in args.path_in \
                else args.path_in
            if layout is not None:
                H, _ = cio.load_matrix_blockcyclic(path, args.n, dtype, grid,
                                                   args.mb, layout=layout)
                return H
            return cio.load_matrix(path, args.n, dtype)
        gen = args.isMatGen or ("bse" if args.pseudo else "clement")
        if gen == "clement":
            H = clement(args.n, dtype=dtype)
        elif gen == "bse":
            H = random_pseudo_hermitian(args.n, dtype=dtype,
                                        seed=args.seed + i)
        elif args.sequence > 1:
            H = hermitian_sequence(args.n, args.sequence, dtype=dtype,
                                   seed=args.seed)[i]
        else:
            H = random_hermitian(args.n, dtype=dtype, seed=args.seed + i)
        return layout.apply(H) if layout is not None else H

    v0 = ritzv0 = None
    for i in range(args.sequence):
        H = get_matrix(i)
        approx = (args.mode == "A" or i > 0) and v0 is not None
        if args.pseudo:
            res = chase_tpu.eigsh_pseudo(
                H, args.nev, args.nex, tol=args.tol, config=cfg, grid=grid,
                v0=v0 if approx else None, ritzv0=ritzv0 if approx else None,
                approx=approx, collect_perf=True)
        elif args.fused:
            res = chase_tpu.eigsh_fused(H, args.nev, args.nex, tol=args.tol,
                                        config=cfg, grid=grid,
                                        v0=v0 if approx else None,
                                        collect_perf=True)
        else:
            res = chase_tpu.eigsh(
                H, args.nev, args.nex, tol=args.tol, config=cfg, grid=grid,
                v0=v0 if approx else None, ritzv0=ritzv0 if approx else None,
                approx=approx, collect_perf=True)
        v0, ritzv0 = np.asarray(res.V), res.ritzv_full
        status = "converged" if res.converged else "NOT converged"
        print(f"[problem {i}] {status} in {res.iterations} iterations; "
              f"locked={res.locked}")
        print(f"  eigenvalues: {res.ritzv[:min(8, args.nev)]}"
              f"{' ...' if args.nev > 8 else ''}")
        print(f"  max residual: {res.resid.max():.3e}")
        if res.perf is not None:
            rcfg = cfg.resolve(dtype)
            print(res.perf.report(args.n, rcfg.lanczos_iter,
                                  args.numLanczos, dtype))
    return 0


if __name__ == "__main__":
    sys.exit(main())
