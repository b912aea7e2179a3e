"""BSE benchmark: pseudo-Hermitian solve (reference examples/5_bse_benchmark).

Generates a BSE-structured Hamiltonian (or loads one with --path) and
computes the nev smallest-positive excitation energies.
"""

import argparse
import time

import numpy as np
import chase_tpu
from chase_tpu import io as cio
from chase_tpu.device import use_compile_cache
from chase_tpu.models import random_pseudo_hermitian

use_compile_cache()

p = argparse.ArgumentParser()
p.add_argument("--n", type=int, default=2000)
p.add_argument("--nev", type=int, default=100)
p.add_argument("--nex", type=int, default=40)
p.add_argument("--tol", type=float, default=1e-10)
p.add_argument("--path", type=str, default=None)
args = p.parse_args()

if args.path:
    H = cio.load_matrix(args.path, args.n, np.complex128)
else:
    H = random_pseudo_hermitian(args.n, dtype=np.complex128, seed=0)

t0 = time.perf_counter()
res = chase_tpu.eigsh_pseudo(H, args.nev, args.nex, tol=args.tol,
                             collect_perf=True)
dt = time.perf_counter() - t0
print(f"converged={res.converged} iterations={res.iterations} "
      f"time={dt:.2f}s")
print("lowest excitation energies:", res.ritzv[:8])
print("max residual:", res.resid.max())
print(res.perf.report(args.n, 25, 4, H.dtype))
