"""QR benchmark (reference examples/6_householder_block_cyclic_benchmark /
xhouholder.sh: N=115000, ncols=8000): times the orthonormalization stack at
scale on the local accelerator.

    python benchmarks/qr_bench.py --n 16384 --cols 1024
"""

import argparse
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=16384)
    p.add_argument("--cols", type=int, default=1024)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--skip-householder", action="store_true",
                   help="dense QR is O(4Nk^2) and panel-bound at the "
                        "reference's N=115000/k=8000 config; skip it there")
    args = p.parse_args()

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import jax
    import jax.numpy as jnp
    from chase_tpu.ops.qr import cholqr, householder_qr, mgs_cholqr

    dtype = jnp.dtype(args.dtype)
    V = jax.random.normal(jax.random.key(0), (args.n, args.cols), dtype)

    flops_chol = 2 * (2 * args.n * args.cols ** 2)   # syherk + trsm per pass

    variants = [
        ("cholQR1", lambda v: cholqr(v, passes=1)[0], flops_chol / 2),
        ("cholQR2", lambda v: cholqr(v, passes=2)[0], flops_chol),
        ("shiftedCholQR2", lambda v: cholqr(v, passes=3, shifted=True)[0],
         1.5 * flops_chol),
        # the panelized variant the reference sizes for N>=1e5 blocks
        ("MGS-CholQR", lambda v: mgs_cholqr(v)[0], flops_chol),
        ("householder", householder_qr, 4 * args.n * args.cols ** 2),
    ]
    if args.skip_householder:
        variants = variants[:-1]
    for name, fn, fl in variants:
        try:
            out = fn(V)
            _ = float(jnp.sum(jnp.abs(out[:2, :2])))
            t0 = time.perf_counter()
            for _i in range(args.reps):
                out = fn(V)
            _ = float(jnp.sum(jnp.abs(out[:2, :2])))
            dt = (time.perf_counter() - t0) / args.reps
            print(f"{name:16s} {dt * 1e3:9.2f} ms   "
                  f"~{fl / dt / 1e12:6.2f} TFLOP/s", flush=True)
        except Exception as e:  # one variant OOMing must not kill the rest
            first = (str(e).splitlines() or [""])[0]
            print(f"{name:16s} FAILED: {type(e).__name__}: {first[:120]}",
                  flush=True)


if __name__ == "__main__":
    main()
