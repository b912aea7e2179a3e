"""Weak/strong scaling harness for the sharded filter HEMM.

Reference analogue: the published scaling studies (README.md:192-198) and
the BASELINE north star (≥80% weak-scaling efficiency at ≥2 hosts).

Runs on the GPUs of one host (all of them by default) and reports weak or
strong efficiency of the sharded filter directly.

    python benchmarks/scaling.py --mode weak --base-n 8192
"""

import argparse
import time

import numpy as np


def run_case(grid, N, k, deg, dtype, reps=3):
    import jax
    import jax.numpy as jnp
    from chase_tpu.ops.filter import chebyshev_filter

    H = jax.device_put(
        np.asarray(np.random.default_rng(0).standard_normal((N, N)), dtype),
        grid.sharding("r", "c"))
    V = jax.device_put(
        np.asarray(np.random.default_rng(1).standard_normal((N, k)), dtype),
        grid.sharding("r", None))
    degs = jax.device_put(np.full(k, deg, np.int32), grid.sharding(None))
    args = (np.asarray(-2.2 * np.sqrt(N), dtype),
            np.asarray(0.0, dtype), np.asarray(2.2 * np.sqrt(N), dtype),
            jnp.int32(deg))

    out = chebyshev_filter(H, V, degs, *args)
    out.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = chebyshev_filter(H, out, degs, *args)
    _ = float(jnp.sum(jnp.abs(out[:2, :2])))
    dt = (time.perf_counter() - t0) / reps
    gflops = 2.0 * N * N * k * deg / 1e9
    return dt, gflops / dt


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["weak", "strong"], default="weak")
    p.add_argument("--base-n", type=int, default=1024)
    p.add_argument("--k", type=int, default=256)
    p.add_argument("--deg", type=int, default=20)
    p.add_argument("--dtype", default="float32")
    args = p.parse_args()

    from chase_tpu.device import require_gpu, use_compile_cache
    require_gpu()
    use_compile_cache()
    import jax
    import chase_tpu

    ndev = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16) if d <= ndev]
    base_rate = None
    print(f"devices available: {ndev}; mode={args.mode}")
    for d in sizes:
        grid = chase_tpu.make_grid(jax.devices()[:d])
        if args.mode == "weak":
            N = int(args.base_n * np.sqrt(d))   # memory/device constant
        else:
            N = args.base_n
        dt, rate = run_case(grid, N, args.k, args.deg, np.dtype(args.dtype))
        if base_rate is None:
            base_rate = rate
            eff = 1.0
        else:
            eff = rate / (base_rate * d) if args.mode == "strong" \
                else rate / (base_rate * d)
        print(f"  devices={d:2d} grid={tuple(grid.shape.values())} N={N:6d} "
              f"time={dt * 1e3:9.2f} ms rate={rate:9.1f} GFLOP/s "
              f"efficiency={eff * 100:5.1f}%")


if __name__ == "__main__":
    main()
