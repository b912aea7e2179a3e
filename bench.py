"""Benchmark: Chebyshev-filter HEMM throughput on the GPU.

    python bench.py

Prints ONE JSON line.  The headline {"metric", "value", "unit",
"vs_baseline"} is the f32 filter at precision="highest" (the solver's
default rung); "ladder" holds the same DEG-step recurrence on every rung the
solver can schedule: f32 at highest / high / default precision, bf16 inputs
with f32 accumulation (bf16_filter), native f64, and native complex64 /
complex128.  Each rung carries its share of the published peak
(chase_tpu.device.PEAKS) where the device kind is in that table.
"f32_dot_lowering" holds, for each precision= of an f32 dot, the library
call and precision config read from the compiled HLO.  The line names the
device (platform, device_kind, count) and the card's name and
power limit from nvidia-smi.

Timing: host clock around jitted sweeps ended by ``block_until_ready``,
after one warm-up call that compiles; the best of ``REPS`` calls.

Baseline: the only absolute perf number the reference repo publishes is the
sample table in docs/usage.rst:367-368 — GFLOPS(filter) = 1.000e+03 (4 MPI
processes).  vs_baseline = our filter GFLOP/s / 1000.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np

N, K, DEG, REPS = 8192, 1024, 20, 3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def sweep_fn(matvec, dtype):
    """One DEG-step scaled Chebyshev sweep of V, renormalized."""
    import jax
    import jax.numpy as jnp

    rdt = jnp.finfo(dtype).dtype
    e = rdt.type(2.2 * np.sqrt(N))
    sigma1 = rdt.type(0.5)

    @jax.jit
    def sweep(h, V):
        Y = (sigma1 / e) * matvec(h, V)

        def body(t, carry):
            Xp, Yc, sigma = carry
            sigma_new = 1.0 / (2.0 / sigma1 - sigma)
            Z = (2.0 * sigma_new / e) * matvec(h, Yc) \
                - (sigma * sigma_new) * Xp
            return (Yc, Z.astype(dtype), sigma_new)

        _, Y, _ = jax.lax.fori_loop(2, DEG + 1, body,
                                    (V, Y.astype(dtype), sigma1))
        return Y / jnp.linalg.norm(Y).astype(dtype)

    return sweep


def rate(sweep, h, V, flops):
    """GFLOP/s of the best of REPS timed calls (after a compiling call)."""
    sweep(h, V).block_until_ready()
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        sweep(h, V).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return flops / best / 1e9


def f32_dot_lowering():
    """For each ``precision=`` of an f32 dot: the library call or fusion
    XLA compiles it to, and the precision config it passes, read from the
    compiled HLO.  Whether a rung is TF32 is then read off the ladder's
    rates (TF32 runs above the fp32 peak)."""
    import jax
    import jax.numpy as jnp

    a = jax.ShapeDtypeStruct((N, N), jnp.float32)
    out = {}
    for p in ("default", "high", "highest"):
        txt = jax.jit(lambda x, y, p=p: jnp.matmul(x, y, precision=p)) \
            .lower(a, a).compile().as_text()
        out[p] = {
            "targets": sorted(
                set(re.findall(r'custom_call_target="([^"]+)"', txt))
                | set(re.findall(r'"kind":"(__[a-z_]+)"', txt))),
            "operand_precision": sorted(set(re.findall(
                r'"operand_precision":\[([^\]]*)\]', txt))),
            "algorithm": sorted(set(re.findall(
                r'"algorithm":"([A-Z0-9_]+)"', txt))),
        }
    return out


def main():
    import jax
    import jax.numpy as jnp

    from chase_tpu import device
    device.require_gpu()
    device.use_compile_cache()
    d = jax.devices()[0]
    jax.config.update("jax_enable_x64", True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()

    key = jax.random.key(0)
    H = jax.random.normal(key, (N, N), jnp.float32)
    H = (H + H.T) / 2
    V = jax.random.normal(jax.random.key(1), (N, K), jnp.float32)
    Hi = (H - H.T) / 2
    real_flops = 2.0 * N * N * K * DEG
    cplx_flops = 8.0 * N * N * (K // 2) * DEG

    def mm(precision, **kw):
        return lambda h, v: jnp.matmul(h, v.astype(h.dtype),
                                       precision=precision, **kw)

    arms = [
        ("f32_highest", "fp32", mm("highest"), H, V, jnp.float32, real_flops),
        ("f32_high", "tf32", mm("high"), H, V, jnp.float32, real_flops),
        ("f32_default", "tf32", mm("default"), H, V, jnp.float32, real_flops),
        ("bf16_in_f32_acc", "bf16",
         mm("default", preferred_element_type=jnp.float32),
         H.astype(jnp.bfloat16), V, jnp.float32, real_flops),
        ("f64", "fp64", mm("highest"), H.astype(jnp.float64),
         V.astype(jnp.float64), jnp.float64, real_flops),
        ("c64", "fp32", mm("highest"), (H + 1j * Hi).astype(jnp.complex64),
         V[:, :K // 2].astype(jnp.complex64), jnp.complex64, cplx_flops),
        ("c128", "fp64", mm("highest"), (H + 1j * Hi).astype(jnp.complex128),
         V[:, :K // 2].astype(jnp.complex128), jnp.complex128, cplx_flops),
    ]
    ladder = {}
    for name, rung, matvec, h, v, dt, flops in arms:
        g = rate(sweep_fn(matvec, dt), h, v, flops)
        peak = device.peak(rung, d.device_kind)
        ladder[name] = {"gflops": g, "rung": rung,
                        "peak_share": None if peak is None
                        else g / (peak / 1e9)}
        log(f"  {name}: {g:,.0f} GFLOP/s")

    value = ladder["f32_highest"]["gflops"]
    print(json.dumps({
        "metric": "filter_hemm_gflops",
        "value": value,
        "unit": "GFLOP/s",
        "vs_baseline": value / 1000.0,
        "ladder": ladder,
        "f32_dot_lowering": f32_dot_lowering(),
        "shape": {"N": N, "k": K, "deg": DEG},
        "device": device.identity(),
        "nvidia_smi": smi,
        "peaks_source": device.PEAKS_SOURCE,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
