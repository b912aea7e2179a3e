"""The one module that knows the device the solver runs on.

Everything that depends on the hardware asks here: which platform and
device kind JAX found, how much memory the sizing code may plan with, the
published peak rates the perf tables divide by, and where JAX keeps its
persistent compilation cache.  Nothing else in the package tests the
platform name.

Supported platforms are ``cpu`` (tests, small problems) and ``gpu``.  Both
run every dtype natively — f64 and complex GEMMs, dense eigensolvers and
host callbacks — so no solver path depends on which of the two it got.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["SUPPORTED_PLATFORMS", "PEAKS", "PEAKS_SOURCE", "identity",
           "check_platform", "require_gpu", "memory_bytes", "peak",
           "precision_rung", "use_compile_cache"]

SUPPORTED_PLATFORMS = ("cpu", "gpu")

# Published dense rates (no sparsity), keyed by ``device.device_kind``.
# FLOP/s for the matmul rungs, TOP/s for int8, bytes/s for memory.
PEAKS_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense "
                "rates at the 700 W power limit")
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12,
        "tf32": 495e12,
        "fp32": 67e12,
        "fp64": 67e12,        # FP64 tensor core (DGEMM / ZGEMM)
        "int8": 1979e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}

# The tensor-core rung an f32 contraction runs in for each
# ``precision=`` argument, read from the cuBLAS call XLA compiles on the H100
# (see CHANGES.md).  "highest" keeps full f32 arithmetic.
_F32_RUNG = {"highest": "fp32", "high": "tf32", "default": "tf32"}


def identity() -> dict:
    """Platform, device kind and device count, as JAX reports them."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": jax.device_count()}


def check_platform() -> None:
    """Raise unless JAX runs on a supported platform."""
    platform = jax.devices()[0].platform
    if platform not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}; chase_tpu runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}")


def require_gpu() -> None:
    """For measurement entry points: a run that finds no GPU fails rather
    than measuring the CPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU (JAX platform {platform!r}); this "
                         f"measurement runs on the card")


def memory_bytes(device=None) -> float:
    """Memory one device may use: the runtime's ``bytes_limit`` on an
    accelerator, the host's physical memory on the CPU.  An accelerator
    that reports no limit is an error — the sizing code never guesses."""
    d = device if device is not None else jax.devices()[0]
    if d.platform == "cpu":
        return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    stats = d.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {d.device_kind!r} ({d.platform}) reports no "
            f"memory_stats()['bytes_limit']; cannot size device buffers")
    return float(limit)


def precision_rung(dtype, precision: str = "highest") -> str:
    """Name of the hardware rung a contraction runs in, from the dtype its
    operator is stored in and its ``precision=`` argument."""
    import numpy as np
    from .types import real_dtype
    rdt = np.dtype(real_dtype(dtype))
    if rdt == np.float64:
        return "fp64"
    if rdt == np.dtype(jax.numpy.bfloat16):
        return "bf16"
    return _F32_RUNG[precision]


def peak(rung: str, kind: Optional[str] = None) -> Optional[float]:
    """Published peak of ``rung`` on ``kind`` (default: the current device);
    None when the device kind is not in :data:`PEAKS`."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    table = PEAKS.get(kind)
    return None if table is None else table[rung]


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Called by the repository's entry points (CLI, benchmarks, examples, the
    C ABI), never on import, so a user's own program keeps its JAX config.
    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone.  Otherwise the cache is ``<checkout>/.jax_cache``, a fixed
    path: the path is part of the cache key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    pkg = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(os.path.dirname(pkg), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
