"""Dtype traits and type-dependent algorithm defaults.

JAX analogue of the reference's ``algorithm/types.hpp`` (Base<T>,
SP/DP traits) and the type-dispatched defaults in
``algorithm/configuration.hpp:34-129`` (deg/maxDeg/lanczosIter/tol per
precision).  Instead of C++ template dispatch we key everything off the
numpy/JAX dtype of the problem matrix.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "real_dtype",
    "is_complex_dtype",
    "is_double_base",
    "low_precision_dtype",
    "filter_carry_dtype",
    "default_tol",
    "default_deg",
    "default_max_deg",
    "default_lanczos_iter",
    "eps",
]


def real_dtype(dtype) -> np.dtype:
    """Base<T> analogue: the real scalar type underlying ``dtype``."""
    dtype = np.dtype(dtype)
    if dtype == np.complex64:
        return np.dtype(np.float32)
    if dtype == np.complex128:
        return np.dtype(np.float64)
    if dtype in (np.dtype(np.float32), np.dtype(np.float64)):
        return dtype
    if dtype == np.dtype(jnp.bfloat16):
        return dtype
    raise TypeError(f"unsupported dtype for eigensolver: {dtype}")


def is_complex_dtype(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def is_double_base(dtype) -> bool:
    """True for float64 / complex128 problems ("DP" in the reference)."""
    return real_dtype(dtype).itemsize == 8


def low_precision_dtype(dtype):
    """The reduced-precision dtype used by the mixed-precision filter.

    Reference: DP problems run the filter HEMM in SP while residuals are
    large (Impl/chase_cpu/chase_cpu.hpp:384-447).  Here: f64→f32,
    c128→c64 and additionally f32→bf16 when explicitly requested (the
    bf16 tensor-core rung).
    """
    dtype = np.dtype(dtype)
    if dtype == np.complex128:
        return np.dtype(np.complex64)
    if dtype == np.float64:
        return np.dtype(np.float32)
    if dtype == np.float32:
        return np.dtype(jnp.bfloat16)
    return dtype


def filter_carry_dtype(h_dtype, x_dtype):
    """Dtype of the Chebyshev recurrence carry for a given (H, X) pair.

    For the f64→f32 / c128→c64 mixed-precision rung the whole recurrence
    runs in the reduced dtype (the reference's SP filter).  For the bf16
    *storage* rung (f32 problems, H cast to bf16 matmul inputs)
    the carry stays in the problem dtype — only the matmul inputs are
    cast down, with f32 accumulation — because a 3-term recurrence carried
    in 8 mantissa bits degrades too fast.
    """
    if np.dtype(h_dtype) == np.dtype(jnp.bfloat16):
        xd = np.dtype(x_dtype)
        # a bf16-storage operator caps the recurrence fidelity at ~1e-2
        # relative: a 64-bit carry buys nothing over f32 and costs f64
        # elementwise work + 2x the carry memory (the transient-shadow
        # filter)
        if xd == np.dtype(np.float64):
            return np.dtype(np.float32)
        if xd == np.dtype(np.complex128):
            return np.dtype(np.complex64)
        return xd
    return np.dtype(h_dtype)


def eps(dtype) -> float:
    return float(np.finfo(real_dtype(dtype)).eps)


def default_tol(dtype) -> float:
    # configuration.hpp:53-62 — 1e-10 DP / 1e-5 SP
    return 1e-10 if is_double_base(dtype) else 1e-5


def default_deg(dtype) -> int:
    # configuration.hpp — deg 20 DP / 10 SP
    return 20 if is_double_base(dtype) else 10


def default_max_deg(dtype) -> int:
    # configuration.hpp — maxDeg 36 DP / 18 SP
    return 36 if is_double_base(dtype) else 18


def default_lanczos_iter(dtype) -> int:
    # configuration.hpp — 25 DP / 12 SP
    return 25 if is_double_base(dtype) else 12
