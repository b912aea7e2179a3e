"""Standalone residual norms ‖H v − θ v‖₂ per column.

Mirrors linalg/internal/cpu/residuals.hpp:56-83 (and the distributed
variant's allreduced squared norms, mpi/residuals.hpp:60-110 — here the
norm reduction over the row-sharded axis is a psum GSPMD inserts for us).
Used for final verification and tests; the solver's per-iteration residuals
come fused from :func:`chase_tpu.ops.rr.rayleigh_ritz_residuals`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..types import real_dtype

__all__ = ["residuals"]


@partial(jax.jit, static_argnames=("precision",))
def residuals(H, V, ritzv, *, precision="highest"):
    """(k,) residual 2-norms for eigenpair approximations (V, ritzv)."""
    W = jnp.matmul(H, V, precision=precision)
    R = W - V * ritzv[None, :].astype(V.dtype)
    return jnp.linalg.norm(R, axis=0).real.astype(real_dtype(V.dtype))
