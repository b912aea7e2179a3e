"""Shape-stable column-block glue ops shared by the solver drivers.

These replace the reference's pointer arithmetic / memcpy column machinery
(``swapDataPointer`` ping-pong, ``Swap`` column memcpys, lacpy sub-block
copies) with functional gathers and dynamic slices whose index data is
traced — one XLA program regardless of the host-side geometry.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["permute_cols", "slice_cols", "update_cols", "set_head_cols",
           "scale_lower_rows", "inverse_permutation"]


@jax.jit
def permute_cols(V, perm):
    return jnp.take(V, perm, axis=1)


@partial(jax.jit, static_argnames=("w",))
def slice_cols(V, start, w):
    return jax.lax.dynamic_slice(V, (jnp.int32(0), start), (V.shape[0], w))


@jax.jit
def update_cols(V, X, start):
    return jax.lax.dynamic_update_slice(V, X.astype(V.dtype),
                                        (jnp.int32(0), start))


@jax.jit
def set_head_cols(V, Vd, mask):
    m = Vd.shape[1]
    head = jnp.where(mask[None, :], Vd.astype(V.dtype), V[:, :m])
    return V.at[:, :m].set(head)


def inverse_permutation(perm):
    """inv with inv[perm[i]] = i, as one int32 scatter.  Used in place of
    ``argsort(perm)``: XLA's GPU sort simplifier turns that sort into a
    scatter whose int64 index type fails its own verifier under x64."""
    n = perm.shape[0]
    return jnp.zeros(n, jnp.int32).at[perm].set(
        jnp.arange(n, dtype=jnp.int32), unique_indices=True)


@jax.jit
def scale_lower_rows(V, scale):
    """Scale rows [N/2, N) — pseudo initVecs' 0.001 lower-half damping
    (chase_cpu.hpp:310-321)."""
    n2 = V.shape[0] // 2
    rows = jnp.arange(V.shape[0])
    return jnp.where((rows >= n2)[:, None],
                     V * jnp.asarray(scale, V.dtype), V)
