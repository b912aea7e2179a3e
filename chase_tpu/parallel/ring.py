"""Ring collective matmul — explicit compute/communication overlap (P11).

The reference overlaps the filter's GEMM with its allreduce via dual CUDA
streams (nccl/hemm.hpp:95-266 split-GEMM path) and fuses the multivector
redistribution into HEMM (mpi/hemm.hpp:282-494).  The JAX analogue is a
*collective matmul*: with H row-sharded P('x', None) and V row-sharded
P('x'), each device needs all of V — instead of an up-front all-gather, V
circulates around the ring in p chunks and each device multiplies its
local H stripe against the chunk it currently holds while the next chunk
is in flight (NCCL over NVLink on GPUs).

`ring_hemm` is shard_map + `lax.ppermute`, software-pipelined (the permute
for step s+1 is issued before the dot of step s so XLA's latency-hiding
scheduler can overlap them).  Runs everywhere (tested on the virtual CPU
mesh).

Against GSPMD's default lowering (all-gather V, then one big dot) the ring
trades one large exposed collective for p overlapped small ones.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

__all__ = ["ring_hemm", "chebyshev_filter_ring", "chebyshev_filter_ring2d",
           "chebyshev_filter_refine_ring", "chebyshev_filter_refine_ring2d",
           "chebyshev_filter_refine_h2_ring",
           "chebyshev_filter_refine_h2_ring2d"]


def _ring_dot_1d(h, v, *, axis, p, acc_dt, precision):
    """Local rows of H @ V via the 1D software-pipelined ring (shared by
    every 1D ring filter).  ``h``: (n_h, N) local stripe; ``v``: (N/p, k)
    local chunk.  The permute for chunk s+1 is issued before the dot of
    chunk s (overlap); a reduced-precision ``h`` against a wider ``v``
    accumulates in ``acc_dt`` (mixed-precision shadows)."""
    me = jax.lax.axis_index(axis)
    n_loc = v.shape[0]

    def step(s, carry):
        acc, cur = carry
        src = (me + s) % p
        nxt = jax.lax.ppermute(
            cur, axis, [(i, (i - 1) % p) for i in range(p)])
        h_blk = jax.lax.dynamic_slice(
            h, (jnp.int32(0), (src * n_loc).astype(jnp.int32)),
            (h.shape[0], n_loc))
        if h_blk.dtype != cur.dtype:
            acc = acc + jnp.matmul(h_blk, cur.astype(h_blk.dtype),
                                   precision=precision,
                                   preferred_element_type=acc_dt)
        else:
            acc = acc + jnp.matmul(h_blk, cur, precision=precision)
        return (acc, nxt)

    acc = jnp.zeros((h.shape[0], v.shape[1]), acc_dt)
    acc = jax.lax.pcast(acc, (axis,), to="varying")
    acc, _ = jax.lax.fori_loop(0, p, step, (acc, v))
    return acc


def _ring2d_pair(pr, pc, acc_dt, precision):
    """The two parity passes of the 2D ping-pong schedule, shared by every
    2D ring filter.  Returns (ring_A, ring_B) closures over ``h``:

      ring_A(h, w): parity A → H·w partial rows, psum_scatter 'c' → B
      ring_B(h, w): parity B → Hᴴ·w partial cols, psum_scatter 'r' → A
    """
    def _mm(h_blk, w):
        if h_blk.dtype != w.dtype:
            return jnp.matmul(h_blk, w.astype(h_blk.dtype),
                              precision=precision,
                              preferred_element_type=acc_dt)
        return jnp.matmul(h_blk, w, precision=precision)

    def ring_A(h, w):
        i = jax.lax.axis_index("r")
        nch = w.shape[0]

        def step(s, st):
            acc, cur = st
            nxt = jax.lax.ppermute(
                cur, "r", [(t, (t - 1) % pr) for t in range(pr)])
            sub = ((i + s) % pr) * nch
            h_blk = jax.lax.dynamic_slice(
                h, (jnp.int32(0), sub.astype(jnp.int32)),
                (h.shape[0], nch))
            return acc + _mm(h_blk, cur), nxt

        acc = jnp.zeros((h.shape[0], w.shape[1]), acc_dt)
        acc = jax.lax.pcast(acc, ("r", "c"), to="varying")
        acc, _ = jax.lax.fori_loop(0, pr, step, (acc, w))
        return jax.lax.psum_scatter(acc, "c", scatter_dimension=0,
                                    tiled=True)

    def ring_B(h, w):
        j = jax.lax.axis_index("c")
        nch = w.shape[0]

        def step(s, st):
            acc, cur = st
            nxt = jax.lax.ppermute(
                cur, "c", [(t, (t - 1) % pc) for t in range(pc)])
            sub = ((j + s) % pc) * nch
            h_blk = jax.lax.dynamic_slice(
                h, (sub.astype(jnp.int32), jnp.int32(0)),
                (nch, h.shape[1]))
            return acc + _mm(h_blk.conj().T, cur), nxt

        acc = jnp.zeros((h.shape[1], w.shape[1]), acc_dt)
        acc = jax.lax.pcast(acc, ("r", "c"), to="varying")
        acc, _ = jax.lax.fori_loop(0, pc, step, (acc, w))
        return jax.lax.psum_scatter(acc, "r", scatter_dimension=0,
                                    tiled=True)

    return ring_A, ring_B


@partial(jax.jit, static_argnames=("grid", "axis", "precision"))
def ring_hemm(grid, H, V, *, axis: str = "r", precision="highest"):
    """W = H @ V with H in P(axis, None), V in P(axis), W out in P(axis).

    Args:
      grid: Grid2D whose mesh carries `axis`.
      H: (N, N) row-sharded over `axis` (each device: (N/p, N) stripe).
      V: (N, k) row-sharded over `axis`.
    """
    mesh = grid.mesh
    p = mesh.shape[axis]

    def local(h, v):
        # h: (N/p, N) local stripe; v: (N/p, k) local chunk
        n_loc = v.shape[0]
        me = jax.lax.axis_index(axis)

        def step(s, carry):
            acc, cur = carry
            # chunk `cur` is the V rows owned by (me + s) mod p
            src = (me + s) % p
            # issue the transfer of the next chunk first (overlap with dot)
            nxt = jax.lax.ppermute(
                cur, axis, [(i, (i - 1) % p) for i in range(p)])
            h_blk = jax.lax.dynamic_slice(
                h, (jnp.int32(0), (src * n_loc).astype(jnp.int32)),
                (h.shape[0], n_loc))
            acc = acc + jnp.matmul(h_blk, cur, precision=precision)
            return (acc, nxt)

        acc = jnp.zeros((h.shape[0], v.shape[1]),
                        jnp.promote_types(h.dtype, v.dtype))
        acc = jax.lax.pcast(acc, (axis,), to="varying")  # device-varying
        acc, _ = jax.lax.fori_loop(0, p, step, (acc, v))
        return acc.astype(v.dtype)

    spec_h = P(axis, None)
    spec_v = P(axis, None)
    fn = shard_map(local, mesh=mesh, in_specs=(spec_h, spec_v),
                   out_specs=spec_v)
    return fn(H, V)


@partial(jax.jit, static_argnames=("grid", "precision"))
def chebyshev_filter_ring2d(grid, H, X, degrees, lam1, lower, upper, deg_max,
                            *, precision="highest"):
    """Chebyshev filter as a 2D ping-pong collective matmul (P4 + P11).

    JAX realization of the reference's transpose-free bAc/cAb HEMM
    alternation (Impl/pchase_cpu/pchase_cpu.hpp:407; nccl/hemm.hpp:95-266
    dual-stream overlap): with H in P('r','c') tiles and V fully row-sharded
    in N/(r·c) chunks, the recurrence alternates between two parities

      A (chunks c-major, ``P(('c','r'))``):  H[i,j] needs exactly the chunks
        held by its own mesh COLUMN — ring over 'r', local (N/r, nch)·
        (nch, k) dots, psum_scatter over 'c' → parity B;
      B (chunks r-major, ``P(('r','c'))``):  Hermiticity gives W = HᴴV, so
        (H[i,j])ᴴ needs the chunks held by its own mesh ROW — ring over 'c',
        psum_scatter over 'r' → parity A.

    No all-gather ever materializes V: per step each device moves
    (p_ring−1)·N·k/(r·c) ring traffic + one chunk hop for the diagonal-shift
    term, all overlappable with the local dots.  V is also never replicated
    (memory win over the GSPMD P('r') layout).  Degree-retired columns are
    carried through each step by a parity FLIP (a fixed transpose ppermute,
    content-preserving) so the whole block exits in parity A regardless of
    the per-column degrees.

    Mixed precision: H may be the f32/bf16 shadow; the recurrence carry
    follows ``filter_carry_dtype`` with reduced-input matmuls accumulating
    in the carry dtype.

    Requires N divisible by r·c.  Semantics identical to
    ops.filter.chebyshev_filter.
    """
    from ..types import filter_carry_dtype, real_dtype as _rdt

    mesh = grid.mesh
    pr = mesh.shape["r"]
    pc = mesh.shape["c"]
    out_dtype = X.dtype
    carry = filter_carry_dtype(H.dtype, X.dtype)
    rt = _rdt(carry)

    lam1 = jnp.asarray(lam1, rt)
    lower = jnp.asarray(lower, rt)
    upper = jnp.asarray(upper, rt)
    c = (upper + lower) / 2
    e = (upper - lower) / 2
    sigma1 = e / (lam1 - c)
    deg_max = jnp.asarray(deg_max, jnp.int32)
    # fixed transpose permutations between the two chunk orders
    # (linearized over ('r','c'): device (i,j) ↔ i·pc + j)
    flip_a2b = [(i * pc + j, j * pr + i)
                for i in range(pr) for j in range(pc)]
    flip_b2a = [(m, (m % pr) * pc + (m // pr)) for m in range(pr * pc)]

    def local(h, x, degs):
        x0 = x
        x = x.astype(carry)
        ringA2, ringB2 = _ring2d_pair(pr, pc, carry, precision)
        ring_A = lambda v: ringA2(h, v)    # noqa: E731
        ring_B = lambda v: ringB2(h, v)    # noqa: E731

        def substep(t, Xp, Yc, sigma, ring, flip_perm):
            """One recurrence step Yc(P_in) → Z(P_out); frozen columns are
            parity-FLIPPED so they track the block's current parity."""
            flipped = jax.lax.ppermute(Yc, ("r", "c"), flip_perm)
            w = ring(Yc)
            sigma_new = 1.0 / (2.0 / sigma1 - sigma)
            Z = (2.0 * sigma_new / e) * (w - c * flipped) \
                - (sigma * sigma_new) * Xp
            Z = jnp.where(degs[None, :] >= t, Z, flipped)
            return Z, sigma_new

        # step 1 (A→B): Y = (σ1/e)(H − c)x, frozen cols flipped to B
        flipped0 = jax.lax.ppermute(x, ("r", "c"), flip_a2b)
        w0 = ring_A(x)
        Y = (sigma1 / e) * (w0 - c * flipped0)
        Y = jnp.where(degs[None, :] >= 1, Y, flipped0)

        # pairs of steps (B→A then A→B) keep the loop body parity-static;
        # a trailing padded step beyond deg_max is an all-frozen pure flip
        def pair(s, st):
            Xp, Yc, sigma = st
            t2 = 2 + 2 * s
            Z2, sigma = substep(t2, Xp, Yc, sigma, ring_B, flip_b2a)
            Z3, sigma = substep(t2 + 1, Yc, Z2, sigma, ring_A, flip_a2b)
            return (Z2, Z3, sigma)

        n_pairs = deg_max // 2
        _, Y, _ = jax.lax.fori_loop(0, n_pairs, pair, (x, Y, sigma1))
        # block always ends in parity B (see pairing analysis) → flip home
        Yh = jax.lax.ppermute(Y, ("r", "c"), flip_b2a).astype(out_dtype)
        # degree-0 (locked/inactive) columns bit-exact: a mixed-precision
        # carry must not round-trip converged f64 columns through f32
        return jnp.where(degs[None, :] >= 1, Yh, x0)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("r", "c"), P(("c", "r"), None), P()),
                   out_specs=P(("c", "r"), None))
    return fn(H, X, degrees)


@partial(jax.jit, static_argnames=("grid", "axis", "precision"))
def chebyshev_filter_ring(grid, H, X, degrees, lam1, lower, upper, deg_max,
                          *, axis: str = "r", precision="highest"):
    """Chebyshev filter with the ring collective matmul as the HEMM (P11
    integrated): the whole recurrence runs inside one shard_map, each step's
    H·V expressed as the software-pipelined ring so the V-chunk transfers
    overlap the local dots.

    H in P(axis, None) (1D row stripes), X in P(axis).  Semantics identical
    to ops.filter.chebyshev_filter.  H may be a reduced-precision shadow
    (mixed precision / bf16 rung): the recurrence carry follows
    ``filter_carry_dtype`` with reduced-input matmuls accumulating in the
    carry dtype, exactly like ops.filter._hemm_shift.
    """
    from ..types import filter_carry_dtype, real_dtype as _rdt

    mesh = grid.mesh
    p = mesh.shape[axis]
    out_dtype = X.dtype
    carry_dt = filter_carry_dtype(H.dtype, X.dtype)
    rt = _rdt(carry_dt)

    lam1 = jnp.asarray(lam1, rt)
    lower = jnp.asarray(lower, rt)
    upper = jnp.asarray(upper, rt)
    c = (upper + lower) / 2
    e = (upper - lower) / 2
    sigma1 = e / (lam1 - c)
    deg_max = jnp.asarray(deg_max, jnp.int32)

    def local(h, x, degs):
        x0 = x
        x = x.astype(carry_dt)

        def hemm_shift(v):
            return _ring_dot_1d(h, v, axis=axis, p=p, acc_dt=carry_dt,
                                precision=precision) - c.astype(rt) * v

        Y = (sigma1 / e) * hemm_shift(x)
        Y = jnp.where(degs[None, :] >= 1, Y, x)

        def body(t, carry):
            Xp, Yc, sigma = carry
            sigma_new = 1.0 / (2.0 / sigma1 - sigma)
            Z = (2.0 * sigma_new / e) * hemm_shift(Yc) \
                - (sigma * sigma_new) * Xp
            Z = jnp.where(degs[None, :] >= t, Z, Yc)
            return (Yc, Z, sigma_new)

        _, Y, _ = jax.lax.fori_loop(2, deg_max + 1, body, (x, Y, sigma1))
        # degree-0 (locked/inactive) columns bit-exact: a mixed-precision
        # carry must not round-trip converged f64 columns through f32
        return jnp.where(degs[None, :] >= 1, Y.astype(out_dtype), x0)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis, None), P(axis, None), P()),
                   out_specs=P(axis, None))
    return fn(H, X, degrees)


@partial(jax.jit, static_argnames=("grid", "axis", "precision"))
def chebyshev_filter_refine_ring(grid, H, V, R, degrees, alpha1_e, alphas,
                                 betas, inj, p_final, cc, deg_max, *,
                                 axis: str = "r", precision="highest"):
    """Deviation-form refinement filter with the 1D ring HEMM (P10 × P11).

    Same injection algebra as ops.filter.chebyshev_filter_refine — the w
    recurrence runs in H's fast dtype, seeded by the f64 RR residual
    vectors R — but every H·w is the software-pipelined ring collective
    matmul, so a DP grid solve keeps the explicit-overlap schedule on its
    production (refinement ladder) path.  H in P(axis, None) reduced-dtype
    shadow; V, R in P(axis); tables replicated.
    """
    from ..types import filter_carry_dtype, real_dtype as _rdt

    mesh = grid.mesh
    p = mesh.shape[axis]
    out_dtype = V.dtype
    carry_dt = filter_carry_dtype(H.dtype, V.dtype)
    rt = _rdt(carry_dt)
    rtv = _rdt(out_dtype)

    a1 = jnp.asarray(alpha1_e, rt)
    al = jnp.asarray(alphas, rt)
    be = jnp.asarray(betas, rt)
    injt = jnp.asarray(inj, rt)
    pf = jnp.asarray(p_final, rtv)
    ccv = jnp.asarray(cc, rt)
    deg_max = jnp.asarray(deg_max, jnp.int32)

    def local(h, v, r, degs, al, be, injt, pf):
        def ring_dot(w):
            return _ring_dot_1d(h, w, axis=axis, p=p, acc_dt=carry_dt,
                                precision=precision)

        rc = r.astype(carry_dt)
        W = a1 * rc

        def body(t, st):
            Wp, Wc = st
            Z = (al[t] * (ring_dot(Wc) - ccv * Wc) + be[t] * Wp
                 + injt[t][None, :] * rc)
            Z = jnp.where(degs[None, :] >= t, Z, Wc)
            return (Wc, Z)

        _, W = jax.lax.fori_loop(2, deg_max + 1, body,
                                 (jnp.zeros_like(rc), W))
        Y = pf[None, :] * v + W.astype(out_dtype)
        return jnp.where(degs[None, :] >= 1, Y, v)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis, None), P(axis, None), P(axis, None),
                             P(), P(), P(), P(), P()),
                   out_specs=P(axis, None))
    return fn(H, V, R, degrees, al, be, injt, pf)


@partial(jax.jit, static_argnames=("grid", "precision"))
def chebyshev_filter_refine_ring2d(grid, H, V, R, degrees, alpha1_e, alphas,
                                   betas, inj, p_final, cc, deg_max, *,
                                   precision="highest"):
    """Deviation-form refinement filter as the 2D ping-pong ring (P4 + P10
    + P11).  The w recurrence alternates parities exactly like
    chebyshev_filter_ring2d; the constant injection vectors R are kept in
    BOTH parities (one fixed transpose ppermute up front) so each substep
    injects in its output parity.  V enters/exits in parity A
    (``P(('c','r'))`` chunk order).  Requires N divisible by r·c.
    """
    from ..types import filter_carry_dtype, real_dtype as _rdt

    mesh = grid.mesh
    pr = mesh.shape["r"]
    pc = mesh.shape["c"]
    out_dtype = V.dtype
    carry = filter_carry_dtype(H.dtype, V.dtype)
    rt = _rdt(carry)
    rtv = _rdt(out_dtype)

    a1 = jnp.asarray(alpha1_e, rt)
    al = jnp.asarray(alphas, rt)
    be = jnp.asarray(betas, rt)
    injt = jnp.asarray(inj, rt)
    pf = jnp.asarray(p_final, rtv)
    ccv = jnp.asarray(cc, rt)
    deg_max = jnp.asarray(deg_max, jnp.int32)
    flip_a2b = [(i * pc + j, j * pr + i)
                for i in range(pr) for j in range(pc)]
    flip_b2a = [(m, (m % pr) * pc + (m // pr)) for m in range(pr * pc)]

    def local(h, v, r, degs, al, be, injt, pf):
        ringA2, ringB2 = _ring2d_pair(pr, pc, carry, precision)
        ring_A = lambda w: ringA2(h, w)    # noqa: E731
        ring_B = lambda w: ringB2(h, w)    # noqa: E731

        rc_A = r.astype(carry)
        rc_B = jax.lax.ppermute(rc_A, ("r", "c"), flip_a2b)

        def substep(t, Wp, Wc, ring, flip_perm, rc_out):
            """w-recurrence step with parity-matched injection."""
            flipped = jax.lax.ppermute(Wc, ("r", "c"), flip_perm)
            hw = ring(Wc)
            Z = (al[t] * (hw - ccv * flipped) + be[t] * Wp
                 + injt[t][None, :] * rc_out)
            return jnp.where(degs[None, :] >= t, Z, flipped)

        # step 1 (A→B): w₁ = (σ1/e)·r, flipped into parity B (deg-0 columns
        # are overwritten by the final combine, so w1 needs no mask)
        W = jax.lax.ppermute(a1 * rc_A, ("r", "c"), flip_a2b)

        def pair(s, st):
            Wp, Wc = st
            t2 = 2 + 2 * s
            Z2 = substep(t2, Wp, Wc, ring_B, flip_b2a, rc_A)    # B→A
            Z3 = substep(t2 + 1, Wc, Z2, ring_A, flip_a2b, rc_B)  # A→B
            return (Z2, Z3)

        n_pairs = deg_max // 2
        # carry is (w_{t-1}, w_t) with w_{t-1} in the OPPOSITE parity;
        # w_0 = 0 sits in parity A (zero content is parity-invariant)
        _, W = jax.lax.fori_loop(0, n_pairs, pair,
                                 (jnp.zeros_like(rc_A), W))
        # exits in parity B → flip home to A, combine in problem precision
        Wh = jax.lax.ppermute(W, ("r", "c"), flip_b2a).astype(out_dtype)
        Y = pf[None, :] * v + Wh
        return jnp.where(degs[None, :] >= 1, Y, v)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("r", "c"), P(("c", "r"), None),
                             P(("c", "r"), None), P(), P(), P(), P(), P()),
                   out_specs=P(("c", "r"), None))
    return fn(H, V, R, degrees, al, be, injt, pf)


@partial(jax.jit, static_argnames=("grid", "axis", "precision"))
def chebyshev_filter_h2_ring(grid, H, X, degrees, lam1, lower, upper,
                             deg_max, *, axis: str = "r",
                             precision="highest"):
    """Pseudo-Hermitian H² Chebyshev filter with the 1D ring HEMM (P11 for
    the BSE path).  Each recurrence step applies H twice through the
    software-pipelined ring; the interval shift is folded into the epilogue
    exactly like ops.pseudo.chebyshev_filter_h2 (no shift of H).  The
    filter itself involves no S-metric work, so the ring needs no
    half-split awareness.  H in P(axis, None), X in P(axis).  H may be a
    reduced-precision shadow (mixed precision / bf16 rung): the carry
    follows ``filter_carry_dtype`` like the Hermitian ring."""
    from ..types import filter_carry_dtype, real_dtype as _rdt

    mesh = grid.mesh
    p = mesh.shape[axis]
    out_dtype = X.dtype
    carry_dt = filter_carry_dtype(H.dtype, X.dtype)
    rt = _rdt(carry_dt)

    lam1 = jnp.asarray(lam1, rt)
    lo = jnp.minimum(jnp.asarray(lower, rt), jnp.asarray(upper, rt))
    up = jnp.maximum(jnp.asarray(lower, rt), jnp.asarray(upper, rt))
    c = (up + lo) / 2
    e = (up - lo) / 2
    sigma1 = e / (lam1 - c)
    deg_max = jnp.asarray(deg_max, jnp.int32)

    def local(h, x, degs):
        x0 = x
        x = x.astype(carry_dt)

        def ring_dot(v):
            return _ring_dot_1d(h, v, axis=axis, p=p, acc_dt=carry_dt,
                                precision=precision)

        def h2_shift(v):
            return ring_dot(ring_dot(v)) - c * v

        Y = (sigma1 / e) * h2_shift(x)
        Y = jnp.where(degs[None, :] >= 1, Y, x)

        def body(t, carry):
            Xp, Yc, sigma = carry
            tau = 1.0 / (2.0 / sigma1 - sigma)
            Z = (2.0 * tau / e) * h2_shift(Yc) - (sigma * tau) * Xp
            Z = jnp.where(degs[None, :] >= t, Z, Yc)
            return (Yc, Z, tau)

        _, Y, _ = jax.lax.fori_loop(2, deg_max + 1, body, (x, Y, sigma1))
        return jnp.where(degs[None, :] >= 1, Y.astype(out_dtype), x0)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis, None), P(axis, None), P()),
                   out_specs=P(axis, None))
    return fn(H, X, degrees)


@partial(jax.jit, static_argnames=("grid", "precision"))
def chebyshev_filter_h2_ring2d(grid, H, X, degrees, lam1, lower, upper,
                               deg_max, *, precision="highest"):
    """H² filter as the 2D ping-pong ring (P4 + P11, BSE path).

    One H² application is a FULL parity round-trip — ring_A (A→B) then
    ring_B (B→A) — so every recurrence step starts and ends in parity A
    and the shift/beta/mask terms need no flips at all (simpler than the
    Hermitian single-H schedule).  Requires N divisible by r·c.
    """
    mesh = grid.mesh
    pr = mesh.shape["r"]
    pc = mesh.shape["c"]
    out_dtype = X.dtype
    from ..types import filter_carry_dtype, real_dtype as _rdt
    carry_dt = filter_carry_dtype(H.dtype, X.dtype)
    rt = _rdt(carry_dt)

    lam1 = jnp.asarray(lam1, rt)
    lo = jnp.minimum(jnp.asarray(lower, rt), jnp.asarray(upper, rt))
    up = jnp.maximum(jnp.asarray(lower, rt), jnp.asarray(upper, rt))
    c = (up + lo) / 2
    e = (up - lo) / 2
    sigma1 = e / (lam1 - c)
    deg_max = jnp.asarray(deg_max, jnp.int32)

    def local(h, x, degs):
        nch = x.shape[0]
        i = jax.lax.axis_index("r")
        j = jax.lax.axis_index("c")
        x0 = x
        x = x.astype(carry_dt)
        ringA2, ringB2 = _ring2d_pair(pr, pc, carry_dt, precision)
        ring_A = lambda v: ringA2(h, v)    # noqa: E731
        # ring_B computes Hᴴ·v for a parity-B block (Hermitian-schedule step)
        ring_B = lambda v: ringB2(h, v)    # noqa: E731

        half = (nch * pr * pc) // 2                  # N/2 (static)

        def s_flip_B(v):
            """S·v for a parity-B local chunk (global rows i·pc+j)."""
            chunk = i * pc + j
            grows = chunk * nch + jnp.arange(nch)
            return jnp.where((grows >= half)[:, None], -v, v)

        def s_flip_A(v):
            """S·v for a parity-A local chunk (global rows j·pr+i)."""
            chunk = j * pr + i
            grows = chunk * nch + jnp.arange(nch)
            return jnp.where((grows >= half)[:, None], -v, v)

        def h2_shift(v):
            # pseudo-Hermitian H is NOT Hermitian: the parity-B step
            # computes Hᴴw, and Hᴴ = S·H·S (pseudo-Hermiticity), so
            # H²v = S·Hᴴ·S·(Hv) with parity-matched S flips
            w1 = ring_A(v)                    # H·v      (A→B)
            w2 = ring_B(s_flip_B(w1))         # Hᴴ·S·Hv  (B→A)
            return s_flip_A(w2) - c * v       # S·Hᴴ·S·Hv = H²v

        Y = (sigma1 / e) * h2_shift(x)
        Y = jnp.where(degs[None, :] >= 1, Y, x)

        def body(t, carry):
            Xp, Yc, sigma = carry
            tau = 1.0 / (2.0 / sigma1 - sigma)
            Z = (2.0 * tau / e) * h2_shift(Yc) - (sigma * tau) * Xp
            Z = jnp.where(degs[None, :] >= t, Z, Yc)
            return (Yc, Z, tau)

        _, Y, _ = jax.lax.fori_loop(2, deg_max + 1, body, (x, Y, sigma1))
        return jnp.where(degs[None, :] >= 1, Y.astype(out_dtype), x0)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("r", "c"), P(("c", "r"), None), P()),
                   out_specs=P(("c", "r"), None))
    return fn(H, X, degrees)


@partial(jax.jit, static_argnames=("grid", "axis", "precision"))
def chebyshev_filter_refine_h2_ring(grid, H, V, R2, degrees, alpha1_e,
                                    alphas, betas, inj, p_final, cc,
                                    deg_max, *, axis: str = "r",
                                    precision="highest"):
    """Deviation-form H² refinement filter with the 1D ring HEMM — the BSE
    DP ladder on grids (P10 × P11 for the pseudo path).

    Same injection algebra as ops.pseudo.chebyshev_filter_refine_h2 (the w
    recurrence in H's fast dtype, seeded by the f64 H²-residual vectors
    R2), with each H² application expressed as two software-pipelined ring
    passes.  H in P(axis, None) reduced-dtype shadow; V, R2 in P(axis);
    tables replicated.
    """
    from ..types import filter_carry_dtype, real_dtype as _rdt

    mesh = grid.mesh
    p = mesh.shape[axis]
    out_dtype = V.dtype
    carry_dt = filter_carry_dtype(H.dtype, V.dtype)
    rt = _rdt(carry_dt)
    rtv = _rdt(out_dtype)

    a1 = jnp.asarray(alpha1_e, rt)
    al = jnp.asarray(alphas, rt)
    be = jnp.asarray(betas, rt)
    injt = jnp.asarray(inj, rt)
    pf = jnp.asarray(p_final, rtv)
    ccv = jnp.asarray(cc, rt)
    deg_max = jnp.asarray(deg_max, jnp.int32)

    def local(h, v, r, degs, al, be, injt, pf):
        def ring_dot(w):
            return _ring_dot_1d(h, w, axis=axis, p=p, acc_dt=carry_dt,
                                precision=precision)

        def h2_shift(w):
            return ring_dot(ring_dot(w)) - ccv * w

        rc = r.astype(carry_dt)
        W = a1 * rc

        def body(t, st):
            Wp, Wc = st
            Z = (al[t] * h2_shift(Wc) + be[t] * Wp
                 + injt[t][None, :] * rc)
            Z = jnp.where(degs[None, :] >= t, Z, Wc)
            return (Wc, Z)

        _, W = jax.lax.fori_loop(2, deg_max + 1, body,
                                 (jnp.zeros_like(rc), W))
        Y = pf[None, :] * v + W.astype(out_dtype)
        return jnp.where(degs[None, :] >= 1, Y, v)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis, None), P(axis, None), P(axis, None),
                             P(), P(), P(), P(), P()),
                   out_specs=P(axis, None))
    return fn(H, V, R2, degrees, al, be, injt, pf)


@partial(jax.jit, static_argnames=("grid", "precision"))
def chebyshev_filter_refine_h2_ring2d(grid, H, V, R2, degrees, alpha1_e,
                                      alphas, betas, inj, p_final, cc,
                                      deg_max, *, precision="highest"):
    """Deviation-form H² refinement filter as the 2D ping-pong ring.

    One H² application is a full parity round-trip (ring_A then the
    S-flip-corrected ring_B, like chebyshev_filter_h2_ring2d), so every
    recurrence step starts and ends in parity A — injection, masks and the
    final combine all live in parity A with no extra flips.  Requires N
    divisible by r·c.
    """
    from ..types import filter_carry_dtype, real_dtype as _rdt

    mesh = grid.mesh
    pr = mesh.shape["r"]
    pc = mesh.shape["c"]
    out_dtype = V.dtype
    carry_dt = filter_carry_dtype(H.dtype, V.dtype)
    rt = _rdt(carry_dt)
    rtv = _rdt(out_dtype)

    a1 = jnp.asarray(alpha1_e, rt)
    al = jnp.asarray(alphas, rt)
    be = jnp.asarray(betas, rt)
    injt = jnp.asarray(inj, rt)
    pf = jnp.asarray(p_final, rtv)
    ccv = jnp.asarray(cc, rt)
    deg_max = jnp.asarray(deg_max, jnp.int32)

    def local(h, v, r, degs, al, be, injt, pf):
        nch = v.shape[0]
        i = jax.lax.axis_index("r")
        j = jax.lax.axis_index("c")
        ringA2, ringB2 = _ring2d_pair(pr, pc, carry_dt, precision)
        ring_A = lambda w: ringA2(h, w)    # noqa: E731
        ring_B = lambda w: ringB2(h, w)    # noqa: E731

        half = (nch * pr * pc) // 2                  # N/2 (static)

        def s_flip_B(w):
            chunk = i * pc + j
            grows = chunk * nch + jnp.arange(nch)
            return jnp.where((grows >= half)[:, None], -w, w)

        def s_flip_A(w):
            chunk = j * pr + i
            grows = chunk * nch + jnp.arange(nch)
            return jnp.where((grows >= half)[:, None], -w, w)

        def h2_shift(w):
            # Hᴴ = S·H·S (pseudo-Hermiticity): H²w = S·Hᴴ·S·(Hw)
            w1 = ring_A(w)                    # H·w      (A→B)
            w2 = ring_B(s_flip_B(w1))         # Hᴴ·S·Hw  (B→A)
            return s_flip_A(w2) - ccv * w

        rc = r.astype(carry_dt)
        W = a1 * rc

        def body(t, st):
            Wp, Wc = st
            Z = (al[t] * h2_shift(Wc) + be[t] * Wp
                 + injt[t][None, :] * rc)
            Z = jnp.where(degs[None, :] >= t, Z, Wc)
            return (Wc, Z)

        _, W = jax.lax.fori_loop(2, deg_max + 1, body,
                                 (jnp.zeros_like(rc), W))
        Y = pf[None, :] * v + W.astype(out_dtype)
        return jnp.where(degs[None, :] >= 1, Y, v)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("r", "c"), P(("c", "r"), None),
                             P(("c", "r"), None), P(), P(), P(), P(), P()),
                   out_specs=P(("c", "r"), None))
    return fn(H, V, R2, degrees, al, be, injt, pf)
