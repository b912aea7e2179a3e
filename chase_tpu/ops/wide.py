"""f64-accurate matmul from integer/bf16 matmuls (Ozaki-scheme slicing).

An opt-in path (``wide_f64='on'``): every supported platform has native f64
GEMMs (FP64 tensor cores on the H100), so the solver uses them by default.
This module builds a genuinely f64-accurate GEMM from int8 or bf16 matmuls,
using the error-free slicing of Ozaki et al. ("Error-free transformations
of matrix multiplication", Numer. Algorithms 2012; the int8/tensor-core
variant is Ootomo/Ozaki/Yokota 2024), kept for A/B runs against the native
f64 path.

Two schemes, selected by wide_scheme_auto (the slice dtype rides in the
H_wide tuple, so consumers are scheme-agnostic):

* **"i8" (default)** — s=6-bit integer slices stored as int8, pair
  products as int8 matmuls with the contraction chunked at 1024 so every
  partial sum stays inside the 24-bit exact window however the backend
  accumulates (int32 inter-chunk accumulator, exact to N ≤ 2¹⁷).  8
  slices = 48 operand bits, 36 passes at the int8 rate, 1 byte/slice:
  half the bf16 scheme's passes and memory, accuracy ~8e-15.
* **"bf16"** — the scheme below, for backends without usable int8
  matmuls (CHASE_WIDE_SCHEME=bf16) or awkward contraction lengths:

1. scale rows of A (columns of B) by a power of two so each lies in
   [-1, 1),
2. split every element into ``L`` slices of ``s`` mantissa bits:
   ``A = Σ_l A_l`` with each ``A_l = m·2^(-s(l+1))``, ``|m| ≤ 2^s`` an
   integer — **exactly representable in bf16** for s ≤ 8,
3. compute the pair products ``A_l·B_m`` as bf16×bf16→f32 matmuls.  With
   ``2s + log2(N) ≤ 24`` every partial product and every partial sum is an
   integer scaled by a fixed power of two below the f32 mantissa limit, so
   the matmul accumulation is **exact** — no rounding anywhere,
4. sum the O(L²/2) pair products (only ``l+m ≤ cut`` matter) in f64
   elementwise and undo the two-sided scaling.

Accuracy: truncation only — worst case ``N·2^(-s·L)`` relative to
``max|row|·max|col|`` (stochastically ``√N·2^(-s·L)`` ≈ 1e-15 at the
default 55 bits).  Cost: ``npairs`` bf16 passes (66 at N=8192).

The reference's DP compute path calls vendor f64 BLAS instead
(e.g. Impl/chase_cpu/chase_cpu.hpp:449-508); the solver routes the f64
HEMMs inside RR/QR here only under ``wide_f64='on'``.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["wide_matmul", "wide_params", "slice_f64", "wide_matmul_sliced",
           "wide_params_i8", "slice_f64_i8", "wide_scheme_auto"]


def wide_scheme_auto(n_contract: int) -> str:
    """Pick the slice scheme for a contraction length.

    "i8" (Ootomo/Ozaki/Yokota-style int8 slices, chunked exact
    accumulation) dominates "bf16" everywhere it applies: 6 bits per ONE
    byte vs the bf16 scheme's s = (24 − log2 N)/2 bits per TWO bytes — at
    N=8192 that is 36 int8 passes at 2× the bf16 rate vs 66 bf16 passes,
    and the window reaches N ≤ 2¹⁷
    at fixed s instead of shrinking s as N grows (at N=30000 the bf16
    scheme is down to s=4: 105 passes and a 25 GB operator stack vs
    int8's 36 passes and 7.2 GB).  bf16 remains for backends without
    int8 matmul (CHASE_WIDE_SCHEME=bf16 forces it).
    """
    import os
    forced = os.environ.get("CHASE_WIDE_SCHEME")
    if forced in ("bf16", "i8"):
        return forced
    try:
        wide_params_i8(n_contract)
        # awkward contraction lengths (large prime factors) would force
        # tiny exactness chunks — the bf16 scheme handles those
        if _i8_contract_chunk(n_contract) >= 256:
            return "i8"
    except ValueError:
        pass
    return "bf16"


def wide_params_i8(n_contract: int, target_bits: int = 48):
    """(s, L, cut) for the int8 slice scheme.

    s=6 bits per slice: the ideal slice values are |m| ≤ 2^(s−1)·2 = 64
    (operand scaled into [−0.5, 0.5) with one guard bit), and the int8 range
    ±127 leaves ~2 integer units of headroom for backends whose f64 ``round``
    is inexact (at s=7 such entries would clip and cascade).  48 operand
    bits (L=8) bound truncation at √N·2⁻⁴⁸ ≈ 6e-13 relative at N=30000 —
    comfortably under the 1e-10 DP target — while the resident operator
    stack stays 1 byte/slice.
    """
    lg = max(1, math.ceil(math.log2(max(2, n_contract))))
    s = 6
    if lg > 17:       # 128 exact 2^10 chunks on the int32 accumulator
        raise ValueError(
            f"contraction length {n_contract} too large for exact int8 "
            f"slicing (chunked accumulation covers N <= 2^17)")
    L = math.ceil(target_bits / s)
    cut = L - 1
    return s, L, cut


def wide_params(n_contract: int, target_bits: int = 55):
    """Pick (s, L, cut) for a contraction length ``n_contract``.

    s: slice mantissa bits — largest with 2s + ceil(log2 N) ≤ 24 (exact f32
       accumulation), capped at 8 (bf16 mantissa).
    L: number of slices covering ``target_bits`` of each operand.
    cut: keep pair products with l+m ≤ cut (scale 2^(-s(l+m+2)) just below
       the per-operand truncation floor).
    """
    lg = max(1, math.ceil(math.log2(max(2, n_contract))))
    s = min(8, (24 - lg) // 2)
    if s < 2:
        raise ValueError(
            f"contraction length {n_contract} too large for exact bf16/f32 "
            f"slicing (needs 2s + log2 N <= 24)")
    L = math.ceil(target_bits / s)
    cut = L - 1          # pairs l+m ≤ L-1: finest kept scale 2^(-s(L+1))
    return s, L, cut


def _pow2_scale(X, axis):
    """Per-row/col power-of-two scale putting max|X| into [0.5, 1)."""
    mx = jnp.max(jnp.abs(X), axis=axis, keepdims=True)
    e = jnp.ceil(jnp.log2(jnp.where(mx > 0, mx, jnp.ones_like(mx))))
    sc = jnp.exp2(e)
    return jnp.where(mx > 0, sc, jnp.ones_like(sc))


def slice_f64(X, s, L, axis):
    """Split f64 X into L exact bf16 slices along with the 2^e scale.

    Returns (slices, scale): slices is an (L,)-list of bf16 arrays with
    ``X ≈ scale · Σ_l slices[l]``; the l-th slice holds s-bit integers
    scaled by 2^(-s(l+1)).  All slice arithmetic is f64 elementwise
    (round/subtract are exact — no accumulation involved).
    ``axis``: the non-contraction axis (1 for the left operand's rows,
    0 for the right operand's columns).
    """
    scale = _pow2_scale(X, axis=axis)
    r = X / scale
    slices = []
    for l in range(L):
        p = jnp.exp2(jnp.asarray(float(s * (l + 1)), X.dtype))
        q = jnp.round(r * p) / p
        slices.append(q.astype(jnp.bfloat16))
        r = r - q
    return slices, scale


def slice_f64_i8(X, s, L, axis):
    """Split f64 X into L exact INT8 slices plus the 2^e scale.

    ``X ≈ scale · Σ_l slices[l] · 2^(−s(l+1))`` with integer slices
    |m| ≤ 2^(s−1) (scale puts max|X| in [0.25, 0.5) so slice 0 needs no
    clamp and every later residual obeys |r| ≤ 0.5·2^(−s·l)).  All slice
    arithmetic is f64 elementwise — exact.
    """
    scale = 2.0 * _pow2_scale(X, axis=axis)     # max|X/scale| ∈ [0.25, 0.5)
    step = float(2 ** s)

    # Incremental form u_{l+1} = (u_l − m_l)·2^s (u_0 = X/scale·2^s):
    # multiplies by the small exact constant 2^s instead of device exp2 of
    # growing powers, and runs as ONE lax.scan so the chain's f64
    # temporaries stay bounded (the unrolled version held O(L) N-sized
    # temps — a device-memory spike next to a resident slice stack).
    #
    # Clip BEFORE both store and subtract: on backends with inexact f64
    # elementwise arithmetic the chain can wander past ±2^(s−1); the
    # f64→int8 cast would WRAP.  A
    # clipped value keeps the chain self-consistent — accuracy floors at
    # the device's effective f64 fidelity, same as the bf16 scheme.  The
    # ±127 bound is what sizes _i8_contract_chunk.
    def body(u, _):
        m = jnp.clip(jnp.round(u), -127.0, 127.0)
        return (u - m) * step, m.astype(jnp.int8)

    _, ms = jax.lax.scan(body, (X / scale) * step, None, length=L)
    return [ms[l] for l in range(L)], scale


def slice_f64_i8_host(X, s, L):
    """Exact HOST (numpy) int8 slicing of a real f64 operator row-block —
    full 56-bit fidelity regardless of the device's f64 arithmetic.
    Returns (slices list of int8 ndarrays, scale (rows,1) f64)."""
    X = np.asarray(X, np.float64)
    mx = np.max(np.abs(X), axis=1, keepdims=True)
    e = np.ceil(np.log2(np.where(mx > 0, mx, 1.0)))
    scale = 2.0 * np.where(mx > 0, np.exp2(e), 1.0)
    step = float(2 ** s)
    u = (X / scale) * step
    slices = []
    for l in range(L):
        m = np.clip(np.round(u), -127.0, 127.0)
        slices.append(m.astype(np.int8))
        u = (u - m) * step
    return slices, scale


def _i8_contract_chunk(n: int, s: int = 7) -> int:
    """Largest divisor of ``n`` whose int8 pair-product partial sums stay
    ≤ 2²⁴ — exact even when a backend lowers int8 dots through f32
    accumulation instead of true int32.  Slice values are clipped to
    ±127 (slice_f64_i8), so products are < 2¹⁴ and chunks of 2¹⁰ keep
    every partial sum within the 24-bit exact-f32 window."""
    limit = 1 << (24 - 14)        # products bounded by the ±127 slice clip
    if n <= limit:
        return n
    for d in range(limit, 0, -1):
        if n % d == 0:
            return d
    return 1


def _pair_products_i8(a_slices, b_stack, cut, s):
    """Σ over l+m ≤ cut of int8 pair matmuls, exact by construction:
    the contraction runs in ≤2^(24−2(s−1)) chunks whose products are
    exactly representable however the backend accumulates (int32 or
    f32 — see _i8_contract_chunk), inter-chunk sums ride an int32
    accumulator (exact to 127 chunks ≈ n ≤ 5·10⁵), and the final pair
    value is rescaled and summed in f64.  Same one-live-product loop
    structure as :func:`_pair_products`."""
    L = b_stack.shape[0]
    rows = a_slices[0].shape[0]
    n = b_stack.shape[1]
    k = b_stack.shape[2]
    chunk = _i8_contract_chunk(n, s)
    nc = n // chunk
    acc = jnp.zeros((rows, k), jnp.float64)
    for l, al in enumerate(a_slices):
        hi = min(cut - l + 1, L)
        if hi <= 0:
            continue

        def body(m, a, al=al, l=l):
            if nc == 1:
                p32 = jnp.matmul(al, b_stack[m],
                                 preferred_element_type=jnp.int32)
            else:
                def cbody(c, acc32):
                    off = (c * chunk).astype(jnp.int32)
                    ap = jax.lax.dynamic_slice(
                        al, (jnp.int32(0), off), (rows, chunk))
                    bp = jax.lax.dynamic_slice(
                        b_stack[m], (off, jnp.int32(0)), (chunk, k))
                    return acc32 + jnp.matmul(
                        ap, bp, preferred_element_type=jnp.int32)

                p32 = jax.lax.fori_loop(
                    0, nc, cbody, jnp.zeros((rows, k), jnp.int32))
            sc = jnp.exp2((-s * (m + l + 2)).astype(jnp.float64))
            return a + p32.astype(jnp.float64) * sc

        acc = jax.lax.fori_loop(0, hi, body, acc)
    return acc


def _pair_products(a_slices, b_slices, cut):
    """Σ over l+m ≤ cut of the exact bf16 pair matmuls, f64 accumulation.

    The m-loop is a ``fori_loop`` over the STACKED right-operand slices so
    only ONE pair product is live at a time — a balanced sum tree keeps
    all O(L²/2) (rows, k) products resident simultaneously and runs out
    of device memory at large N.  The right
    stack is cheap ((L, n, k) with k ≪ n); the big left slices stay a
    Python-indexed list and are never copied."""
    L = len(b_slices)
    B = jnp.stack(b_slices)                       # (L, n, k) — k cols only
    rows = a_slices[0].shape[0]
    k = b_slices[0].shape[1]
    acc = jnp.zeros((rows, k), jnp.float64)
    for l, al in enumerate(a_slices):
        hi = min(cut - l + 1, L)
        if hi <= 0:
            continue

        def body(m, a, al=al):
            p = jnp.matmul(al, B[m], precision="default",
                           preferred_element_type=jnp.float32)
            return a + p.astype(jnp.float64)

        acc = jax.lax.fori_loop(0, hi, body, acc)
    return acc


@partial(jax.jit, static_argnames=("s", "L", "cut", "scheme"))
def _wide_matmul_impl(A, B, *, s, L, cut, scheme="bf16"):
    if scheme == "i8":
        a_slices, sa = slice_f64_i8(A, s, L, axis=1)
        b_slices, sb = slice_f64_i8(B, s, L, axis=0)
        C = _pair_products_i8(a_slices, jnp.stack(b_slices), cut, s)
    else:
        a_slices, sa = slice_f64(A, s, L, axis=1)
        b_slices, sb = slice_f64(B, s, L, axis=0)
        C = _pair_products(a_slices, b_slices, cut)
    return C * sa * sb


def wide_matmul(A, B, *, target_bits: int = 55, scheme: str = "auto"):
    """f64-accurate ``A @ B`` via exact slice products (see module
    docstring).  Real f64 operands only; 2-D × 2-D.  ``scheme``: "i8"
    (default through "auto" — fewer passes, 2× the bf16 rate, exact to
    N ≤ 2¹⁹) or "bf16" (CHASE_WIDE_SCHEME=bf16 forces the latter
    everywhere, e.g. for backends without int8 matmul)."""
    if A.dtype != jnp.float64 or B.dtype != jnp.float64:
        raise TypeError(f"wide_matmul is for f64 operands, got "
                        f"{A.dtype} @ {B.dtype}")
    n = A.shape[-1]
    if scheme == "auto":
        scheme = wide_scheme_auto(n)
    params = wide_params_i8 if scheme == "i8" else wide_params
    s, L, cut = params(n, target_bits)
    return _wide_matmul_impl(A, B, s=s, L=L, cut=cut, scheme=scheme)


@partial(jax.jit, static_argnames=("s", "L", "cut"))
def _wide_matmul_presliced(a_slices, sa, B, *, s, L, cut):
    """A@B with A pre-sliced — scheme inferred from the slice dtype, so
    every consumer of a DenseOperator.H_wide tuple works with either."""
    if a_slices[0].dtype == jnp.int8:
        b_slices, sb = slice_f64_i8(B, s, L, axis=0)
        C = _pair_products_i8(a_slices, jnp.stack(b_slices), cut, s)
    else:
        b_slices, sb = slice_f64(B, s, L, axis=0)
        C = _pair_products(a_slices, b_slices, cut)
    return C * sa * sb


@partial(jax.jit, static_argnames=("s", "L", "cut"))
def _wide_gram_impl(V, *, s, L, cut):
    b_slices, sb = slice_f64_i8(V, s, L, axis=0)
    bst = jnp.stack(b_slices)
    a_slices = [bst[l].T for l in range(L)]
    G = _pair_products_i8(a_slices, bst, cut, s)
    return G * sb.T * sb


def wide_gram(V, *, target_bits: int = 48):
    """f64-accurate Gram VᵀV with V sliced ONCE (the left operand is the
    transposed slice set — XLA feeds transposed int8 operands straight to
    the matmul).  Halves the slicing work and skips the explicit Vᵀ copy
    vs ``wide_matmul(V.T, V)``, which lowers the QR Gram's peak memory.
    Real f64, i8 scheme."""
    if V.dtype != jnp.float64:
        raise TypeError(f"wide_gram is for f64 operands, got {V.dtype}")
    s, L, cut = wide_params_i8(V.shape[0], target_bits)
    return _wide_gram_impl(V, s=s, L=L, cut=cut)


def wide_matmul_sliced(a_sliced, B, *, target_bits: int = 55):
    """``A @ B`` with A pre-sliced by :func:`presplit` (amortizes the
    operator split across filter/RR calls).  Scheme follows the slice
    dtype."""
    a_slices, sa, s, L = a_sliced
    n = B.shape[0]
    params = wide_params_i8 if a_slices[0].dtype == jnp.int8 \
        else wide_params
    s2, L2, cut = params(n, target_bits)
    if s2 != s:
        raise ValueError(f"presplit used s={s} but contraction {n} "
                         f"needs s={s2}")
    return _wide_matmul_presliced(tuple(a_slices), sa, B,
                                  s=s, L=min(L, L2), cut=cut)


def presplit(A, *, target_bits: int = 55, scheme: str = "auto"):
    """Slice a static operator once (cached per DenseOperator): returns
    the opaque tuple wide_matmul_sliced consumes."""
    if scheme == "auto":
        scheme = wide_scheme_auto(A.shape[-1])
    if scheme == "i8":
        s, L, _ = wide_params_i8(A.shape[-1], target_bits)
        a_slices, sa = slice_f64_i8(A, s, L, axis=1)
    else:
        s, L, _ = wide_params(A.shape[-1], target_bits)
        a_slices, sa = slice_f64(A, s, L, axis=1)
    return (tuple(a_slices), sa, s, L)


@partial(jax.jit, static_argnames=("s", "L", "scheme"))
def _presplit_shadow(H, *, s, L, scheme="bf16"):
    low = H.astype(jnp.float32)
    sl_fn = slice_f64_i8 if scheme == "i8" else slice_f64
    slices, sa = sl_fn(H, s, L, axis=1)
    return tuple(slices), sa, low


@partial(jax.jit, static_argnames=("s", "nsl", "out_dtype"))
def shadow_from_slices(slices, sa, *, s, nsl, out_dtype=jnp.float32):
    """Reduced-precision shadow of the operator reconstructed from its top
    int8 slices (nsl*s bits of mantissa).  Lets large-N wide solves keep the
    shadow TRANSIENT: rebuilt for the filter phase, freed for RR/QR (and no
    4-byte host upload at engage time).  The accumulate + final ``out_dtype``
    cast live in ONE program so a bf16 shadow never materializes an f32
    intermediate."""
    acc = jnp.zeros(slices[0].shape, jnp.float32)
    for l in range(nsl):
        acc = acc + slices[l].astype(jnp.float32) \
            * np.float32(2.0 ** (-s * (l + 1)))
    return (acc * sa.astype(jnp.float32)).astype(out_dtype)


@partial(jax.jit, donate_argnums=(0,))
def _write_rows(buf, part, i):
    """Write a row block into a DONATED buffer (in-place under XLA)."""
    return jax.lax.dynamic_update_slice(buf, part, (i, jnp.int32(0)))


@partial(jax.jit, static_argnames=("s", "L", "scheme"), donate_argnums=0)
def _presplit_shadow_donate(H, *, s, L, scheme="bf16"):
    low = H.astype(jnp.float32)
    sl_fn = slice_f64_i8 if scheme == "i8" else slice_f64
    slices, sa = sl_fn(H, s, L, axis=1)
    return tuple(slices), sa, low


def presplit_and_shadow_chunked(H_host, *, target_bits: int = 55,
                                row_chunk: int = None,
                                scheme: str = "auto",
                                want_low: bool = True):
    """Row-chunked :func:`presplit_and_shadow` from a HOST array.

    The one-shot donating program's unrolled round/subtract slice chain
    keeps ~20 N²-sized f32 temporaries live at once.  The per-row 2^e scaling
    makes slicing embarrassingly row-parallel, so this variant uploads and
    slices H in ~256 MB row blocks: peak device memory is the slice stack +
    shadow (≈ (2L+4)/8 of the f64 operator) plus ONE chunk's temporaries,
    and the full 8-byte H never needs device residency at all.

    Returns (slices, sa, low, s, L) like :func:`presplit_and_shadow`.
    """
    N, n = H_host.shape
    if scheme == "auto":
        scheme = wide_scheme_auto(n)
    params = wide_params_i8 if scheme == "i8" else wide_params
    s, L, _ = params(n, target_bits)
    if row_chunk is None:
        row_chunk = max(512, (1 << 25) // max(1, n))   # ≈256 MB f64 chunks
    k = -(-N // row_chunk)
    chunk = -(-N // k)            # equalize (at most one ragged tail chunk)
    if scheme == "i8":
        # slice in exact HOST f64 (full operand bits) and ship the 1-byte
        # slices — exact whatever the device's f64 arithmetic, and the int8
        # upload is the same byte count as the f64 chunk anyway.  Chunks are
        # written into DONATED full-size buffers (XLA updates in place): the
        # concatenate alternative doubles peak device memory.
        # want_low=False skips the f32 shadow upload entirely — transient
        # shadow mode rebuilds it on device from the top slices.
        slices = [jnp.zeros((N, n), jnp.int8) for _ in range(L)]
        low = jnp.zeros((N, n), jnp.float32) if want_low else None
        sa = jnp.zeros((N, 1), jnp.float64)
        for i in range(0, N, chunk):
            Hc_np = np.ascontiguousarray(H_host[i:i + chunk])
            sl_np, sa_np = slice_f64_i8_host(Hc_np, s, L)
            for l in range(L):
                slices[l] = _write_rows(slices[l], jnp.asarray(sl_np[l]),
                                        jnp.int32(i))
            if want_low:
                low = _write_rows(low,
                                  jnp.asarray(Hc_np.astype(np.float32)),
                                  jnp.int32(i))
            sa = _write_rows(sa, jnp.asarray(sa_np), jnp.int32(i))
        return tuple(slices), sa, low, s, L

    parts_sl = [[] for _ in range(L)]
    parts_sa, parts_low = [], []
    for i in range(0, N, chunk):
        Hc_np = np.ascontiguousarray(H_host[i:i + chunk])
        Hc = jnp.asarray(Hc_np)
        sl, sa_c, low_c = _presplit_shadow_donate(Hc, s=s, L=L,
                                                  scheme=scheme)
        for l in range(L):
            parts_sl[l].append(sl[l])
        parts_sa.append(sa_c)
        parts_low.append(low_c)
    if k == 1:
        return tuple(p[0] for p in parts_sl), parts_sa[0], parts_low[0], s, L
    slices = []
    for l in range(L):
        slices.append(jnp.concatenate(parts_sl[l], axis=0))
        parts_sl[l].clear()       # free this slice's chunk buffers early
    sa = jnp.concatenate(parts_sa, axis=0)
    low = jnp.concatenate(parts_low, axis=0)
    return tuple(slices), sa, low, s, L


def presplit_and_shadow(H, *, donate: bool = False, target_bits: int = 55,
                        scheme: str = "auto"):
    """One jitted program producing BOTH the bf16 slice stack and the f32
    shadow of a real f64 operator.  With ``donate=True`` the input buffer
    is donated — XLA frees/reuses the 8-byte H during slicing and the
    caller drops its reference afterwards.  This is the large-N memory
    path: eager :func:`presplit` keeps H plus several f64 temporaries plus
    the slices live at once; a wide-mode solve never multiplies by f64 H
    again, so after this program the resident operator state is
    ``L·2 + 4`` bytes/element instead of ``L·2 + 12``.

    Returns (slices, sa, low, s, L).
    """
    if scheme == "auto":
        scheme = wide_scheme_auto(H.shape[-1])
    params = wide_params_i8 if scheme == "i8" else wide_params
    s, L, _ = params(H.shape[-1], target_bits)
    fn = _presplit_shadow_donate if donate else _presplit_shadow
    slices, sa, low = fn(H, s=s, L=L, scheme=scheme)
    return slices, sa, low, s, L
