"""Sharded dense operator.

JAX replacement for the reference's matrix containers
(``linalg/matrix/matrix.hpp`` Matrix<T,CPU|GPU> and
``linalg/distMatrix/distMatrix.hpp`` BlockBlock/BlockCyclic matrices):
one class that pins the dense operator H on the device grid and caches the
reduced-precision shadow copy used by the mixed-precision filter
(the enableSinglePrecision/disableSinglePrecision machinery of
matrix.hpp:365-443 becomes a single lazy ``astype``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import low_precision_dtype, real_dtype
from .mesh import Grid2D, matrix_sharding, colvec_sharding

__all__ = ["DenseOperator"]


class DenseOperator:
    """Dense (pseudo-)Hermitian operator resident on the device grid.

    When N is not divisible by the mesh tiling, the operator is padded to
    the next divisible size with decoupled diagonal entries at the
    Gershgorin upper bound — the phantom eigenvalues land above the whole
    spectrum, get damped by the filter like any unwanted eigenvalue, and
    never enter the wanted (lowest) set.  ``N_orig`` tracks the user size;
    the API slices eigenvectors back.
    """

    def __init__(self, H, grid: Optional[Grid2D] = None, *,
                 pseudo_hermitian: bool = False):
        if H.ndim != 2 or H.shape[0] != H.shape[1]:
            raise ValueError(f"H must be square, got {H.shape}")
        from ..device import check_platform
        check_platform()
        if np.dtype(H.dtype).itemsize >= 8 and np.dtype(H.dtype).kind in "fc" \
                and not jax.config.jax_enable_x64:
            # Without x64, jnp.asarray silently downcasts f64/c128 to 32 bits
            # and DP tolerances (1e-10) become unreachable.
            from ..logger import get_logger
            get_logger().info("enabling jax x64 for a 64-bit input matrix")
            jax.config.update("jax_enable_x64", True)
        self.grid = grid
        self.pseudo_hermitian = pseudo_hermitian
        self.N_orig = int(H.shape[0])
        # Re-materialization source + ownership for the wide-mode f64 drop
        # (engage_wide): we may donate/free the device f64 buffer only if WE
        # created it (host input) and can re-upload it on demand (no
        # padding transformed it).
        H_src = H
        self._owns_dev = not isinstance(H, jax.Array)

        N = self.N_orig
        self._pad_half = None   # (n_orig_half, padded_half) for pseudo pads
        if grid is not None:
            shape = grid.shape
            r, c = shape.get("r", 1), shape.get("c", 1)
            # Pad to a multiple of r·c, not lcm(r, c) — the 2D ping-pong
            # ring filters (parallel/ring.chebyshev_filter_ring2d and the
            # H² variants) need r·c | N, and lcm-padding would silently
            # disengage them (e.g. a 4×2 grid with N=1028 pads to 1028
            # under lcm=4).  The extra rows are O(r·c) — negligible.
            tile = r * c
            if pseudo_hermitian:
                # S-preserving pad: each half pads independently so the
                # metric S = diag(I, −I) keeps its half split.  Padding
                # each half to a multiple of tile makes N_pad = 2·h a
                # multiple of 2·tile (ring-eligible) — the any-N analogue
                # of the reference's block-cyclic BSE layout
                # (linalg/distMatrix/distMatrix.hpp:2867).
                if N % 2:
                    raise ValueError("pseudo-Hermitian problems need even N")
                n_half = N // 2
                h_pad = -(-n_half // tile) * tile
                if h_pad != n_half:
                    H = jnp.asarray(H)
                    # decoupled phantom pairs at ±g, g = the Gershgorin
                    # magnitude bound: μ = g² lands at the TOP of the H²
                    # interval (damped like any unwanted pair, mirrored by
                    # K-conjugation), never in the smallest-positive set
                    gersh = jnp.max(jnp.sum(jnp.abs(H), axis=1).real)
                    g = gersh.astype(H.dtype)
                    Np = 2 * h_pad
                    Hp = jnp.zeros((Np, Np), H.dtype)
                    Hp = Hp.at[:n_half, :n_half].set(H[:n_half, :n_half])
                    Hp = Hp.at[:n_half, h_pad:h_pad + n_half].set(
                        H[:n_half, n_half:])
                    Hp = Hp.at[h_pad:h_pad + n_half, :n_half].set(
                        H[n_half:, :n_half])
                    Hp = Hp.at[h_pad:h_pad + n_half,
                               h_pad:h_pad + n_half].set(
                        H[n_half:, n_half:])
                    iu = jnp.arange(n_half, h_pad)
                    Hp = Hp.at[iu, iu].set(g)                # +g upper pads
                    il = jnp.arange(h_pad + n_half, Np)
                    Hp = Hp.at[il, il].set(-g)               # −g K-mirrors
                    H = Hp
                    self._pad_half = (n_half, h_pad)
            else:
                N_pad = -(-N // tile) * tile
                if N_pad != N:
                    H = jnp.asarray(H)
                    # Gershgorin upper bound: pad eigenvalues above the
                    # spectrum
                    gersh = jnp.max(jnp.sum(jnp.abs(H), axis=1).real
                                    + jnp.diagonal(H).real
                                    - jnp.abs(jnp.diagonal(H)).real)
                    pad_val = gersh.astype(H.dtype)
                    Hp = jnp.zeros((N_pad, N_pad), H.dtype)
                    Hp = Hp.at[:N, :N].set(H)
                    idx = jnp.arange(N, N_pad)
                    H = Hp.at[idx, idx].set(pad_val)

        sh = matrix_sharding(grid)
        # Large host-resident operators stay on HOST until first .H use:
        # a wide-mode (sliced) solve never multiplies by the 8-byte H at
        # all, and an eager upload would sit in device memory next to the
        # slice stack.  Small operators keep the eager path (tests, warmup).
        lazy = (sh is None and not isinstance(H, jax.Array)
                and np.dtype(H.dtype).itemsize * H.shape[0] * H.shape[1]
                > (2 << 30))
        if lazy:
            self._H_dev = None
            self._N = int(H.shape[0])
            self._dtype = jnp.empty((0,), np.dtype(H.dtype)).dtype
        else:
            # a host array goes to its shards directly (no full copy on the
            # first device)
            self._H_dev = jax.device_put(H, sh) \
                if sh is not None else jnp.asarray(H)
            self._N = int(self._H_dev.shape[0])
            self._dtype = self._H_dev.dtype
        self._H_src = H_src if (self._N == self.N_orig
                                and self._owns_dev) else None
        self._H_low = None
        self._H_wide = None

    @property
    def H(self):
        """The device-resident operator.  Large host inputs are placed
        lazily on first access; after :meth:`engage_wide` dropped the f64
        buffer, the first access re-uploads it from the host source
        (logged — a wide-mode solve should never need it)."""
        if self._H_dev is None:
            from ..logger import get_logger
            get_logger().info(
                "uploading host-resident H (lazy placement / re-upload "
                "after engage_wide)", "linalg")
            sh = matrix_sharding(self.grid)
            Hd = jnp.asarray(self._H_src)
            self._H_dev = jax.device_put(Hd, sh) if sh is not None else Hd
        return self._H_dev

    @property
    def N(self) -> int:
        return self._N

    @property
    def dtype(self):
        return self._dtype

    @property
    def real_dtype(self):
        return real_dtype(self._dtype)

    @property
    def H_low(self):
        """Reduced-precision shadow of H (cached; the SP copy of P10).

        In transient-shadow mode (large-N wide solves) the shadow is
        reconstructed on device from the top int8 slices on access and
        freed by :meth:`drop_shadow` — 4·N² bytes of headroom around the
        RR/QR phases on memory-tight chips."""
        if self._H_low is None:
            if getattr(self, "_shadow_transient", False) \
                    and self._H_wide is not None:
                from ..ops.wide import shadow_from_slices
                slices, sa, s, L = self._H_wide
                self._H_low = shadow_from_slices(
                    tuple(slices), sa, s=s, nsl=min(-(-25 // s) + 1, L))
            else:
                lp = low_precision_dtype(self.dtype)
                self._H_low = self.H.astype(lp)
        return self._H_low

    @property
    def H_filter(self):
        """The filter-phase operator shadow.

        Normally identical to :attr:`H_low` (f32).  In transient-shadow
        mode it is a BF16 reconstruction from the top slices instead:
        the deviation-form refinement recurrence's noise scales with the
        CURRENT deviation (not ‖H‖), so a bf16 recurrence operator leaves
        the ladder's contraction essentially unchanged while the filter
        phase holds 1.8 GB instead of 3.6 at N=30000 — the difference
        between fitting and OOM next to the slice stack.  Lanczos bounds
        and the hermiticity probe keep using the f32 :attr:`H_low`."""
        if not getattr(self, "_shadow_transient", False):
            return self.H_low
        if getattr(self, "_H_filter", None) is None:
            from ..ops.wide import shadow_from_slices
            slices, sa, s, L = self._H_wide
            self._H_filter = shadow_from_slices(
                tuple(slices), sa, s=s, nsl=min(-(-9 // s) + 1, L),
                out_dtype=jnp.bfloat16)
        return self._H_filter

    def drop_shadow(self):
        """Free the f32/bf16 shadows between filter phases (no-op unless
        the operator is in transient-shadow mode — see H_low)."""
        if getattr(self, "_shadow_transient", False):
            self._H_low = None
            self._H_filter = None

    @property
    def H_wide(self):
        """Ozaki-sliced representation of a REAL f64 operator (cached) for
        the exact-slice GEMM (ops/wide) that serves the accuracy-critical
        f64 HEMMs (RR projection, QR Gram) under ``wide_f64='on'``."""
        return self.engage_wide()

    def engage_wide(self, drop: bool = True):
        """Slice H for the wide GEMM and cache the f32 shadow in ONE
        donating XLA program, then RELEASE the device f64 buffer (when we
        own it, can re-upload from the host source, and the caller's solve
        never multiplies by f64 H again — ``drop=True`` means RR/QR run on
        the slices and the filter on the refine ladder / f32 shadow).
        Keeping the 8-byte H would cost 8·N² bytes of dead device memory.
        Pass ``drop=False`` when the solve's
        filter still needs f64 H (refine ladder off)."""
        if self._H_wide is None:
            from ..ops.wide import presplit_and_shadow, \
                presplit_and_shadow_chunked
            from ..types import is_complex_dtype
            if is_complex_dtype(self._dtype) or \
                    np.dtype(self._dtype).itemsize != 8:
                raise TypeError(
                    f"wide mode is for real f64 operators, got {self._dtype}")
            can_drop = drop and self._owns_dev and self._H_src is not None
            big = self._N * self._N * 8 > (1 << 30)
            if big and self._H_src is not None and self.grid is None:
                # Large single-device operators: slice in row chunks from
                # the HOST source — the one-shot program's unrolled slice
                # chain holds ~20 N² f32 temps.  Free the device f64
                # buffer FIRST when we may: the chunked path never reads
                # it.
                if can_drop:
                    self._H_dev = None
                # Transient shadow: when the slice stack + a resident f32
                # shadow would crowd the device, skip the shadow upload —
                # H_low rebuilds it from the top slices per filter phase
                # and drop_shadow frees it for RR/QR.
                from ..ops.wide import wide_scheme_auto, wide_params_i8
                scheme = wide_scheme_auto(self._N)
                transient = False
                tbits = 48
                if scheme == "i8":
                    from ..device import memory_bytes
                    mem = memory_bytes()
                    _, Li8, _ = wide_params_i8(self._N, tbits)
                    transient = ((Li8 + 4.0) * self._N * self._N
                                 > 0.6 * mem)
                    # memory-tight: one fewer slice (42 operand bits —
                    # truncation ~sqrt(N)*2^-42 = 4e-11 relative at
                    # N=30000, still under the 1e-10 target) saves one
                    # N² int8 slice
                    if (Li8 + 4.0) * self._N * self._N > 0.65 * mem:
                        tbits = 42
                self._shadow_transient = transient
                slices, sa, low, s, L = presplit_and_shadow_chunked(
                    self._H_src, want_low=not transient,
                    target_bits=tbits)
            else:
                slices, sa, low, s, L = presplit_and_shadow(
                    self.H, donate=can_drop)
            if self.grid is not None:
                # pin the slice stack to the grid explicitly: the wide DP
                # state then scales per-device as (2L+4)·N²/G; slicing is
                # elementwise so GSPMD usually keeps the input sharding,
                # but the layout must not rely on it
                msh = matrix_sharding(self.grid)
                rsh = self.grid.sharding("r", None)     # (N, 1) row scale
                slices = tuple(jax.device_put(s_, msh) for s_ in slices)
                sa = jax.device_put(sa, rsh)
                low = jax.device_put(low, msh)
            self._H_wide = (slices, sa, s, L)
            if self._H_low is None:
                self._H_low = low
            if can_drop:
                self._H_dev = None    # buffer was donated; drop the ref
        return self._H_wide

    def free_low(self):
        self._H_low = None
        self._H_wide = None

    def place_block(self, V):
        """Pin a multivector on the grid with the canonical V sharding
        (zero-padding rows to the operator's padded size if needed; a
        pseudo pad scatters each half to its padded position so the
        S-metric half split is preserved)."""
        V = jnp.asarray(V)
        if V.shape[0] < self.N:
            Vp = jnp.zeros((self.N, V.shape[1]), V.dtype)
            if self._pad_half is not None:
                n_half, h_pad = self._pad_half
                Vp = Vp.at[:n_half, :].set(V[:n_half])
                Vp = Vp.at[h_pad:h_pad + n_half, :].set(V[n_half:])
                V = Vp
            else:
                V = Vp.at[:V.shape[0], :].set(V)
        sh = colvec_sharding(self.grid)
        return jax.device_put(V, sh) if sh is not None else V

    def unpad_block(self, V):
        """Undo :meth:`place_block`'s row padding on a result multivector
        (identity when the operator was not padded)."""
        if self.N == self.N_orig:
            return V
        if self._pad_half is not None:
            n_half, h_pad = self._pad_half
            return jnp.concatenate(
                [V[:n_half], V[h_pad:h_pad + n_half]], axis=0)
        return V[:self.N_orig]
