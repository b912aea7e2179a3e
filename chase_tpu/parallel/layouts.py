"""Block-cyclic layout support (P2).

The reference offers ScaLAPACK-style mb×nb block-cyclic distribution
(linalg/distMatrix/distMatrix.hpp:2867 BlockCyclicMatrix,
DistMultiVectorBlockCyclic1D) for load balance of trapezoidal work.  On a
device mesh the HEMM work is uniform across shards, so block-cyclic brings no
performance benefit — but for parity (and for interop with matrices whose
natural ordering is the ScaLAPACK ownership order) we provide it as a
*similarity transform*: a row/column permutation that makes contiguous
block sharding own exactly the rows a (nb, p)-block-cyclic distribution
would own.  Eigenvalues are invariant; eigenvector rows are un-permuted on
the way out.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["block_cyclic_perm", "BlockCyclicLayout",
           "PseudoBlockCyclicLayout", "BlockCyclicVector1D"]


def _take_rows(X, idx):
    """Row gather preserving the input's array library: numpy stays numpy
    (jnp.asarray would silently downcast f64 before x64 is enabled)."""
    if isinstance(X, jax.Array):
        return X[jnp.asarray(idx)]
    return np.asarray(X)[idx]


def block_cyclic_perm(n: int, nb: int, p: int) -> np.ndarray:
    """Ownership-ordered global indices: perm[i] = the global index that a
    contiguous p-way block layout should place at position i so that part q
    holds exactly the indices block-cyclically owned by process q
    (owner(g) = (g // nb) % p, ScaLAPACK descriptor convention)."""
    owner = (np.arange(n) // nb) % p
    return np.argsort(owner, kind="stable")


class BlockCyclicLayout:
    """Symmetric block-cyclic reindexing of an N×N operator."""

    def __init__(self, N: int, mb: int, p_r: int, p_c: int = None):
        p_c = p_c if p_c is not None else p_r
        self.N = N
        self.mb = mb
        self.row_perm = block_cyclic_perm(N, mb, p_r)
        self.col_perm = block_cyclic_perm(N, mb, p_c)
        self._row_inv = np.argsort(self.row_perm)

    def apply(self, H):
        """Reorder H so block sharding == block-cyclic ownership.

        For Hermitian solves the row and column permutations must agree
        (similarity transform); we use the row permutation on both sides.
        """
        return _take_rows(H, self.row_perm)[:, self.row_perm]

    def restore_rows(self, V):
        """Un-permute eigenvector rows back to the user's global ordering."""
        return _take_rows(V, self._row_inv)

    def apply_rows(self, V):
        """Permute multivector rows INTO the ownership ordering (the
        DistMultiVector1D redistribution analogue for warm starts / v0)."""
        return _take_rows(V, self.row_perm)


class PseudoBlockCyclicLayout(BlockCyclicLayout):
    """Block-cyclic reindexing that preserves the BSE S-metric.

    Analogue of ``PseudoHermitianBlockCyclicMatrix``
    (linalg/distMatrix/distMatrix.hpp:3936).  A global block-cyclic row
    permutation would mix the two S = diag(I, −I) halves and break both the
    metric and the K-conjugation row pairing (i ↔ i+N/2).  Instead the SAME
    block-cyclic permutation is applied independently within each half:

      perm = [bc_perm(N/2) | bc_perm(N/2) + N/2]

    * S is invariant (P S Pᵀ = S: the permutation never crosses halves), so
      the permuted operator is pseudo-Hermitian w.r.t. the SAME metric and
      every S-aware kernel (flipSign, S-QR, pencil RR, K-conjugation) works
      unchanged.
    * Each shard owns the block-cyclically assigned rows *of its half* —
      ownership is block-cyclic per half rather than global (the reference
      keeps global ownership and special-cases the half boundary inside
      each kernel; the per-half form is the similarity-transform
      equivalent).
    """

    def __init__(self, N: int, mb: int, p_r: int, p_c: int = None):
        if N % 2 != 0:
            raise ValueError(f"pseudo-Hermitian N={N} must be even")
        p_c = p_c if p_c is not None else p_r
        self.N = N
        self.mb = mb
        half = block_cyclic_perm(N // 2, mb, p_r)
        self.row_perm = np.concatenate([half, half + N // 2])
        half_c = block_cyclic_perm(N // 2, mb, p_c)
        self.col_perm = np.concatenate([half_c, half_c + N // 2])
        self._row_inv = np.argsort(self.row_perm)


class BlockCyclicVector1D:
    """1D block-cyclic multivector layout (DistMultiVectorBlockCyclic1D,
    linalg/distMatrix/distMultiVector.hpp:2931).

    Standalone row layout for an (N, k) multivector distributed
    block-cyclically over ``p`` parts of one mesh axis, independent of any
    matrix layout: ``to_owner_order`` reorders rows so a contiguous p-way
    row sharding owns exactly the block-cyclically assigned rows;
    ``from_owner_order`` restores the user's global ordering.  When used
    together with a (Pseudo)BlockCyclicLayout the vector must follow the
    MATRIX row permutation instead (pass ``like=layout``).
    """

    def __init__(self, N: int, mb: int, p: int, like=None):
        self.N = N
        self.mb = mb
        self.perm = (np.asarray(like.row_perm) if like is not None
                     else block_cyclic_perm(N, mb, p))
        self._inv = np.argsort(self.perm)

    def to_owner_order(self, V):
        return _take_rows(V, self.perm)

    def from_owner_order(self, V):
        return _take_rows(V, self._inv)
