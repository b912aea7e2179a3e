"""2D device grid and canonical shardings.

JAX analogue of ``grid/mpiGrid2D.hpp:188`` (MpiGrid2D: 2D Cartesian
process grid with row/column sub-communicators) — here a
``jax.sharding.Mesh`` with axes ``('r', 'c')``:

* the N×N operator A lives in ``P('r', 'c')``   (2D block distribution, P1)
* column-communicator multivectors live in ``P('r', None)``
* row-communicator multivectors live in ``P('c', None)``
* small projected matrices are replicated ``P()``                      (P8)

Row↔column redistribution (the reference's Bcast rings,
distMultiVector.hpp:2444-2918) is just a resharding between the two vector
shardings — GSPMD emits the all-to-all/all-gather.  RowMajor/ColMajor grid
majors and BLACS contexts have no equivalent here: mesh axis order covers
both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["Grid2D", "make_grid", "matrix_sharding", "colvec_sharding",
           "rowvec_sharding", "replicated_sharding"]


def _near_square_dims(n: int) -> tuple[int, int]:
    """MPI_Dims_create analogue: the most-square 2D factorization of n."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """A 2D device grid; hashable so it can ride through jit static args."""
    mesh: Mesh

    @property
    def shape(self):
        return dict(self.mesh.shape)

    @property
    def nprocs(self) -> int:
        return self.mesh.size

    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))


def make_grid(devices: Optional[Sequence] = None,
              shape: Optional[tuple[int, int]] = None) -> Grid2D:
    """Build the ('r','c') grid over the given (default: all) devices.

    Devices fill the grid in enumeration order.  The cards of one GPU host
    reach each other all to all over NVLink at the same rate, so the mesh
    follows the algorithm alone (the analogue of MPI_Dims_create)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = _near_square_dims(n)
    r, c = shape
    if r * c != n:
        raise ValueError(f"grid shape {shape} does not cover {n} devices")
    return Grid2D(Mesh(np.asarray(devices).reshape(r, c), ("r", "c")))


def matrix_sharding(grid: Optional[Grid2D]):
    return None if grid is None else grid.sharding("r", "c")


def colvec_sharding(grid: Optional[Grid2D]):
    """1D row-partition within the column communicator (P3): V in P('r')."""
    return None if grid is None else grid.sharding("r", None)


def rowvec_sharding(grid: Optional[Grid2D]):
    """1D row-partition within the row communicator: W in P('c')."""
    return None if grid is None else grid.sharding("c", None)


def replicated_sharding(grid: Optional[Grid2D]):
    return None if grid is None else grid.sharding()
