"""chase_tpu — a Chebyshev-accelerated subspace eigensolver in JAX.

A from-scratch JAX/XLA framework with the capabilities of the ChASE
library (Chebyshev Accelerated Subspace iteration Eigensolver): extremal
eigenpairs of dense real-symmetric, complex-Hermitian and pseudo-Hermitian
(BSE) matrices, with per-vector degree-optimized Chebyshev filtering,
CholQR orthogonalization, Rayleigh–Ritz projection, residual-based locking
and warm-started problem sequences — on one GPU or scaled over a device
mesh with jax.sharding/GSPMD (XLA's collectives) instead of
MPI/NCCL/ScaLAPACK.
"""

from .api import (eigsh, eigsh_fused, eigsh_pseudo,  # noqa: F401
                  eigsh_pseudo_fused, eigsh_sequence,
                  estimate_spectral_bounds, embed_complex_operator)
from .config import ChaseConfig  # noqa: F401
from .solver import solve, SolveResult  # noqa: F401
from .parallel import DenseOperator, make_grid, Grid2D  # noqa: F401
from .perf import PerfData  # noqa: F401
from .warmup import warmup  # noqa: F401

__version__ = "0.1.0"
