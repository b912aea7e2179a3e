"""Sharding-agnostic numeric kernels.

This package is the JAX replacement for the reference's five parallel
kernel namespaces ``linalg/internal/{cpu,cuda,mpi,nccl,cuda_aware_mpi}``
(SURVEY §2.6): every kernel is written once in pure JAX; distribution comes
from GSPMD sharding annotations supplied by :mod:`chase_tpu.parallel`, not
from per-backend reimplementations.
"""

from . import blocks, filter, lanczos, pseudo, qr, rr, residuals  # noqa: F401
