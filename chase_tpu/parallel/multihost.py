"""Multi-process initialization helpers.

Reference analogue: the user-side MPI_Init + MPI_Dims_create +
MpiGrid2D(comm) boilerplate of the distributed examples
(examples/1_hello_world.cpp:36-60).  These helpers wrap
`jax.distributed.initialize` and build the global ('r','c') grid spanning
all processes.  Each process of a launch that shares a machine gets
exactly one card (its local rank), so no process reserves memory on
another's card.

Typical usage (same script in every process):

    from chase_tpu.parallel import multihost
    grid = multihost.init_grid()            # all devices, near-square
    H = chase_tpu.io.load_matrix_sharded(path, N, dtype, grid)
    res = chase_tpu.eigsh(chase_tpu.DenseOperator(H, grid=grid), nev, nex)
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from .mesh import Grid2D, make_grid

__all__ = ["init_grid", "ensure_initialized", "is_multihost",
           "process_info", "local_device_ids"]


# launcher variables that carry a process's rank within its machine
_LOCAL_RANK_ENVS = ("OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID",
                    "MPI_LOCALRANKID", "MV2_COMM_WORLD_LOCAL_RANK",
                    "PMI_LOCAL_RANK")


def local_device_ids(coordinator: Optional[str] = None,
                     process_id: Optional[int] = None):
    """The one card this process should own, or None to leave JAX's
    default.  Decided from the environment only: the launcher's local
    rank, else — when the coordinator is on this machine, so every
    process is — the process id.  The id indexes the visible cards, so a
    CUDA_VISIBLE_DEVICES that lists the whole machine to every rank (as
    SLURM's --gres does) still gives each rank one card.  An explicit
    JAX_LOCAL_DEVICE_IDS, or a CUDA_VISIBLE_DEVICES of one card, is the
    user's choice and wins."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if os.environ.get("JAX_LOCAL_DEVICE_IDS") \
            or (visible and len(visible.split(",")) == 1):
        return None
    for name in _LOCAL_RANK_ENVS:
        if os.environ.get(name):
            return [int(os.environ[name])]
    host = (coordinator or "").rsplit(":", 1)[0].strip("[]")
    if process_id is not None and host in ("localhost", "127.0.0.1", "::1"):
        return [process_id]
    return None


def ensure_initialized(coordinator: Optional[str] = None) -> None:
    """Initialize the distributed runtime when the environment calls for
    it.  Must run before any XLA backend touch; a second call is a no-op."""
    if jax.distributed.is_initialized():
        return
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return
    # Decide from ENV ONLY: probing jax.process_count() here would
    # initialize the XLA backend and make distributed.initialize
    # impossible (it must run before any backend touch).
    kwargs = {"coordinator_address": coordinator}
    if os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["num_processes"] = int(os.environ["JAX_NUM_PROCESSES"])
    if os.environ.get("JAX_PROCESS_ID"):
        kwargs["process_id"] = int(os.environ["JAX_PROCESS_ID"])
    ids = local_device_ids(coordinator, kwargs.get("process_id"))
    if ids is not None:
        kwargs["local_device_ids"] = ids
    jax.distributed.initialize(**kwargs)


def init_grid(shape: Optional[tuple[int, int]] = None,
              coordinator: Optional[str] = None) -> Grid2D:
    """Initialize the distributed runtime (if needed) and build the grid.

    Pass ``coordinator`` (or JAX_COORDINATOR_ADDRESS) plus the
    JAX_NUM_PROCESSES/JAX_PROCESS_ID envs; SLURM and Open MPI launches
    fill in the size and rank themselves.
    """
    ensure_initialized(coordinator)
    return make_grid(shape=shape)


def is_multihost() -> bool:
    return jax.process_count() > 1


def process_info() -> dict:
    return {"process_index": jax.process_index(),
            "process_count": jax.process_count(),
            "local_devices": len(jax.local_devices()),
            "global_devices": jax.device_count()}
