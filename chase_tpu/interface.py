"""Flat init/solve/get/finalize interface — C-ABI semantic parity.

The reference exposes a singleton-per-type C API
(interface/chase_c_interface.h: ``{s,d,c,z}chase_init_``, ``*chase_``,
``*chase_get_eigenpairs_``, ``*chase_finalize_``, plus config setters
``chase_set_*`` and build introspection ``chase_has_*``) consumed by
Fortran/C applications (FLEUR, YAMBO).  This module reproduces those
semantics 1:1 in Python so code structured around the C API ports
mechanically; the dtype letter is inferred from the arrays instead of
baked into the symbol name.

    import chase_tpu.interface as chase
    chase.init(N, nev, nex, H, V=None)            # dchase_init_
    chase.set_tol(1e-10); chase.set_deg(20)       # chase_set_*
    chase.solve(mode='R', opt='S', qr='C')        # dchase_
    evals, evecs = chase.get_eigenpairs()         # dchase_get_eigenpairs_
    chase.finalize()                              # dchase_finalize_

An actual C shared library (for linking Fortran apps against a Python-
embedded runtime) is tracked separately; this layer defines its contract.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .api import eigsh, eigsh_pseudo
from .config import ChaseConfig
from .parallel.mesh import Grid2D, make_grid

__all__ = ["init", "init_pseudo", "init_blockcyclic", "init_dist_local",
           "solve", "get_eigenpairs", "finalize",
           "set_tol", "set_deg", "set_opt", "set_maxiter", "set_lanczos",
           "has_gpu", "has_distribution", "has_pseudo"]


@dataclasses.dataclass
class _Session:
    N: int
    nev: int
    nex: int
    H: np.ndarray                       # (or a global sharded jax.Array
    # in the multi-process per-rank mode — see init_dist_local)
    V0: Optional[np.ndarray]
    ritzv0: Optional[np.ndarray] = None
    pseudo: bool = False
    grid: Optional[Grid2D] = None
    mp_local_rows: Optional[int] = None   # per-rank mode: this rank's m
    layout = None                       # (Pseudo)BlockCyclicLayout or None
    H_owned = None                      # layout-permuted H, memoized (the
    # permutation is two full N×N gathers on the single-core host — pay it
    # once per session, not once per solve of a sequence)
    config: ChaseConfig = dataclasses.field(default_factory=ChaseConfig)
    result = None


_session: Optional[_Session] = None


def _require() -> _Session:
    if _session is None:
        raise RuntimeError("chase not initialized — call init() first")
    return _session


def _grid_for(grid_shape, grid_major: str = "R") -> Optional[Grid2D]:
    """Device grid for the reference's (dim0, dim1) process-grid dims.

    The reference's p*chase_init_ distributes over dim0×dim1 MPI ranks
    (chase_c_interface.h:126-157); here the same dims select a dim0×dim1
    device mesh in the single driving process.  grid_major 'R'|'C' maps the
    device enumeration row- vs column-major onto the grid — the MpiGrid2D
    RowMajor/ColMajor analogue (grid/mpiGrid2D.hpp:188)."""
    import jax
    if grid_shape is None:
        return make_grid()
    d0, d1 = int(grid_shape[0]), int(grid_shape[1])
    n = d0 * d1
    if n <= 1:
        return None
    devs = jax.devices()
    if len(devs) < n:
        raise ValueError(
            f"grid dims {d0}x{d1} need {n} devices, only {len(devs)} "
            f"available")
    devs = devs[:n]
    if str(grid_major).upper().startswith("C"):
        devs = list(np.asarray(devs, dtype=object).reshape(d1, d0).T.ravel())
    return make_grid(devs, shape=(d0, d1))


def init(N: int, nev: int, nex: int, H, V=None, ritzv=None, *,
         distributed: bool = False, grid_shape=None, grid_major: str = "R"):
    """*chase_init_ / p*chase_init_: bind the problem to the singleton.

    V/ritzv, when given, seed mode='A' warm starts (the reference reuses
    the caller's buffers as the approximate subspace).  ``grid_shape`` =
    the reference's (dim0, dim1) process-grid dims → device mesh shape."""
    global _session
    H = np.asarray(H)
    if H.shape != (N, N):
        raise ValueError(f"H shape {H.shape} != ({N}, {N})")
    grid = _grid_for(grid_shape, grid_major) if distributed else None
    _session = _Session(N=N, nev=nev, nex=nex, H=H,
                        V0=None if V is None else np.asarray(V),
                        ritzv0=None if ritzv is None else
                        np.asarray(ritzv, np.float64).copy(),
                        grid=grid)
    return 0


def init_dist_local(N: int, nev: int, nex: int, m: int, n: int, H_local,
                    V=None, ritzv=None, *, grid_shape, grid_major: str = "R",
                    pseudo: bool = False):
    """Per-rank p*chase_init_ (chase_c_interface.h:126-157): each calling
    PROCESS passes its LOCAL (m, n) block of the (dim0, dim1) block-block
    distribution, exactly like an MPI rank of the reference.

    JAX realization: every caller is one ``jax.distributed`` process; the
    local blocks assemble into ONE global sharded array with
    ``jax.make_array_from_single_device_arrays`` (no process ever holds
    the full matrix), and the whole SPMD solver stack runs on the global
    mesh.  V, when given, is this rank's (m, cols) row block of the
    column-communicator multivector (DistMultiVector1D semantics:
    identical blocks on every rank of a grid row).

    Requirements (clear errors otherwise): a running jax.distributed
    runtime with process_count == dim0·dim1, ONE local device per process,
    process rank r at grid coordinate (r // dim1, r % dim1) for 'R' major
    ((r % dim0, r // dim0) for 'C'), and dim0·dim1 | N (the mesh tile
    cannot pad a multi-process global array).
    """
    global _session
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    d0, d1 = int(grid_shape[0]), int(grid_shape[1])
    nproc = jax.process_count()
    if nproc != d0 * d1:
        raise ValueError(
            f"per-rank init: grid dims {d0}x{d1} need {d0 * d1} "
            f"jax.distributed processes, runtime has {nproc} (start one "
            f"process per rank; see chase_tpu.parallel.multihost)")
    if len(jax.local_devices()) != 1:
        raise ValueError(
            f"per-rank init maps each process to ONE device; this process "
            f"has {len(jax.local_devices())} local devices")
    if N % d0 or N % d1 or N % (d0 * d1):
        raise ValueError(
            f"per-rank init needs dim0·dim1 | N (no padding across "
            f"processes): N={N}, grid {d0}x{d1}")
    if m != N // d0 or n != N // d1:
        raise ValueError(
            f"local block ({m}, {n}) != (N/dim0, N/dim1) = "
            f"({N // d0}, {N // d1}) — uneven block splits are not "
            f"supported; pad N to a multiple of the grid")
    H_local = np.asarray(H_local)
    if H_local.shape != (m, n):
        raise ValueError(f"H_local shape {H_local.shape} != ({m}, {n})")
    if np.dtype(H_local.dtype).itemsize >= 8 \
            and np.dtype(H_local.dtype).kind in "fc" \
            and not jax.config.jax_enable_x64:
        # the global shards are built HERE, before DenseOperator's own x64
        # guard runs — without this a 64-bit local block silently downcasts
        # to 32 bits (measured: a C caller's f64 solve floored at 5e-5)
        from .logger import get_logger
        get_logger().info("enabling jax x64 for a 64-bit local block")
        jax.config.update("jax_enable_x64", True)

    # mesh whose (i, j) coordinate holds the device of MPI-rank-order
    # process r: r = i·dim1 + j for 'R' major, r = j·dim0 + i for 'C'
    devs = sorted(jax.devices(), key=lambda d: d.process_index)
    arr = np.array(devs, dtype=object)
    if str(grid_major).upper().startswith("C"):
        arr = arr.reshape(d1, d0).T
    else:
        arr = arr.reshape(d0, d1)
    grid = Grid2D(Mesh(arr, ("r", "c")))
    ld = jax.local_devices()[0]
    H_g = jax.make_array_from_single_device_arrays(
        (N, N), grid.sharding("r", "c"),
        [jax.device_put(jnp.asarray(H_local), ld)])
    V_g = None
    if V is not None:
        V = np.asarray(V)
        cols = 2 * (nev + nex) if pseudo else (nev + nex)
        if V.shape != (m, cols):
            raise ValueError(f"V local block shape {V.shape} != "
                             f"({m}, {cols})")
        V_g = jax.make_array_from_single_device_arrays(
            (N, cols), grid.sharding("r", None),
            [jax.device_put(jnp.asarray(V), ld)])
    _session = _Session(N=N, nev=nev, nex=nex, H=H_g, V0=V_g,
                        ritzv0=None if ritzv is None else
                        np.asarray(ritzv, np.float64).copy(),
                        pseudo=pseudo, grid=grid, mp_local_rows=m)
    return 0


def init_pseudo(N: int, nev: int, nex: int, H, V=None, *,
                distributed: bool = False, grid_shape=None,
                grid_major: str = "R"):
    """*chase_init_pseudo_ / p{c,z}chase_init_pseudo_: BSE problem
    (chase_c_interface.h:159-175)."""
    init(N, nev, nex, H, V, distributed=distributed, grid_shape=grid_shape,
         grid_major=grid_major)
    _require().pseudo = True
    return 0


def init_blockcyclic(N: int, nev: int, nex: int, mb: int, nb: int, H,
                     V=None, ritzv=None, *, pseudo: bool = False,
                     distributed: bool = True, grid_shape=None,
                     grid_major: str = "R", irsrc: int = 0, icsrc: int = 0):
    """p?chase_init_blockcyclic_ / p?chase_init_pseudo_blockcyclic_
    (chase_c_interface.h:61-121): bind the problem with a ScaLAPACK-style
    (mb×nb) block-cyclic layout.

    JAX realization: the layout is an ownership *similarity transform*
    (parallel/layouts.BlockCyclicLayout) — H's rows/columns are permuted so
    contiguous mesh sharding owns exactly the block-cyclically assigned
    indices; eigenvector rows are un-permuted in get_eigenpairs().
    ``irsrc``/``icsrc`` (the source-process offsets of the ScaLAPACK
    descriptor) must be 0 — nonzero offsets only relabel which rank holds
    block 0, which has no device-mesh meaning here."""
    from .parallel.layouts import BlockCyclicLayout, PseudoBlockCyclicLayout
    if irsrc != 0 or icsrc != 0:
        raise ValueError("irsrc/icsrc != 0 unsupported (no rank relabeling "
                         "on a device mesh)")
    if nb != mb:
        from .logger import get_logger
        get_logger().warn(f"block-cyclic nb={nb} != mb={mb}: the Hermitian "
                          f"similarity transform uses mb for both sides",
                          "interface")
    if pseudo:
        init_pseudo(N, nev, nex, H, V, distributed=distributed,
                    grid_shape=grid_shape, grid_major=grid_major)
    else:
        init(N, nev, nex, H, V, ritzv, distributed=distributed,
             grid_shape=grid_shape, grid_major=grid_major)
    s = _require()
    g = s.grid
    p_r = g.shape["r"] if g is not None else 1
    p_c = g.shape["c"] if g is not None else 1
    cls = PseudoBlockCyclicLayout if pseudo else BlockCyclicLayout
    s.layout = cls(N, mb, p_r, p_c)
    return 0


def set_tol(tol: float):
    s = _require()
    s.config = dataclasses.replace(s.config, tol=float(tol))


def set_deg(deg: int):
    s = _require()
    s.config = dataclasses.replace(s.config, deg=int(deg))


def set_opt(opt: bool):
    s = _require()
    s.config = dataclasses.replace(s.config, optimization=bool(opt))


def set_maxiter(n: int):
    s = _require()
    s.config = dataclasses.replace(s.config, max_iter=int(n))


def set_lanczos(lanczos_iter: int, num_lanczos: int):
    s = _require()
    s.config = dataclasses.replace(s.config, lanczos_iter=int(lanczos_iter),
                                   num_lanczos=int(num_lanczos))


def set_decaying_rate(rate: float):
    s = _require()
    s.config = dataclasses.replace(s.config, decaying_rate=float(rate))


def set_upperb_scale_rate(rate: float):
    s = _require()
    s.config = dataclasses.replace(s.config, upperb_scale=float(rate))


def set_cluster_aware_degrees(flag: bool):
    s = _require()
    s.config = dataclasses.replace(s.config,
                                   cluster_aware_degrees=bool(flag))


def set_max_deg(max_deg: int):
    s = _require()
    s.config = dataclasses.replace(s.config, max_deg=int(max_deg))


def set_deg_extra(deg_extra: int):
    s = _require()
    s.config = dataclasses.replace(s.config, deg_extra=int(deg_extra))


def set_cholqr(flag: bool):
    s = _require()
    s.config = dataclasses.replace(s.config, cholqr=bool(flag))


def set_approx(flag: bool):
    s = _require()
    s.config = dataclasses.replace(s.config, approx=bool(flag))


def enable_sym_check(flag: bool):
    s = _require()
    s.config = dataclasses.replace(s.config, sym_check=bool(flag))


def solve(deg: Optional[int] = None, tol: Optional[float] = None,
          mode: str = "R", opt: str = "S", qr: str = "C"):
    """*chase_(deg, tol, mode, opt, qr): run the solver on the session.

    mode='R'|'A' (random vs warm start), opt='S'|'N' (degree optimization),
    qr='C'|'H' (CholQR vs Householder) — chase_c_interface.h:38-41.
    """
    s = _require()
    updates = {"optimization": opt != "N", "cholqr": qr == "C",
               "approx": mode == "A"}
    if deg is not None:
        updates["deg"] = int(deg)
    if tol is not None:
        updates["tol"] = float(tol)
    s.config = dataclasses.replace(s.config, **updates)
    fn = eigsh_pseudo if s.pseudo else eigsh
    kwargs = {}
    if mode == "A":
        if s.result is not None:
            # result.V already lives in the layout's ownership order; in
            # the multi-process per-rank mode it is a global sharded array
            # (np.asarray would touch non-addressable shards)
            v0_prev = s.result.V if s.mp_local_rows is not None \
                else np.asarray(s.result.V)
            kwargs = {"v0": v0_prev,
                      "ritzv0": s.result.ritzv_full, "approx": True}
        elif s.V0 is not None and s.ritzv0 is not None \
                and np.any(s.ritzv0):
            # warm start straight from the caller's init buffers (user
            # global row ordering → ownership ordering under a layout)
            v0 = s.V0 if s.layout is None \
                else np.asarray(s.layout.apply_rows(s.V0))
            kwargs = {"v0": v0, "ritzv0": s.ritzv0, "approx": True}
        else:
            raise RuntimeError("mode='A' needs a previous solve or V+ritzv "
                               "buffers supplied at init")
    if s.layout is None:
        H = s.H
    else:
        if s.H_owned is None:
            s.H_owned = np.ascontiguousarray(s.layout.apply(s.H))
        H = s.H_owned
    s.result = fn(H, s.nev, s.nex, config=s.config, grid=s.grid, **kwargs)
    return 0 if s.result.converged else 1


def get_eigenpairs():
    """*chase_get_eigenpairs_: (evals (nev,), evecs (N, nev)).

    In the multi-process per-rank mode (init_dist_local) every process
    gets the replicated eigenvalues and ITS OWN (m, nev) eigenvector row
    block — the reference's p*chase_get_eigenpairs_ semantics (rank-local
    LEigsV).  All processes must call this collectively (one SPMD reshard
    pins V to the canonical row distribution)."""
    import jax
    s = _require()
    if s.result is None:
        raise RuntimeError("no solve() yet")
    if s.mp_local_rows is not None:
        V_g = jax.jit(lambda x: x,
                      out_shardings=s.grid.sharding("r", None))(s.result.V)
        Vloc = np.asarray(V_g.addressable_shards[0].data)[:, :s.nev]
        return s.result.ritzv.copy(), Vloc.copy()
    V = np.asarray(s.result.V)[:, :s.nev]
    if s.layout is not None:
        V = np.asarray(s.layout.restore_rows(V))
    return s.result.ritzv.copy(), V.copy()


def finalize(flag: int = 0):
    """*chase_finalize_: destroy the singleton."""
    global _session
    _session = None
    return 0


# build introspection (chase_c_interface.h:234-239 chase_has_*)
def has_gpu() -> bool:
    import jax
    return any(d.platform == "gpu" for d in jax.devices())


def has_distribution() -> bool:
    import jax
    return jax.device_count() > 1


def has_pseudo() -> bool:
    return True
