"""Multi-process (multi-host analogue) tests.

The reference tests its distributed path under ``mpirun -n 4`` (SURVEY §4
"distributed testing without a cluster").  Here we spawn 2 genuine
``jax.distributed`` CPU processes (2 local devices each → a 4-device global
mesh whose shards live in DIFFERENT address spaces) and exercise the pod
helpers, per-process sharded matrix loading, a full grid solve, and the
sharded checkpoint round trip — closing the round-1 gap where the
multi-host helpers were only single-process-tested.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys, json
pid = int(sys.argv[1]); nproc = int(sys.argv[2])
port = sys.argv[3]; tmp = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
os.environ["JAX_NUM_PROCESSES"] = str(nproc)
os.environ["JAX_PROCESS_ID"] = str(pid)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp
import chase_tpu
from chase_tpu.parallel import multihost
from chase_tpu import io as cio
from chase_tpu.models import clement
from jax.experimental import multihost_utils

grid = multihost.init_grid()           # initializes jax.distributed
assert multihost.is_multihost(), "expected >1 processes"
info = multihost.process_info()
assert info["process_count"] == nproc, info
assert info["global_devices"] == 2 * nproc, info
assert grid.nprocs == 2 * nproc

N, nev, nex = 128, 8, 8
H = np.asarray(clement(N), np.float64)
path = os.path.join(tmp, "h.bin")
if pid == 0:
    cio.save_matrix(H, path)
multihost_utils.sync_global_devices("matrix_written")

# per-process sharded load: each process reads only its own shards
Hs = cio.load_matrix_sharded(path, N, np.float64, grid)
op = chase_tpu.DenseOperator(Hs, grid=grid)
res = chase_tpu.eigsh(op, nev, nex, tol=1e-9)
assert res.converged, "solve did not converge across processes"
exact = np.arange(-(N - 1), -(N - 1) + 2 * nev, 2).astype(float)
err = np.abs(res.ritzv - exact).max()
assert err < 1e-7, f"eig err {err}"

# sharded checkpoint: every process writes only its own V shards
state = os.path.join(tmp, "state")
cio.save_state(state, res.V, res.ritzv_full,
               meta={"from": pid}, sharded=True)
multihost_utils.sync_global_devices("state_saved")
V2, ritzv2, meta = cio.load_state(state, grid=grid)
assert V2.shape == res.V.shape
np.testing.assert_allclose(ritzv2, np.asarray(res.ritzv_full))
dmax = float(jax.jit(lambda a, b: jnp.max(jnp.abs(a - b)))(V2, res.V))
assert dmax < 1e-12, f"checkpoint round-trip mismatch {dmax}"

# pseudo-Hermitian (BSE) solve across processes (the reference runs its
# distributed BSE test on 4 ranks: chase_distributed_solve_pseudo_bse)
if nproc >= 4:
    from chase_tpu.models import random_pseudo_hermitian
    Np = 128
    Hp = np.asarray(random_pseudo_hermitian(Np, dtype=np.float64, seed=7))
    rp = chase_tpu.eigsh_pseudo(Hp, 4, 6, tol=1e-9, grid=grid)
    assert rp.converged, "pseudo solve did not converge across processes"
    pos = np.sort(np.linalg.eigvals(Hp).real)
    pos = pos[pos > 0][:4]
    perr = np.abs(np.asarray(rp.ritzv) - pos).max()
    assert perr < 1e-7, f"pseudo eig err {perr}"

print(json.dumps({"pid": pid, "ok": True, "eig_err": float(err)}))
"""


@pytest.mark.slow
@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_grid_solve_and_sharded_checkpoint(tmp_path, nproc):
    """2- and 4-process runs; 4 processes x 2 devices = an 8-device global
    mesh across four address spaces — the reference's ``mpirun -n 4``
    distributed test fidelity (SURVEY §4)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env_base.get("PYTHONPATH", "").split(os.pathsep) if p])
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid), str(nproc),
             str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env_base, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
        assert '"ok": true' in out


_WORKER_PER_RANK = r"""
import os, sys, json
pid = int(sys.argv[1]); nproc = int(sys.argv[2])
port = sys.argv[3]; tmp = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
os.environ["JAX_NUM_PROCESSES"] = str(nproc)
os.environ["JAX_PROCESS_ID"] = str(pid)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import chase_tpu.interface as chase
from chase_tpu.parallel import multihost
from chase_tpu.models import clement
from jax.experimental import multihost_utils

multihost.ensure_initialized()
assert jax.process_count() == nproc

# per-rank local block of the dim0 x 1 block distribution — this process
# NEVER holds the full matrix in the session (reference p*chase_init_
# semantics, chase_c_interface.h:126-157)
N, nev, nex = 128, 8, 8
m, n = N // nproc, N
H = np.asarray(clement(N), np.float64)       # generator only, for the block
H_local = np.ascontiguousarray(H[pid * m:(pid + 1) * m, :])

chase.init_dist_local(N, nev, nex, m, n, H_local,
                      grid_shape=(nproc, 1), grid_major="R")
chase.set_tol(1e-9)
rc = chase.solve()
assert rc == 0, "per-rank solve did not converge"
evals, Vloc = chase.get_eigenpairs()
assert Vloc.shape == (m, nev), Vloc.shape
exact = np.arange(-(N - 1), -(N - 1) + 2 * nev, 2).astype(float)
err = np.abs(evals - exact).max()
assert err < 1e-7, f"eig err {err}"

# verify the rank-local blocks assemble into true eigenvectors: every rank
# writes its block, rank 0 checks the full-space residual
np.save(os.path.join(tmp, f"vloc{pid}.npy"), Vloc)
multihost_utils.sync_global_devices("blocks_written")
if pid == 0:
    V = np.concatenate([np.load(os.path.join(tmp, f"vloc{r}.npy"))
                        for r in range(nproc)], axis=0)
    R = H @ V - V * evals[None, :]
    rmax = np.linalg.norm(R, axis=0).max()
    assert rmax < 1e-7, f"assembled residual {rmax}"

# warm-start repeat through the same session (mode='A')
rc = chase.solve(mode="A")
assert rc == 0
chase.finalize()
print(json.dumps({"pid": pid, "ok": True, "eig_err": float(err)}))
"""


@pytest.mark.slow
def test_per_rank_init_dist_local(tmp_path):
    """A genuinely distributed caller — one
    process per rank passing its LOCAL (m, n) block — solves and gets
    rank-local eigenvector blocks back (p*chase_init_ semantics)."""
    nproc = 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env_base["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env_base.get("PYTHONPATH", "").split(os.pathsep) if p])
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER_PER_RANK, str(pid), str(nproc),
             str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env_base, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"per-rank worker failed:\n{err[-3000:]}"
        assert '"ok": true' in out


@pytest.mark.slow
def test_per_rank_c_driver_2proc(tmp_path):
    """A compiled C caller on 2 processes: each passes its local block to
    pdchase_init_ and reads back rank-local eigenvector rows — the
    reference's MPI application pattern (FLEUR/YAMBO) on the JAX runtime."""
    import shutil
    if shutil.which("g++") is None or shutil.which("cc") is None:
        pytest.skip("no C compiler")
    from chase_tpu import _native
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _native.build_capi(str(tmp_path / "libchase_tpu.so"))
    exe = str(tmp_path / "c_dist2")
    subprocess.run(
        ["cc", os.path.join(repo, "examples", "c_dist_2proc_demo.c"),
         "-L", str(tmp_path), "-lchase_tpu", "-lm", "-o", exe],
        check=True, capture_output=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS",)}
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["LD_LIBRARY_PATH"] = str(tmp_path)
        env["CHASE_TPU_PLATFORM"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen([exe], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, env=env,
                                      text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"C dist driver failed:\n{out}\n{err[-3000:]}"
        assert "PASS" in out
