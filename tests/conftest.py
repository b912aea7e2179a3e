"""Test configuration.

Mirrors the reference's "distributed testing without a cluster" strategy
(tests run under `mpirun -n 4`, SURVEY §4): here we force 8 virtual CPU
devices so mesh-sharded paths execute real collectives on one host, and
enable x64 so double-precision parity tests are meaningful.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Force CPU explicitly (a config update wins over any platform plugin) so
# tests run on the virtual 8-device host mesh with real f64.  Tests that
# need the card are marked ``gpu`` and run it in a subprocess.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.device_count() == 8, (
    f"expected 8 forced host devices, got {jax.device_count()}")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# per-type tolerances, tests/linalg/internal/utils.hpp:20-44
TOLS = {
    np.dtype(np.float32): 1e-3,
    np.dtype(np.float64): 1e-6,
    np.dtype(np.complex64): 1e-3,
    np.dtype(np.complex128): 1e-6,
}

ALL_DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


@pytest.fixture(params=ALL_DTYPES, ids=["f32", "f64", "c64", "c128"])
def dtype(request):
    return np.dtype(request.param)


def kernel_tol(dtype):
    return TOLS[np.dtype(dtype)]


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip a ``gpu``-marked test unless this machine has an NVIDIA GPU.
    Decided here, at run time — never at import or collection."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import shutil
    import subprocess
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest tests -m gpu)")
