"""chip_smoke.py: refuses to run without a GPU, and its host-side checks
are right at tiny sizes.  The script itself runs on the card (gpu mark)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cpu_run_fails_without_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, SCRIPT], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_residual_and_eigenvalue_checks(smoke):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((40, 40))
    H = (A + A.T) / 2
    w, V = np.linalg.eigh(H)
    cols = smoke.spread_columns(10, 4)
    assert list(cols) == [0, 3, 6, 9]
    assert smoke.max_residual(H, V, w, cols) < 1e-12
    # a wrong eigenvalue shows up as exactly its error in the residual
    w_bad = w.copy()
    w_bad[3] += 1e-3
    assert abs(smoke.max_residual(H, V, w_bad, cols) - 1e-3) < 1e-9
    assert smoke.eig_error(w_bad[:5], w[:5]) == pytest.approx(1e-3)


def test_orthogonality_check(smoke):
    Q, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((30, 6)))
    assert smoke.orth_error(Q) < 1e-14
    Q[:, 2] *= 1 + 1e-6
    assert smoke.orth_error(Q) == pytest.approx(2e-6, rel=1e-3)
    Qc = Q[:, :3] * np.exp(0.3j)
    assert smoke.orth_error(Qc) == pytest.approx(2e-6, rel=1e-3)


def test_scaled_clement_spectrum(smoke):
    N = 24
    H = smoke.scaled_clement(N, np.float64)
    np.testing.assert_allclose(np.linalg.eigvalsh(H)[:5],
                               smoke.clement_exact(N, 5), atol=1e-13)
    assert smoke.clement_exact(N, N)[-1] == 1.0


@pytest.mark.parametrize("peaks,share", [
    ([5, 5, 5, 5], 0.25), ([10, 2, 2, 2], 0.625), ([7, 1, 1, 1], 0.7)])
def test_one_device_holds_everything_check(smoke, peaks, share):
    assert smoke.max_memory_share(peaks) == pytest.approx(share)
    assert (smoke.max_memory_share(peaks) > 0.6) == (share > 0.6)


@pytest.mark.gpu
def test_chip_smoke_fused_phase_on_gpu():
    """Phase e (fused driver) on the card, called directly in a process of
    its own (this one is held to the CPU); the full script, and its ok
    line, is ``python chip_smoke.py``."""
    code = ("import jax, chase_tpu, chip_smoke\n"
            "assert jax.devices()[0].platform == 'gpu'\n"
            "jax.config.update('jax_enable_x64', True)\n"
            "assert chip_smoke.phase_e(chase_tpu, jax.devices()[:1])\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    phase = json.loads(r.stdout.strip().splitlines()[-1])
    assert phase["phase"] == "e" and phase["pass"] is True
