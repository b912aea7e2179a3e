"""chase_tpu.device: platform checks, memory, peak table, compile cache,
and the one-card-per-process launch rule."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chase_tpu
from chase_tpu import device
from chase_tpu.parallel import multihost


class FakeDevice:
    def __init__(self, platform="gpu", stats=None, kind="FakeCard"):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5},
                                   {"bytes_limit": 0}])
def test_accelerator_without_bytes_limit_raises(stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        device.memory_bytes(FakeDevice(stats=stats))


def test_memory_bytes_reads_the_limit_and_host_memory():
    assert device.memory_bytes(FakeDevice(stats={"bytes_limit": 123})) == 123
    host = device.memory_bytes()          # the CPU: physical host memory
    assert host == os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert host > 0


def test_check_platform(monkeypatch):
    device.check_platform()               # cpu is supported
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice("metal")])
    with pytest.raises(RuntimeError, match="unsupported JAX platform 'metal'"):
        device.check_platform()


def test_unsupported_platform_raises_at_first_solve(monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice("rocm")])
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        chase_tpu.eigsh(np.eye(16), 2, 2)


def test_peak_table_h100_data_sheet():
    kind = "NVIDIA H100 80GB HBM3"
    assert device.PEAKS[kind] == {
        "bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "fp64": 67e12,
        "int8": 1979e12, "hbm_bytes_per_s": 3.35e12}
    assert "H100" in device.PEAKS_SOURCE and "700 W" in device.PEAKS_SOURCE
    assert device.peak("fp64", kind) == 67e12
    assert device.peak("bf16", "cpu") is None
    assert device.peak("bf16") is None            # this CPU run


@pytest.mark.parametrize("dtype,precision,rung", [
    (np.float32, "highest", "fp32"),
    (np.float32, "high", "tf32"),
    (np.float32, "default", "tf32"),
    (jnp.bfloat16, "default", "bf16"),
    (np.complex64, "highest", "fp32"),
    (np.float64, "highest", "fp64"),
    (np.complex128, "highest", "fp64"),
    (jnp.bfloat16, "highest", "bf16"),
])
def test_precision_rung(dtype, precision, rung):
    assert device.precision_rung(dtype, precision) == rung


def test_compile_cache_placement(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        jax.config.update("jax_compilation_cache_dir", before)
        assert device.use_compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before   # untouched

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        first = device.use_compile_cache()
        second = device.use_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(
            chase_tpu.__file__)))
        assert first == second == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_not_set_on_import():
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, chase_tpu; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"


_RANK_ENVS = multihost._LOCAL_RANK_ENVS + (
    "JAX_LOCAL_DEVICE_IDS", "CUDA_VISIBLE_DEVICES")


@pytest.mark.parametrize("env,coord,pid,want", [
    ({}, "localhost:1234", 2, [2]),
    ({}, "127.0.0.1:1234", 0, [0]),
    ({}, "node7:1234", 2, None),
    ({}, "localhost:1234", None, None),
    ({"OMPI_COMM_WORLD_LOCAL_RANK": "3"}, "node7:1234", 9, [3]),
    ({"SLURM_LOCALID": "1"}, None, None, [1]),
    ({"CUDA_VISIBLE_DEVICES": "2"}, "localhost:1234", 1, None),
    ({"CUDA_VISIBLE_DEVICES": "0,1,2,3", "SLURM_LOCALID": "2"}, None, None,
     [2]),
    ({"CUDA_VISIBLE_DEVICES": "0,1"}, "localhost:1234", 1, [1]),
    ({"JAX_LOCAL_DEVICE_IDS": "0"}, "localhost:1234", 1, None),
])
def test_one_card_per_process(monkeypatch, env, coord, pid, want):
    for name in _RANK_ENVS:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.local_device_ids(coord, pid) == want


def test_has_gpu_false_on_cpu():
    from chase_tpu import interface
    assert interface.has_gpu() is False
