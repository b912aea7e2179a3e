"""Fortran binding ↔ C ABI consistency check.

The reference tests Fortran end-to-end (chase_fortran_{serial,distributed}
_solve.f90); without assuming a Fortran compiler, the next-best
automated guarantee is enforced here: every ``bind(c, name='…')``
declaration in interface/chase_tpu_fortran.f90 must resolve against
libchase_tpu.so's export table, and every user-facing ``*chase*`` symbol
the library exports must be declared in the Fortran module.  If a Fortran
compiler ever appears in the image, the module is additionally compiled
and a driver is linked + run.
"""

import ctypes
import os
import re
import shutil
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F90 = os.path.join(REPO, "interface", "chase_tpu_fortran.f90")


def _f90_bound_names():
    src = open(F90).read()
    return sorted(set(re.findall(r"bind\(c,\s*name='([^']+)'\)", src,
                                 re.IGNORECASE)))


@pytest.fixture(scope="module")
def capi_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    from chase_tpu import _native
    path = _native.build_capi(
        str(tmp_path_factory.mktemp("abi") / "libchase_tpu.so"))
    return path


def test_every_fortran_declaration_resolves(capi_lib):
    names = _f90_bound_names()
    assert len(names) >= 20, f"suspiciously few declarations: {names}"
    lib = ctypes.CDLL(capi_lib)
    missing = [n for n in names if not hasattr(lib, n)]
    assert not missing, f"f90 declares symbols the .so lacks: {missing}"


def test_every_exported_chase_symbol_is_declared(capi_lib):
    """Reverse direction: the Fortran module must cover the full dynamic
    export surface (catches bindings forgotten when the ABI grows)."""
    nm = subprocess.run(["nm", "-D", "--defined-only", capi_lib],
                        check=True, capture_output=True, text=True).stdout
    exported = sorted(
        m.group(1) for m in re.finditer(r"\sT\s+(\w*chase\w*)", nm))
    assert exported, "no chase symbols exported?"
    declared = set(_f90_bound_names())
    missing = [s for s in exported if s not in declared]
    assert not missing, (
        f"exported C symbols without a Fortran declaration: {missing}")


def test_fortran_compiles_and_runs_if_compiler_present(capi_lib, tmp_path):
    fc = shutil.which("gfortran") or shutil.which("flang")
    if fc is None:
        pytest.skip("no Fortran compiler in this image")
    driver = tmp_path / "driver.f90"
    driver.write_text("""
program demo
    use chase_tpu_interface
    use iso_c_binding
    implicit none
    integer(c_int) :: n, nev, nex, ldh, init, deg
    real(c_double) :: tol
    real(c_double), allocatable :: h(:, :), v(:, :), ritzv(:)
    integer :: i, j
    n = 64; nev = 4; nex = 4; ldh = n; init = 0; deg = 10; tol = 1.0d-8
    allocate(h(n, n), v(n, nev + nex), ritzv(nev + nex))
    h = 0.0d0
    do i = 1, n - 1
        h(i + 1, i) = sqrt(real(i * (n - i), c_double))
        h(i, i + 1) = h(i + 1, i)
    end do
    call dchase_init(n, nev, nex, h, ldh, v, ritzv, init)
    call dchase(deg, tol, 'R', 'S', 'C')
    call dchase_get_eigenpairs(v, n, ritzv)
    call dchase_finalize(init)
    print *, 'fortran demo: PASS', ritzv(1)
end program demo
""")
    exe = str(tmp_path / "fdemo")
    subprocess.run([fc, F90, str(driver), "-L", os.path.dirname(capi_lib),
                    "-lchase_tpu", "-o", exe], check=True,
                   capture_output=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["LD_LIBRARY_PATH"] = os.path.dirname(capi_lib)
    env["CHASE_TPU_PLATFORM"] = "cpu"
    r = subprocess.run([exe], capture_output=True, text=True, env=env,
                       timeout=500)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS" in r.stdout
