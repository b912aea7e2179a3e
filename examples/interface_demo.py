"""Flat-interface demo (reference examples/4_interface C/Fortran drivers):
the init/solve/get/finalize lifecycle for codes ported from the C ABI."""

import numpy as np
import chase_tpu.interface as chase
from chase_tpu.device import use_compile_cache
from chase_tpu.models import clement

use_compile_cache()

N, nev, nex = 1001, 100, 40
H = clement(N)

chase.init(N, nev, nex, H)            # dchase_init_
chase.set_tol(1e-10)
rc = chase.solve(deg=20, mode="R", opt="S", qr="C")   # dchase_
print("solve rc:", rc)
evals, evecs = chase.get_eigenpairs()  # dchase_get_eigenpairs_
print("eigenvalues[:5]:", evals[:5])

rc = chase.solve(mode="A")             # warm-started second solve
print("warm solve rc:", rc)
chase.finalize()                       # dchase_finalize_
