"""Hello world: Clement matrix, sequence of 3 correlated solves.

Equivalent of the reference's examples/1_hello_world.cpp:42-175 (Clement
N=1200 on a distributed layout, idx_max=3 sequence, PerformanceDecorator).
"""

import numpy as np
import chase_tpu
from chase_tpu.device import use_compile_cache
from chase_tpu.models import clement

use_compile_cache()

N, nev, nex = 1200, 100, 40
H = clement(N)

grid = chase_tpu.make_grid() if len(__import__("jax").devices()) > 1 else None

v0 = ritzv0 = None
for idx in range(3):
    # the reference re-solves the same Clement matrix warm-started
    res = chase_tpu.eigsh(
        H, nev, nex, grid=grid, collect_perf=True,
        v0=v0, ritzv0=ritzv0, approx=idx > 0)
    v0, ritzv0 = np.asarray(res.V), res.ritzv_full
    print(f"solve {idx}: converged={res.converged} "
          f"iterations={res.iterations} max_resid={res.resid.max():.2e}")
    print(res.perf.report(N, 25, 4, H.dtype))

exact = np.arange(-(N - 1), -(N - 1) + 2 * nev, 2)
print("max eigenvalue error vs exact Clement spectrum:",
      np.abs(res.ritzv - exact).max())
