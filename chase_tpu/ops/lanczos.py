"""Stochastic block Lanczos for spectral-bound estimation + DoS.

JAX redesign of the reference's batched Lanczos
(linalg/internal/cpu/lanczos.hpp:46-209, driven by
algorithm/algorithm.inc:1067-1214) :

* The ``numvec`` independent Lanczos runs are *vectorized*: one
  ``lax.scan`` carries all probe vectors as an (N, numvec) block so every
  step is a single N×N×numvec matmul (the reference loops BLAS-1
  calls per vector; the CUDA backend hand-writes batched kernels in
  lanczos_kernels.cu — XLA fuses our batched dots/axpys for free).
* Tridiagonal eigensolves (m ≤ ~25) happen on host in numpy — they are
  O(numvec·m²) and would waste a device round-trip per probe.
* The Lanczos basis of the *last* probe vector is stacked as a scan output
  for the DoS vector extraction (reference LanczosDos,
  chase_cpu.hpp:358-380).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..types import real_dtype

__all__ = ["lanczos_scan", "lanczos_tridiag_host", "dos_lower_bound",
           "upper_bound", "lanczos_dos_vectors"]


@partial(jax.jit, static_argnames=("m", "precision", "want_basis"))
def lanczos_scan(H, V0, *, m, precision="highest", want_basis=True):
    """Run m Lanczos steps on each column of V0 simultaneously.

    Returns:
      alphas: (m, numvec) real — tridiagonal diagonal d.
      betas:  (m, numvec) real — ‖residual‖ per step; betas[:-1] is the
              off-diagonal e, betas[-1] feeds the upper-bound estimate.
      basis:  (m, N) — Lanczos basis vectors of the LAST probe column
              (None if want_basis=False).
    """
    rt = real_dtype(H.dtype)
    v1 = V0.astype(H.dtype)
    nrm = jnp.linalg.norm(v1, axis=0).real
    v1 = v1 / nrm[None, :].astype(v1.dtype)
    v0 = jnp.zeros_like(v1)
    beta0 = jnp.zeros((v1.shape[1],), rt)

    def step(carry, _):
        v0, v1, beta_prev = carry
        w = jnp.matmul(H, v1, precision=precision)
        alpha = jnp.sum(v1.conj() * w, axis=0).real.astype(rt)
        w = w - alpha[None, :].astype(w.dtype) * v1 \
              - beta_prev[None, :].astype(w.dtype) * v0
        beta = jnp.linalg.norm(w, axis=0).real.astype(rt)
        safe = jnp.where(beta > 0, beta, jnp.ones((), rt))
        v2 = w / safe[None, :].astype(w.dtype)
        out = (alpha, beta, v1[:, -1]) if want_basis else (alpha, beta)
        return (v1, v2, beta), out

    _, outs = jax.lax.scan(step, (v0, v1, beta0), None, length=m)
    if want_basis:
        alphas, betas, basis = outs
        return alphas, betas, basis
    alphas, betas = outs
    return alphas, betas, None


def lanczos_tridiag_host(alphas, betas, want_vectors=True):
    """Eigendecompose each probe's tridiagonal on host.

    Args:
      alphas, betas: (m, numvec) numpy arrays from :func:`lanczos_scan`.

    Returns:
      theta: (numvec, m) Ritz values ascending per probe.
      tau:   (numvec, m) |first eigenvector component|² weights (DoS).
      ritzV_last: (m, m) eigenvectors of the last probe's tridiagonal
                  (columns), or None.
    """
    m, numvec = alphas.shape
    theta = np.empty((numvec, m), dtype=np.float64)
    tau = np.empty((numvec, m), dtype=np.float64)
    ritzV_last = None
    for i in range(numvec):
        T = np.diag(alphas[:, i].astype(np.float64))
        if m > 1:
            off = betas[:-1, i].astype(np.float64)
            T += np.diag(off, 1) + np.diag(off, -1)
        evals, evecs = np.linalg.eigh(T)
        theta[i] = evals
        tau[i] = np.abs(evecs[0, :]) ** 2
        if want_vectors and i == numvec - 1:
            ritzV_last = evecs
    return theta, tau, ritzV_last


def dos_lower_bound(theta, tau, nevex, N, is_pseudo=False):
    """Gaussian-broadened cumulative DoS quantile → lowerb.

    Mirrors the quantile walk in algorithm/algorithm.inc:1096-1145:
    a Gaussian-smoothed (σ=0.25) CDF built from the τ-weighted Ritz values
    is scanned until it crosses nevex/N; the crossing Ritz value is the
    lower end of the damping interval.
    """
    numvec, m = theta.shape
    theta_flat = theta.reshape(-1)      # probe-major, like the reference
    tau_flat = tau.reshape(-1)
    order = np.argsort(theta_flat)
    theta_sorted = theta_flat[order]

    lam = theta_sorted[0]
    sigma = 0.25
    threshold = 2 * sigma * sigma / 10
    search = float(nevex) / float(N)
    bound = m // 2 if is_pseudo else m
    n = numvec * bound

    def G(x):
        return 0.5 * (1 + _erf(x / np.sqrt(2 * sigma * sigma)))

    lowerb = theta_sorted[min(n, len(theta_sorted)) - 1]
    prev = 0.0
    tf = theta_flat[:n]
    wf = tau_flat[:n]
    for i in range(n - 1):
        x = theta_sorted[i]
        lo = x < (tf - threshold)
        hi = x > (tf + threshold)
        mid = ~(lo | hi)
        curr = float(np.sum(wf[hi]) + np.sum(wf[mid] * G(x - tf[mid])))
        curr /= numvec
        if curr > search:
            if abs(curr - search) < abs(prev - search) and i + 1 < n:
                lowerb = theta_sorted[i + 1]
            else:
                lowerb = theta_sorted[i]
            break
        prev = curr
    return float(lam), float(lowerb)


def _erf(x):
    from scipy.special import erf as _scipy_erf  # scipy ships with jax deps
    return _scipy_erf(x)


def upper_bound(theta, betas_last):
    """upperb = max_i ( max(|θ_i,first|, |θ_i,last|) + |β_i,last| ).

    Mirrors cpu/lanczos.hpp:196-209.
    """
    numvec = theta.shape[0]
    ub = -np.inf
    for i in range(numvec):
        ub = max(ub, max(abs(theta[i, 0]), abs(theta[i, -1])) + abs(betas_last[i]))
    return float(ub)


@partial(jax.jit, static_argnames=("precision",))
def lanczos_dos_vectors(basis, ritzV, idx_mask, *, precision="highest"):
    """DoS starting vectors: basis (m, N) → (N, m) @ ritzV, masked columns.

    Columns j with idx_mask[j]==False return zeros (caller keeps its random
    vectors there).  Mirrors LanczosDos (chase_cpu.hpp:358-374).
    """
    Vd = jnp.matmul(basis.T, ritzV.astype(basis.dtype), precision=precision)
    return Vd * idx_mask[None, :].astype(Vd.dtype)
