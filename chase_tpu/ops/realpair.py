"""Complex Hermitian solves in real arithmetic (real-pair mode, opt-in).

Native complex GEMMs have no bf16 rung.  This module solves a complex
Hermitian problem with PURELY REAL device arithmetic via the standard
symplectic embedding (``complex_backend='real_pair'``):

    H = Hr + i·Hi  (Hr symmetric, Hi antisymmetric)
    J = [[Hr, -Hi],
         [Hi,  Hr]]          — real symmetric, (2N, 2N)

Each eigenvalue λ of H appears twice in J; the 2-dimensional real
eigenspace of the pair is span{[a; b], [-b; a]} where v = a + i·b is the
complex eigenvector, so ANY unit vector [x; y] in it reconstructs a valid
complex eigenvector v = x + i·y with ‖Jz − λz‖₂ = ‖Hv − λv‖₂ exactly.

The whole real solver stack (filter windows, refinement ladder, bf16 rung,
ring schedules, sharding) applies unchanged to J — an alternative to the
reference's {c,z} backends (its kernels call complex
BLAS, e.g. Impl/chase_cpu/chase_cpu.hpp:449-508; test matrix
tests/chase_serial_solve.cpp:23-120).  Cost: the subspace doubles, so the
filter does 2× the FLOPs of a native complex HEMM, in exchange for the
real bf16/f32 rungs.

Degenerate eigenvalues of H (multiplicity m → 2m in J) are handled in the
pair extraction: candidates are clustered by Ritz value and each cluster's
complex span is re-orthonormalized (pivoted QR), keeping exactly m
independent complex vectors.
"""

from __future__ import annotations

import numpy as np

__all__ = ["embed_real", "embed_block", "extract_pairs",
           "pseudo_perm", "embed_real_pseudo", "embed_block_pseudo"]


def embed_real(H):
    """Complex (N, N) Hermitian → real symmetric (2N, 2N) J (numpy)."""
    H = np.asarray(H)
    rdt = np.float32 if H.dtype == np.complex64 else np.float64
    Hr = np.ascontiguousarray(H.real, dtype=rdt)
    Hi = np.ascontiguousarray(H.imag, dtype=rdt)
    N = H.shape[0]
    J = np.empty((2 * N, 2 * N), rdt)
    J[:N, :N] = Hr
    J[:N, N:] = -Hi
    J[N:, :N] = Hi
    J[N:, N:] = Hr
    return J


def embed_block(V):
    """Complex (N, k) multivector → real (2N, 2k) warm-start basis.

    Each complex column v = a + i·b spans a 2-dimensional real eigenspace
    of J; the pair ([a; b], [-b; a]) = (v, i·v) seeds both members, so a
    complex warm start covers the full doubled subspace (columns
    interleaved to match ``np.repeat(ritzv0, 2)``)."""
    V = np.asarray(V)
    rdt = np.float32 if V.dtype == np.complex64 else np.float64
    a = V.real.astype(rdt)
    b = V.imag.astype(rdt)
    N, k = V.shape
    X = np.empty((2 * N, 2 * k), rdt)
    X[:N, 0::2] = a
    X[N:, 0::2] = b
    X[:N, 1::2] = -b
    X[N:, 1::2] = a
    return X


def pseudo_perm(N: int) -> np.ndarray:
    """Row permutation carrying the [re; im] embedding of a pseudo-Hermitian
    problem back to the canonical signature.

    A complex BSE matrix is pseudo-Hermitian w.r.t. S = diag(I_{N/2},
    −I_{N/2}).  Its symplectic embedding J = [[Hr, −Hi], [Hi, Hr]] is real
    pseudo-symmetric w.r.t. diag(S, S) — the + and − rows interleave in
    blocks of N/2.  Grouping all + rows first (re⁺, im⁺) then all − rows
    (re⁻, im⁻) restores the canonical diag(I_N, −I_N) the real pseudo
    solver (ops/pseudo.apply_s, solver_pseudo) is written against:
    J' = J[P][:, P] is then just another REAL BSE-form matrix of size 2N
    and the whole real pseudo stack (H² filter, S-metric Lanczos, pencil
    RR, K-conjugation) applies verbatim — an alternative to the
    reference's {c,z} solve_pseudo backends
    (tests/chase_serial_solve.cpp + interface/chase_c_interface.h:159-175).
    """
    n = N // 2
    return np.concatenate([
        np.arange(0, n),              # re of the + half
        np.arange(N, N + n),          # im of the + half
        np.arange(n, N),              # re of the − half
        np.arange(N + n, 2 * N),      # im of the − half
    ])


def embed_real_pseudo(H):
    """Complex (N, N) pseudo-Hermitian → real BSE-form (2N, 2N) J''.

    Two coordinate transforms on the symplectic embedding J:

    1. the signature permutation P of :func:`pseudo_perm`, and
    2. a diagonal ±1 similarity D negating the im sub-block of the
       NEGATIVE half.  The real solver mirrors locked pairs by the plain
       half-swap K-conjugation (ops/pseudo.k_conjugate_cols,
       chase_cpu.hpp:557-588); on the bare permuted embedding that swap
       is NOT the complex K (K v = conj([v₂; v₁]) — the conj negates im
       parts) and the mirrored "locked −λ" columns are not eigenvectors,
       which stalls convergence at one vector per doubled pair (measured:
       locked=2/16 at 25 iterations).  Conjugating by D makes the plain
       swap exactly the complex K: ``d⁺ ⊙ d⁻ = (1_{N/2}, −1_{N/2})``
       within each half.  With it the embedded solve converges like the
       native one (3 iterations on the 128-pair test problem).

    Returns (J'', perm, d) with ``J'' = D·J[perm][:, perm]·D``;
    spec(J'') = spec(H) with every (real) eigenvalue doubled, and eigvec
    z of J'' ↔ complex eigvec v of H via
    ``y = (d·z)[argsort(perm)]; v = y[:N] + i·y[N:]`` (same eigenvalue,
    identical residual norm)."""
    H = np.asarray(H)
    N = H.shape[0]
    if N % 2:
        raise ValueError("pseudo-Hermitian problems need even N")
    J = embed_real(H)                 # [[Hr, -Hi], [Hi, Hr]]
    P = pseudo_perm(N)
    d = np.ones(2 * N, J.dtype)
    d[2 * N - N // 2:] = -1.0         # im sub-block of the − half
    Jpp = d[:, None] * J[np.ix_(P, P)] * d[None, :]
    return np.ascontiguousarray(Jpp), P, d


def embed_block_pseudo(V, perm, d):
    """Complex (N, k) multivector → real (2N, 2k) warm-start basis in the
    transformed coordinates of :func:`embed_real_pseudo`."""
    return np.ascontiguousarray(d[:, None] * embed_block(V)[perm])


def extract_pairs(ritzv2, X2, resid2, nev, *, cluster_tol=None):
    """Collapse the doubled real solution back to complex eigenpairs.

    Args:
      ritzv2: (≥2·nev,) doubled Ritz values, ascending.
      X2: (2N, ≥2·nev) real eigenvectors of J ([x; y] stacking).
      resid2: (≥2·nev,) residuals ‖Jz − λz‖ = ‖Hv − λv‖.
      nev: number of complex pairs wanted.
      cluster_tol: eigenvalues closer than this are treated as one
        degenerate cluster (default: 1e3·eps·max|λ|).

    Returns (ritzv (nev,), V (N, nev) complex, resid (nev,)).
    """
    ritzv2 = np.asarray(ritzv2, np.float64)
    X2 = np.asarray(X2)
    n2, k2 = X2.shape
    N = n2 // 2
    cdt = np.complex64 if X2.dtype == np.float32 else np.complex128
    if cluster_tol is None:
        scale = float(np.max(np.abs(ritzv2))) or 1.0
        eps = np.finfo(X2.dtype).eps
        cluster_tol = 1e3 * eps * scale

    # cluster boundaries over the doubled spectrum
    bounds = [0]
    for j in range(1, k2):
        if ritzv2[j] - ritzv2[j - 1] > cluster_tol:
            bounds.append(j)
    bounds.append(k2)

    vals, vecs, res = [], [], []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if len(vals) >= nev:
            break
        m2 = b1 - b0                      # J-multiplicity (= 2m for exact m)
        m = max(1, m2 // 2)               # complex multiplicity
        cand = X2[:N, b0:b1] + 1j * X2[N:, b0:b1]        # (N, m2) candidates
        if m2 == 2:
            # the generic case: both candidates span the SAME complex
            # direction — keep the one with the better residual
            jbest = b0 + int(np.argmin(resid2[b0:b1]))
            v = X2[:N, jbest] + 1j * X2[N:, jbest]
            nrm = np.linalg.norm(v)
            vals.append(ritzv2[jbest])
            vecs.append((v / nrm).astype(cdt))
            res.append(float(resid2[jbest]))
            continue
        # degenerate cluster: complex rank of the 2m candidates is m —
        # pivoted QR keeps the m best-conditioned directions (any
        # orthonormal basis of the eigenspace is valid; within the cluster
        # the values are numerically equal so ordering is immaterial)
        import scipy.linalg as sla
        Q, _, _ = sla.qr(cand.astype(np.complex128), mode="economic",
                         pivoting=True)
        take = min(m, nev - len(vals))
        cl_vals = np.sort(ritzv2[b0:b1])
        cl_res = float(np.max(resid2[b0:b1]))
        for t in range(take):
            vals.append(float(cl_vals[2 * t]))
            vecs.append(Q[:, t].astype(cdt))
            res.append(cl_res)
    vals = np.asarray(vals[:nev])
    V = np.stack(vecs[:nev], axis=1)
    return vals, V, np.asarray(res[:nev])
