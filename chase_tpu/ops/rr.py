"""Rayleigh–Ritz projection fused with residual computation.

JAX redesign of the reference's RR + Resd pair
(linalg/internal/cpu/rayleighRitz.hpp:60-112 and cpu/residuals.hpp:56-83).

Key deviations, all driven by XLA's static-shape compilation:

* **Static shapes**: the reference projects only the active columns
  ``Q[:, locked:]`` (shrinking shapes every iteration).  We always project
  the full ``nev+nex`` block but zero the locked columns and pin their
  projected diagonal entries to a value strictly above the spectrum of the
  active block (``2·‖A‖_F + 1``).  The small eigenproblem then decouples
  exactly: the locked slots produce eigenpairs (big, e_j) that sort to the
  tail of the ascending `eigh` output and are discarded.  One XLA program
  serves every ``locked``.
* **Fusion**: the reference runs two full HEMMs per iteration — ``W = H·Q``
  inside RR and a second ``H·V`` inside Resd.  Here residuals reuse
  ``(H·Q)·Z = H·(Q·Z)``, eliminating one N×N×k matmul per iteration
  (the second-hottest op after the filter).
* The rotated eigenvector block is *rolled* right by ``locked`` so callers
  can merge it into the full V with a column mask.
* ``small_dense="host"`` routes the k×k projected eigh through host LAPACK
  in full f64 between two jitted halves (a split-sync, not a
  ``pure_callback``).  This opt-in path is the redundant-heevd +
  RR_DOUBLE_PRECISION analogue (P8, mpi/rayleighRitz.hpp:147-180): the
  k×k transfer is tiny; the default keeps the eigh on the device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..types import real_dtype, is_double_base

__all__ = ["rayleigh_ritz_residuals", "host_eigh_f64", "eigh_polished",
           "pin_value"]


def eigh_polished(A, *, passes=2, precision="highest", pin_cut=None):
    """``jnp.linalg.eigh`` + Ogita–Aishima eigenvector refinement.

    An iterative backend eigensolver can return eigenVECTORS with relative
    residual ~1e-6 even in f64 — far above the 1e-10 DP tolerance target, and
    then tight-tolerance solves plateau/bounce.  Each polish pass applies the
    quadratically convergent refinement of Ogita & Aishima (2018, "Iterative
    refinement for symmetric eigenvalue decomposition"): with R = I − ZᴴZ
    and S = ZᴴAZ,

        λ̃_i = S_ii / (1 − R_ii)
        E_ij = (S_ij + λ̃_j R_ij) / (λ̃_j − λ̃_i)   (well-separated pairs)
        E_ij = R_ij / 2                            (clustered pairs, diag)
        Z ← Z (I + E)

    Two passes take the backend eigh to LAPACK-quality (≲1e-12 relative)
    for a few k×k matmuls — pure matmul work, in-graph, so the FUSED solver
    gets the same fix (no host eigh needed).  Clustered pairs only get the
    orthogonality half of the update; their intra-cluster mixing is
    harmless for an (almost-)degenerate eigenspace.

    Cost: ~3 k×k matmuls per pass — negligible against the N²k projection.
    Returns (w, Z) ascending, like ``jnp.linalg.eigh``.

    ``pin_cut``: when A carries locked slots pinned to a large diagonal
    value ``big`` (see :func:`_pin_locked`), pass ``big / 2`` so the
    sqrt(eps)-relative gap floor is computed from the ACTIVE spectrum only
    (eigenvalues < pin_cut).  Without it the pinned magnitude inflates the
    floor ~2·sqrt(k)× and active pairs with genuine sqrt(eps)-scale gaps
    are misclassified as clusters, skipping their rotation correction.
    """
    w, Z = jnp.linalg.eigh(A)
    if passes <= 0:
        return w, Z
    rt = w.dtype
    k = A.shape[0]
    I = jnp.eye(k, dtype=A.dtype)
    one = jnp.ones((), A.dtype)
    for _ in range(passes):
        R = I - jnp.matmul(Z.conj().T, Z, precision=precision)
        S = jnp.matmul(Z.conj().T, jnp.matmul(A, Z, precision=precision),
                       precision=precision)
        lam = (jnp.real(jnp.diagonal(S))
               / (1 - jnp.real(jnp.diagonal(R)))).astype(rt)
        num = S + lam[None, :].astype(A.dtype) * R
        d = (lam[None, :] - lam[:, None]).astype(A.dtype)
        # Rotate only across gaps resolved above BOTH the first-order
        # validity bound (|d| > 2|num|) and a sqrt(eps)-relative gap floor.
        # num carries absolute noise ~k·eps·‖A‖, so a pair with gap δ gets a
        # spurious rotation k·eps·‖A‖/δ whose orthogonality damage is its
        # SQUARE; δ ≥ sqrt(eps)·‖A‖ bounds that damage by ~k²·eps.  Pairs
        # tighter than the floor are treated as a cluster (R/2 half-update):
        # leaving their mixing uncorrected costs at most δ in residual —
        # below the floor by construction.
        lam_scale = jnp.max(jnp.abs(lam)) if pin_cut is None else \
            jnp.max(jnp.where(lam < jnp.asarray(pin_cut, rt),
                              jnp.abs(lam), jnp.zeros((), rt)))
        gap_floor = jnp.asarray(np.sqrt(np.finfo(rt).eps), rt) * lam_scale
        ok = (jnp.abs(d) > 2 * jnp.abs(num)) & (jnp.abs(d) > gap_floor)
        E = jnp.where(ok, num / jnp.where(ok, d, one), R / 2)
        E = E - jnp.diag(jnp.diagonal(E)) + jnp.diag(jnp.diagonal(R) / 2)
        Z = Z + jnp.matmul(Z, E, precision=precision)
        w = lam
    order = jnp.argsort(w)   # polish can reorder near-degenerate pairs
    return w[order], Z[:, order]


def eigh_polished_wide(A, *, passes=3, pin_cut=None):
    """f64-accurate eigh of a REAL symmetric k×k matrix with NO f64 dots
    and NO f64 factorization in the graph: f32 ``jnp.linalg.eigh`` start +
    Ogita–Aishima passes whose k×k matmuls run on the exact-int8-slice
    GEMM (ops/wide).  The projected eigensolve of the fused DP solver
    under wide_f64='on', which keeps every f64 contraction out of the
    one-dispatch program.

    The f32 start leaves ~1e-6–1e-7 eigenvector error; OA converges
    quadratically, so ``passes=3`` reaches the ~1e-13 floor (1e-6 → 1e-12
    → floor).  Same cluster/gap-floor policy as :func:`eigh_polished`.
    Returns (w, Z) ascending in A's dtype.
    """
    from .wide import wide_matmul

    rt = real_dtype(A.dtype)
    w32, Z32 = jnp.linalg.eigh(A.astype(jnp.float32))
    Z = Z32.astype(A.dtype)
    w = w32.astype(rt)
    k = A.shape[0]
    I = jnp.eye(k, dtype=A.dtype)
    one = jnp.ones((), A.dtype)
    for _ in range(passes):
        R = I - wide_matmul(Z.T, Z)
        S = wide_matmul(Z.T, wide_matmul(A, Z))
        lam = (jnp.diagonal(S) / (1 - jnp.diagonal(R))).astype(rt)
        num = S + lam[None, :] * R
        d = lam[None, :] - lam[:, None]
        lam_scale = jnp.max(jnp.abs(lam)) if pin_cut is None else \
            jnp.max(jnp.where(lam < jnp.asarray(pin_cut, rt),
                              jnp.abs(lam), jnp.zeros((), rt)))
        gap_floor = jnp.asarray(np.sqrt(np.finfo(rt).eps), rt) * lam_scale
        ok = (jnp.abs(d) > 2 * jnp.abs(num)) & (jnp.abs(d) > gap_floor)
        E = jnp.where(ok, num / jnp.where(ok, d, one), R / 2)
        E = E - jnp.diag(jnp.diagonal(E)) + jnp.diag(jnp.diagonal(R) / 2)
        Z = Z + wide_matmul(Z, E)
        w = lam
    order = jnp.argsort(w)
    return w[order], Z[:, order]


def host_eigh_f64(A_h, rt):
    """Host LAPACK eigh of the projected matrix in full f64/c128; results
    cast back to the problem precision.  Shared by the split-sync host
    path below and the fused solver's pure_callback."""
    wide = np.complex128 if np.iscomplexobj(A_h) else np.float64
    w, Z = np.linalg.eigh(np.asarray(A_h).astype(wide))
    return w.astype(np.dtype(rt)), Z.astype(A_h.dtype)


def pin_value(A, rt):
    """Diagonal value that pins the locked slots of the projected matrix A
    (locked rows/columns zero) above its active spectrum: 2·b + 1 with b
    the smaller of two bounds on ‖A‖₂, the Frobenius norm and the largest
    absolute row sum.  Kept as small as that: an eigensolver's backward
    error scales with ‖A‖₂, pins included: on an H100, cuSOLVER's f32 eigh
    left active residuals of ~1e-6·‖A‖₂, so a Frobenius-sized pin
    (~√k·λ_max) alone put them above the default 1e-5 tolerance at
    k=768."""
    b = jnp.minimum(jnp.linalg.norm(A),
                    jnp.max(jnp.sum(jnp.abs(A), axis=1)))
    return 2 * b.real.astype(rt) + 1


def _pin_locked(A, active, rt):
    """Decouple the locked slots: eigh(A + big·diag(1-active)) has
    eigenpairs (big, e_j) there, strictly above the active spectrum.
    Returns (A_pinned, big); ``big / 2`` separates pinned from active
    eigenvalues (|λ_active| ≤ ‖A‖₂ < big/2) and feeds eigh_polished's
    pin_cut."""
    big = pin_value(A, rt)
    return A + jnp.diag(jnp.where(active, jnp.zeros((), rt),
                                  big)).astype(A.dtype), big


@partial(jax.jit, static_argnames=("precision",))
def _rr_project(H, V, locked, *, precision="highest"):
    """Device half 1: masked block, H·Q, pinned projected matrix.

    For 64-bit problems the active columns are explicitly RENORMALIZED
    before projecting: a column with ‖q‖² = 1 − η yields a Rayleigh
    quotient biased by λ·η; a QR chain with an f32 factorization (the
    mixed-precision and wide paths) can leave η ~ eps_f32, which would
    freeze a DP solve at |λ|·eps_f32 ≈ 1e-7·‖H‖ residuals.
    Normalization is exact elementwise f64 work and makes RR immune to
    any upstream normalization sloppiness.

    32-bit problems SKIP it: there the norm reduction itself carries
    ~√N·eps_f32 rounding, and dividing by it perturbs every column ABOVE
    the f32 floor the solve is converging toward, while the η it would
    remove is at the floor already."""
    k = V.shape[1]
    rt = real_dtype(V.dtype)
    active = jnp.arange(k) >= locked
    Q = jnp.where(active[None, :], V, jnp.zeros((), V.dtype))
    if is_double_base(V.dtype):
        nrm = jnp.linalg.norm(Q, axis=0).real.astype(rt)
        Q = Q / jnp.where(nrm > 0, nrm,
                          jnp.ones((), rt))[None, :].astype(Q.dtype)
    W = jnp.matmul(H, Q, precision=precision)            # H·Q (one big HEMM)
    A = jnp.matmul(Q.conj().T, W, precision=precision)   # QᴴHQ, k×k
    A, big = _pin_locked(A, active, rt)
    return Q, W, A, big


@partial(jax.jit, static_argnames=("precision", "want_vectors", "wide"))
def _rr_finish(Q, W, V, ritz, Z, locked, *, precision="highest",
               want_vectors=False, wide=False):
    """Device half 2: rotate, residuals, roll, merge.  ``wide`` routes the
    rotations through the exact-slice GEMM (wide_f64='on')."""
    k = V.shape[1]
    rt = real_dtype(V.dtype)
    active = jnp.arange(k) >= locked
    if wide:
        from .wide import wide_matmul
        Vrot = wide_matmul(Q, Z)
        Wrot = wide_matmul(W, Z)
    else:
        Vrot = jnp.matmul(Q, Z, precision=precision)     # Ritz vectors
        Wrot = jnp.matmul(W, Z, precision=precision)     # = H · Vrot
    R = Wrot - Vrot * ritz[None, :].astype(V.dtype)
    resid = jnp.linalg.norm(R, axis=0).real.astype(rt)
    # Active results live at positions [0, k-locked); roll to [locked, k).
    Vrot = jnp.roll(Vrot, locked, axis=1)
    ritz = jnp.roll(ritz, locked)
    resid = jnp.roll(resid, locked)
    V_out = jnp.where(active[None, :], Vrot, V)
    if want_vectors:
        # residual VECTORS feed the deviation-form refinement filter
        # (ops/filter.chebyshev_filter_refine) — rolled like everything else
        return V_out, ritz, resid, jnp.roll(R, locked, axis=1)
    return V_out, ritz, resid


@partial(jax.jit, static_argnames=("precision", "want_vectors", "polish"))
def _rr_device(H, V, locked, *, precision="highest", want_vectors=False,
               polish=2):
    """Fully on-device RR+residuals (single program)."""
    rt = real_dtype(V.dtype)
    Q, W, A, big = _rr_project(H, V, locked, precision=precision)
    ritz, Z = eigh_polished(A, passes=polish, precision=precision,
                            pin_cut=big / 2)
    ritz = ritz.real.astype(rt)
    return _rr_finish(Q, W, V, ritz, Z, locked, precision=precision,
                      want_vectors=want_vectors)


@partial(jax.jit, static_argnames=("precision", "s", "L"))
def _rr_project_wide(a_slices, sa, V, locked, *, s, L, precision="highest"):
    """_rr_project with the N-contraction f64 matmuls on the exact-bf16
    slice path (ops/wide, accuracy ~1e-14).  ``a_slices, sa, s, L`` come from
    ops.wide.presplit (DenseOperator.H_wide); s/L ride as static args."""
    from .wide import slice_f64_i8, slice_f64, _pair_products_i8, \
        _pair_products, wide_matmul
    k = V.shape[1]
    rt = real_dtype(V.dtype)
    active = jnp.arange(k) >= locked
    Q = jnp.where(active[None, :], V, jnp.zeros((), V.dtype))
    nrm = jnp.linalg.norm(Q, axis=0).real.astype(rt)
    Q = Q / jnp.where(nrm > 0, nrm, jnp.ones((), rt))[None, :].astype(Q.dtype)
    if a_slices[0].dtype == jnp.int8:
        # slice Q ONCE: its column slices feed W = H·Q, and their
        # transposes are the left operand of A = QᵀW (no Qᵀ copy, no
        # second slicing pass — lowers peak device memory)
        q_sl, q_sc = slice_f64_i8(Q, s, L, axis=0)
        qst = jnp.stack(q_sl)
        W = _pair_products_i8(a_slices, qst, L - 1, s) * sa * q_sc
        w_sl, w_sc = slice_f64_i8(W, s, L, axis=0)
        A = _pair_products_i8([qst[l].T for l in range(L)],
                              jnp.stack(w_sl), L - 1, s) * q_sc.T * w_sc
    else:
        b_sl, q_sc = slice_f64(Q, s, L, axis=0)
        W = _pair_products(a_slices, b_sl, L - 1) * sa * q_sc
        A = wide_matmul(Q.T, W)
    A, big = _pin_locked(A, active, rt)
    return Q, W, A, big


@partial(jax.jit, static_argnames=("s", "L"))
def _rr_wide_qslice(V, locked, *, s, L):
    """Low-mem wide RR stage 1: mask+renormalize, slice Q once."""
    from .wide import slice_f64_i8
    k = V.shape[1]
    rt = real_dtype(V.dtype)
    active = jnp.arange(k) >= locked
    Q = jnp.where(active[None, :], V, jnp.zeros((), V.dtype))
    nrm = jnp.linalg.norm(Q, axis=0).real.astype(rt)
    Q = Q / jnp.where(nrm > 0, nrm, jnp.ones((), rt))[None, :].astype(Q.dtype)
    q_sl, q_sc = slice_f64_i8(Q, s, L, axis=0)
    return Q, jnp.stack(q_sl), q_sc


@partial(jax.jit, static_argnames=("s", "L"))
def _rr_wide_w(a_slices, sa, qst, q_sc, *, s, L):
    """Low-mem wide RR stage 2: W = H·Q from the slice stacks only."""
    from .wide import _pair_products_i8
    return _pair_products_i8(a_slices, qst, L - 1, s) * sa * q_sc


@partial(jax.jit, static_argnames=("s", "L"))
def _rr_wide_a(qst, q_sc, W, locked, *, s, L):
    """Low-mem wide RR stage 3: A = QᵀW pinned."""
    from .wide import slice_f64_i8, _pair_products_i8
    k = W.shape[1]
    rt = real_dtype(W.dtype)
    active = jnp.arange(k) >= locked
    w_sl, w_sc = slice_f64_i8(W, s, L, axis=0)
    A = _pair_products_i8([qst[l].T for l in range(L)],
                          jnp.stack(w_sl), L - 1, s) * q_sc.T * w_sc
    A, _ = _pin_locked(A, active, rt)
    return A


@partial(jax.jit, donate_argnums=(0,))
def _rr_wide_rot(X, Z):
    """Low-mem wide RR stage 4 (×2): rotate one basis, donating it."""
    from .wide import wide_matmul
    return wide_matmul(X, Z)


@partial(jax.jit, static_argnames=("want_vectors",), donate_argnums=(1,))
def _rr_wide_merge(V, Wrot, Vrot, ritz, locked, *, want_vectors=False):
    """Low-mem wide RR stage 5: residuals + roll + merge (Wrot donated
    into the residual vectors)."""
    k = V.shape[1]
    rt = real_dtype(V.dtype)
    active = jnp.arange(k) >= locked
    R = Wrot - Vrot * ritz[None, :].astype(V.dtype)
    resid = jnp.linalg.norm(R, axis=0).real.astype(rt)
    Vrot = jnp.roll(Vrot, locked, axis=1)
    ritz = jnp.roll(ritz, locked)
    resid = jnp.roll(resid, locked)
    V_out = jnp.where(active[None, :], Vrot, V)
    if want_vectors:
        return V_out, ritz, resid, jnp.roll(R, locked, axis=1)
    return V_out, ritz, resid


def _wide_rr_lowmem(N, k, L):
    """Engage the split/donating wide-RR program chain when the single-
    program path's peak (resident slice stack + ~8 N·k f64 live blocks)
    would crowd the device."""
    from ..device import memory_bytes
    return L * N * N + 6 * 8 * N * k > 0.6 * memory_bytes()


def rayleigh_ritz_residuals(H, V, locked, *, precision="highest",
                            small_dense="device", want_vectors=False,
                            polish=2, H_wide=None):
    """Project H on the active columns of V, solve, rotate, and compute
    residuals, with ``locked`` as a traced scalar.

    Args:
      H: (N, N) Hermitian operator; may be ``None`` when ``H_wide`` is
        given (the wide path multiplies only by the slices — callers avoid
        re-materializing an f64 buffer engage_wide dropped).
      V: (N, k) orthonormal block; columns [0, locked) are converged and are
        excluded from the projection.
      locked: traced int scalar.
      small_dense: "device" — the k×k eigh stays in the XLA program;
        "host" — split-sync host LAPACK eigh in f64 (see module docstring).
      H_wide: optional pre-sliced operator (ops/wide.presplit /
        DenseOperator.H_wide): the big f64 HEMMs run on the exact-bf16
        slice path instead of the native f64 dot (~1e-14 accuracy).
        Implies the split-sync host eigh.

    Returns:
      V_out:  (N, k) — V with columns [locked, k) replaced by the rotated
              Ritz vectors (ascending Ritz value); [0, locked) untouched.
      ritzv:  (k,) real — positions [locked, k) hold the active Ritz values
              ascending; [0, locked) are garbage (caller keeps its own).
      resid:  (k,) real — same layout; ‖H v_j − θ_j v_j‖₂ per active column.
      R:      (N, k) residual VECTORS, same layout — only with
              ``want_vectors=True`` (feeds the refinement filter).
    """
    if H_wide is not None:
        rt = real_dtype(V.dtype)
        a_slices, sa, s, L = H_wide
        if a_slices[0].dtype == jnp.int8 and \
                _wide_rr_lowmem(V.shape[0], V.shape[1], L):
            # split/donating program chain: intermediates die at program
            # boundaries, the rotations reuse Q/W's buffers — the fused
            # single program's peak would not fit the device
            Q, qst, q_sc = _rr_wide_qslice(V, locked, s=s, L=L)
            W = _rr_wide_w(a_slices, sa, qst, q_sc, s=s, L=L)
            A = _rr_wide_a(qst, q_sc, W, locked, s=s, L=L)
            del qst
            w, Z = host_eigh_f64(np.asarray(A), rt)      # k×k device→host
            Zd = jnp.asarray(Z)
            Vrot = _rr_wide_rot(Q, Zd)
            Wrot = _rr_wide_rot(W, Zd)
            return _rr_wide_merge(V, Wrot, Vrot, jnp.asarray(w), locked,
                                  want_vectors=want_vectors)
        Q, W, A, _ = _rr_project_wide(a_slices, sa, V, locked, s=s, L=L,
                                      precision=precision)
        w, Z = host_eigh_f64(np.asarray(A), rt)          # k×k device→host
        return _rr_finish(Q, W, V, jnp.asarray(w), jnp.asarray(Z), locked,
                          precision=precision, want_vectors=want_vectors,
                          wide=True)

    if small_dense != "host":
        return _rr_device(H, V, locked, precision=precision,
                          want_vectors=want_vectors, polish=polish)

    rt = real_dtype(V.dtype)
    Q, W, A, _ = _rr_project(H, V, locked, precision=precision)
    w, Z = host_eigh_f64(np.asarray(A), rt)              # k×k device→host
    return _rr_finish(Q, W, V, jnp.asarray(w), jnp.asarray(Z), locked,
                      precision=precision, want_vectors=want_vectors)
