"""Partial pivoted Cholesky preconditioner for BBMM CG and SLQ.

GPyTorch preconditions ``K + sigma^2 I`` with a rank-k pivoted Cholesky of K
(``max_preconditioner_size=100`` in the reference config
configs/simplexgp.yml; SURVEY.md section 2.4), and corrects the SLQ
log-determinant with the preconditioner's own log-det.

Pivoted Cholesky needs *columns* of K.  GPyTorch evaluates kernel rows
exactly (LazyTensor row indexing); this implementation does the same: a
column of the (scaled) stationary kernel is ``s * k(||x_i - X||^2)`` -- one
O(n d) dense row -- NOT a full O(M) lattice filter MVM.  The lattice
operator approximates this exact kernel, so the exact kernel's pivoted
Cholesky preconditions it equally well, at a small fraction of the build
cost of one-hot filter MVMs.

The factorization loop is a ``lax.fori_loop`` with static rank
(data-dependent pivots are traced values; shapes stay static).  With
``axis_name`` (inside shard_map over the data axis) the rows of ``ref`` are
sharded: pivot selection all-gathers one (value, x-row, L-row) candidate per
shard -- O(shards * (d + rank)) bytes per step -- and every shard
keeps only its local rows of L.  New capability vs the single-device
reference (SURVEY.md section 2.7).

The preconditioner object diagonalizes L L^T once (a k x k eigh of L^T L),
giving O(n k) applies of P^{-1} (Woodbury), P^{-1/2} / P^{+1/2} (symmetric
preconditioning for SLQ), and an O(k) exact log-determinant (matrix
determinant lemma).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = [
    "PivotedCholesky",
    "pivoted_cholesky",
    "pivoted_cholesky_features",
    "Preconditioner",
    "make_preconditioner",
    "precond_solve",
    "precond_inv_sqrt",
    "woodbury_solve",
    "woodbury_logdet",
]


def _mm(a, b):
    """Full-f32 matrix product.  The Gram eigenbasis and the Woodbury applies
    are accurate to f32 only if their products are: a TF32 product (10
    mantissa bits) would break the SPD guard's orthonormality bound."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class PivotedCholesky(NamedTuple):
    L: jax.Array  # (n_local, k) partial Cholesky factor of K (without noise)
    pivots: jax.Array  # (k,) chosen pivot indices (local index on the owning shard)


def pivoted_cholesky(
    diag: jax.Array,
    col_fn: Callable[[jax.Array], jax.Array],
    rank: int,
) -> PivotedCholesky:
    """Rank-``rank`` pivoted Cholesky of an SPSD matrix given by columns.

    Generic column-oracle form (kept as the oracle for tests and for
    operators without feature structure).

    Args:
      diag: (n,) the diagonal of K (ones * outputscale for normalized lattice
        kernels, reference bilateral_kernel.py:139-140).
      col_fn: i (traced scalar) -> K[:, i] as an (n,) array.
      rank: number of pivots (static).
    """
    n = diag.shape[0]

    def body(j, state):
        L, d, pivots = state
        piv = jnp.argmax(d)
        col = col_fn(piv)  # (n,)
        # Subtract the already-factored part: L[:, :j] @ L[piv, :j].
        jj = jnp.arange(L.shape[1])
        mask = (jj < j).astype(L.dtype)
        col = col - (L * (L[piv] * mask)[None, :]).sum(axis=-1)
        # Exhausted pivots get a ZERO column.  The threshold is RELATIVE to
        # the initial diagonal: residual diagonals below ~f32-eps * diag0 are
        # pure subtractive-cancellation noise, and dividing a junk column by
        # sqrt(tiny) poisons L -- at long lengthscales (numerically low-rank
        # K) this made the Woodbury P^{-1} round r^T P^{-1} r negative and
        # broke every preconditioned CG column at n=65k (r5 precipitation
        # frozen-hyperparameter bug).
        alive = d[piv] > 1e-6 * d0_max
        pivot_val = jnp.maximum(d[piv], 1e-12)
        ell = jnp.where(alive, col / jnp.sqrt(pivot_val), 0.0)
        ell = ell.at[piv].set(jnp.where(alive, jnp.sqrt(pivot_val), 0.0))
        L = L.at[:, j].set(ell)
        d = jnp.maximum(d - ell * ell, 0.0)
        d = d.at[piv].set(0.0)
        pivots = pivots.at[j].set(piv)
        return L, d, pivots

    L0 = jnp.zeros((n, rank), jnp.float32)
    piv0 = jnp.zeros((rank,), jnp.int32)
    d0_max = jnp.max(diag.astype(jnp.float32))
    L, _, pivots = jax.lax.fori_loop(0, rank, body, (L0, diag.astype(jnp.float32), piv0))
    return PivotedCholesky(L=L, pivots=pivots)


def pivoted_cholesky_features(
    ref: jax.Array,
    diag: jax.Array,
    kfun: Callable[[jax.Array], jax.Array],
    rank: int,
    axis_name: Optional[str] = None,
) -> PivotedCholesky:
    """Pivoted Cholesky of the stationary kernel matrix ``kfun(d2(ref, ref))``.

    Args:
      ref: (n_local, d) feature rows (inputs already divided by lengthscales).
      diag: (n_local,) kernel diagonal (= kfun(0), e.g. outputscale).
      kfun: squared-distance -> (scaled) kernel value, elementwise jnp fn.
      rank: number of pivots (static; callers should clamp to global n).
      axis_name: if set (inside shard_map), rows are sharded over that mesh
        axis; pivot selection runs a global argmax via all_gather of one
        candidate per shard.
    """
    n = ref.shape[0]

    def body(j, state):
        L, d, pivots = state
        local_arg = jnp.argmax(d)
        if axis_name is None:
            x_piv = ref[local_arg]
            l_piv = L[local_arg]
            pivot_val = d[local_arg]
            is_winner = jnp.bool_(True)
        else:
            cand_val = jax.lax.all_gather(d[local_arg], axis_name)  # (S,)
            cand_x = jax.lax.all_gather(ref[local_arg], axis_name)  # (S, dim)
            cand_l = jax.lax.all_gather(L[local_arg], axis_name)  # (S, rank)
            w = jnp.argmax(cand_val)
            x_piv, l_piv, pivot_val = cand_x[w], cand_l[w], cand_val[w]
            is_winner = w == jax.lax.axis_index(axis_name)

        # Exact kernel column at the pivot, local rows: O(n_local * dim).
        col = kfun(((ref - x_piv[None, :]) ** 2).sum(axis=-1))
        jj = jnp.arange(L.shape[1])
        mask = (jj < j).astype(L.dtype)
        col = col - (L * (l_piv * mask)[None, :]).sum(axis=-1)
        # Exhausted pivots get a ZERO column.  RELATIVE threshold: residual
        # diagonals below ~f32-eps * diag0 are subtractive-cancellation junk
        # (see pivoted_cholesky above; the r5 precipitation preconditioner
        # breakdown), not signal -- at long lengthscales the exact kernel is
        # numerically low-rank and rank 100 overshoots its effective rank.
        alive = pivot_val > 1e-6 * d0_max
        pivot_val = jnp.maximum(pivot_val, 1e-12)
        ell = jnp.where(alive, col / jnp.sqrt(pivot_val), 0.0)
        # The pivot's own entry is exactly sqrt(pivot_val) (only on its shard).
        ell = ell.at[local_arg].set(
            jnp.where(is_winner & alive, jnp.sqrt(pivot_val), ell[local_arg])
        )
        L = L.at[:, j].set(ell)
        d = jnp.maximum(d - ell * ell, 0.0)
        d = d.at[local_arg].set(jnp.where(is_winner, 0.0, d[local_arg]))
        pivots = pivots.at[j].set(local_arg)
        return L, d, pivots

    L0 = jnp.zeros((n, rank), jnp.float32)
    piv0 = jnp.zeros((rank,), jnp.int32)
    d0_max = jnp.max(diag.astype(jnp.float32))
    if axis_name is not None:
        d0_max = jax.lax.pmax(d0_max, axis_name)
    L, _, pivots = jax.lax.fori_loop(
        0, rank, body, (L0, diag.astype(jnp.float32), piv0)
    )
    return PivotedCholesky(L=L, pivots=pivots)


class Preconditioner(NamedTuple):
    """P = U diag(s2) U^T + noise I with U^T U ~= I (globally, when sharded).

    Built once per loss evaluation from the pivoted-Cholesky factor; applies
    of P^{-1} and P^{+-1/2} are O(n k), and ``logdet`` is exact (matrix
    determinant lemma) -- this is the log|P| term GPyTorch adds to the SLQ
    log-det of the preconditioned operator.

    ``gamma`` is the measured orthonormality defect lambda_max(U^T U): the
    f32 eigenbasis of an ill-conditioned Gram (kappa ~ s2_max/s2_min ~ 1e4+
    at long lengthscales) leaves U^T U off identity by ~1e-2, and the apply
    I/noise - U w U^T is then INDEFINITE (its smallest eigenvalue is
    1/noise - w_max * gamma < 0 for gamma > 1) -- which made rz = r^T P^{-1} r
    go hugely negative and broke every preconditioned CG column at the r5
    precipitation geometry.  Every apply divides its U-term coefficient by
    ``gamma``, restoring SPD BY CONSTRUCTION at the cost of a ~(gamma-1)
    relative perturbation of the intended preconditioner.
    """

    U: jax.Array  # (n_local, k) near-orthonormal columns
    s2: jax.Array  # (k,) eigenvalues of L L^T
    noise: jax.Array  # ()
    logdet: jax.Array  # () log|P| at global n
    gamma: jax.Array  # () lambda_max(U^T U) >= 1 SPD guard


def make_preconditioner(
    L: jax.Array,
    noise: jax.Array,
    n_global: int,
    axis_name: Optional[str] = None,
) -> Preconditioner:
    """Diagonalize L L^T + noise I from its (possibly row-sharded) factor.

    One k x k eigh of the Gram matrix L^T L (a psum when sharded); columns of
    U with negligible spectrum get weight ~0 in every apply, so a
    rank-deficient L is harmless.  A Newton-Schulz polish halves the f32
    orthonormality defect's exponent (~1e-2 -> ~1e-4), and the residual
    defect is measured into ``gamma`` (see Preconditioner).
    """

    def gram(M):
        G = _mm(M.T, M)
        return jax.lax.psum(G, axis_name) if axis_name is not None else G

    s2, V = jnp.linalg.eigh(gram(L))
    s2 = jnp.maximum(s2, 0.0)
    denom = jnp.sqrt(jnp.maximum(s2, 1e-12))
    U = _mm(L, V / denom[None, :])  # (n_local, k), ||U_i|| <= 1
    # One Newton-Schulz orthonormalization pass: U <- U (3I - U^T U) / 2.
    G2 = gram(U)
    k = G2.shape[0]
    U = _mm(U, 1.5 * jnp.eye(k, dtype=U.dtype) - 0.5 * G2)
    # Residual defect bound for the SPD guard (k x k eigh, cheap).
    gamma = jnp.maximum(jnp.linalg.eigvalsh(gram(U))[-1], 1.0)
    logdet = jnp.log1p(s2 / noise).sum() + n_global * jnp.log(noise)
    return Preconditioner(U=U, s2=s2, noise=noise, logdet=logdet, gamma=gamma)


def _ut_v(P: Preconditioner, V: jax.Array, axis_name: Optional[str]) -> jax.Array:
    utv = _mm(P.U.T, V)  # (k, t)
    if axis_name is not None:
        utv = jax.lax.psum(utv, axis_name)
    return utv


def precond_solve(
    P: Preconditioner, V: jax.Array, axis_name: Optional[str] = None
) -> jax.Array:
    """P^{-1} V via Woodbury in the eigenbasis: O(n k t).

    The subtractive U-term is divided by ``gamma`` so the applied operator's
    smallest eigenvalue is >= 1/noise - (w_max/gamma) * lambda_max(U^T U)
    >= noise^{-1} * (1 - s2_max/(noise+s2_max)) > 0: SPD regardless of the
    f32 orthonormality defect (see Preconditioner.gamma).
    """
    w = P.s2 / (P.noise * (P.noise + P.s2)) / P.gamma
    return V / P.noise - _mm(P.U, w[:, None] * _ut_v(P, V, axis_name))


def precond_inv_sqrt(
    P: Preconditioner, V: jax.Array, axis_name: Optional[str] = None
) -> jax.Array:
    """P^{-1/2} V (symmetric preconditioning for SLQ): O(n k t).

    P^{-1/2} = noise^{-1/2} I + U ((noise+s2)^{-1/2} - noise^{-1/2}) U^T.
    The (negative) U-term is divided by ``gamma`` for the same SPD guard as
    ``precond_solve``.
    """
    w = (jax.lax.rsqrt(P.noise + P.s2) - jax.lax.rsqrt(P.noise)) / P.gamma
    return V * jax.lax.rsqrt(P.noise) + _mm(P.U, w[:, None] * _ut_v(P, V, axis_name))


def precond_sqrt(
    P: Preconditioner, V: jax.Array, axis_name: Optional[str] = None
) -> jax.Array:
    """P^{1/2} V: O(n k t).

    P^{1/2} = noise^{1/2} I + U (sqrt(noise+s2) - sqrt(noise)) U^T.  Used to
    draw SLQ probe right-hand sides b = P^{1/2} z from isotropic z, so the
    CG-tridiag quadrature (cg_solve's ``tridiag_m``) estimates
    log|P^{-1/2} K_hat P^{-1/2}| with an exactly-known starting-vector
    weight ||P^{-1/2} b||^2 = ||z||^2 (GPyTorch draws its probes from the
    preconditioner distribution for the same reason,
    added_diag_lazy_tensor._probe_vectors).
    """
    # gamma-scaled like precond_inv_sqrt so P^{1/2} stays (approximately) its
    # inverse -- the quadrature weight identity P^{-1/2}(P^{1/2} z) = z is
    # what makes ||z||^2 the right starting-vector weight.
    w = (jnp.sqrt(P.noise + P.s2) - jnp.sqrt(P.noise)) / P.gamma
    return V * jnp.sqrt(P.noise) + _mm(P.U, w[:, None] * _ut_v(P, V, axis_name))


def woodbury_solve(L: jax.Array, noise: jax.Array, V: jax.Array) -> jax.Array:
    """(L L^T + noise I)^{-1} V via Woodbury, O(n k^2 + n k t)."""
    k = L.shape[1]
    inner = noise * jnp.eye(k, dtype=L.dtype) + _mm(L.T, L)  # (k, k)
    chol = jnp.linalg.cholesky(inner)
    lt_v = _mm(L.T, V)
    sol = jax.scipy.linalg.cho_solve((chol, True), lt_v)
    return (V - _mm(L, sol)) / noise


def woodbury_logdet(L: jax.Array, noise: jax.Array, n: int) -> jax.Array:
    """log|L L^T + noise I| via the matrix determinant lemma."""
    k = L.shape[1]
    inner = jnp.eye(k, dtype=L.dtype) + _mm(L.T, L) / noise
    chol = jnp.linalg.cholesky(inner)
    return 2.0 * jnp.log(jnp.diag(chol)).sum() + n * jnp.log(noise)
