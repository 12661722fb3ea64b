"""Batched Lanczos tridiagonalization and stochastic Lanczos quadrature.

The reference obtains log|K| and trace terms through GPyTorch's stochastic
Lanczos quadrature (SLQ) with a Lanczos budget of
``max_root_decomposition_size`` (=100 in configs/simplexgp.yml; SURVEY.md
section 2.4).  Formulation: all probe vectors run their Lanczos
recurrences simultaneously as one (n, p) block -- every operator application
is a single fused filter MVM -- inside a ``lax.scan`` of static length; the
tiny (p, m, m) tridiagonal eigenproblems are solved with batched ``eigh``.

Full reorthogonalization is applied by default (an (n, p, m) tensor
contraction); for the small m used here it costs little and removes the classic
Lanczos ghost-eigenvalue instability in f32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["LanczosResult", "lanczos", "slq_logdet", "lanczos_root"]

_HI = jax.lax.Precision.HIGHEST


class LanczosResult(NamedTuple):
    alphas: jax.Array  # (p, m) tridiagonal diagonal
    betas: jax.Array  # (p, m-1) off-diagonal
    vecs: jax.Array  # (m, n, p) Lanczos basis (per probe)


def lanczos(
    matmul: Callable[[jax.Array], jax.Array],
    z: jax.Array,
    num_iters: int,
    reorthogonalize: bool = True,
    axis_name: Optional[str] = None,
) -> LanczosResult:
    """Run ``num_iters`` Lanczos steps for every column of z (n, p) at once.

    With ``axis_name`` (inside shard_map) the rows of z are sharded over that
    mesh axis: every reduction over n becomes a psum, and ``matmul`` must be
    the data-sharded operator.  The recurrence scalars are then identical on
    all shards, keeping the basis globally consistent.
    """
    n, p = z.shape
    m = num_iters
    z = z.astype(jnp.float32)

    def rowsum(v):  # reduce over the (possibly sharded) data axis
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    q0 = z / jnp.sqrt(rowsum((z * z).sum(axis=0, keepdims=True)))

    def step(carry, i):
        q_prev, q, beta_prev, alive, basis = carry
        aq = matmul(q)
        alpha = rowsum((q * aq).sum(axis=0))  # (p,)
        r = aq - alpha * q - beta_prev * q_prev
        if reorthogonalize:
            # r <- r - V (V^T r), applied twice (CGS2, "twice is enough"):
            # one-shot classical Gram-Schmidt amplifies r once the basis
            # loses orthogonality near Krylov exhaustion and the recurrence
            # explodes; the second pass makes it stable.  Each pass is one
            # (m, p) contraction batched over probes, in full f32: a TF32
            # contraction would leave the basis far from orthogonal.
            for _ in range(2):
                coeff = rowsum(jnp.einsum("mnp,np->mp", basis, r, precision=_HI))
                r = r - jnp.einsum("mnp,mp->np", basis, coeff, precision=_HI)
        beta = jnp.sqrt(rowsum((r * r).sum(axis=0)))
        # Breakdown: once the Krylov space of a column is exhausted, beta sits
        # at the f32 orthogonalization noise floor; normalizing r by it feeds
        # non-orthogonal noise into the basis and the recurrence explodes
        # multiplicatively.  Freeze such columns: record alpha=1/beta=0 so the
        # trailing T block is a disconnected identity whose e1-weight in SLQ
        # is exactly zero.  Threshold 1e-3*||Aq|| ~ sqrt(eps_f32) relative to
        # the operator scale.
        aq_norm = jnp.sqrt(rowsum((aq * aq).sum(axis=0)))
        alive_next = alive & (beta > 1e-3 * jnp.maximum(aq_norm, 1e-30))
        alpha_rec = jnp.where(alive, alpha, 1.0)
        beta_rec = jnp.where(alive_next, beta, 0.0)
        q_next = jnp.where(alive_next, r / jnp.where(beta == 0, 1.0, beta), 0.0)
        basis = basis.at[i].set(jnp.where(alive, q, 0.0))
        return (q, q_next, beta_rec, alive_next, basis), (alpha_rec, beta_rec)

    basis0 = jnp.zeros((m, n, p), jnp.float32)
    carry0 = (
        jnp.zeros_like(q0),
        q0,
        jnp.zeros((p,), jnp.float32),
        jnp.ones((p,), bool),
        basis0,
    )
    (_, _, _, _, basis), (alphas, betas) = jax.lax.scan(step, carry0, jnp.arange(m))
    return LanczosResult(
        alphas=alphas.T,  # (p, m)
        betas=betas.T[:, : m - 1],
        vecs=basis,
    )


def tridiag_matrices(alphas: jax.Array, betas: jax.Array) -> jax.Array:
    """Assemble (p, m, m) tridiagonal matrices from Lanczos coefficients."""
    p, m = alphas.shape
    T = jnp.zeros((p, m, m), jnp.float32)
    ii = jnp.arange(m)
    T = T.at[:, ii, ii].set(alphas)
    jj = jnp.arange(m - 1)
    T = T.at[:, jj, jj + 1].set(betas)
    T = T.at[:, jj + 1, jj].set(betas)
    return T


def slq_logdet(
    matmul: Callable[[jax.Array], jax.Array],
    z: jax.Array,
    num_iters: int = 100,
    axis_name: Optional[str] = None,
) -> jax.Array:
    """Stochastic Lanczos quadrature estimate of log|A| from probes z (n, p).

    logdet ~= (1/p) sum_i ||z_i||^2 * e1^T U_i log(L_i) U_i^T e1, the standard
    SLQ estimator (Ubaru, Chen & Saad 2017), matching GPyTorch's use for the
    NLML's log-determinant term.
    """
    n, p = z.shape
    res = lanczos(matmul, z, num_iters, axis_name=axis_name)
    T = tridiag_matrices(res.alphas, res.betas)
    evals, evecs = jnp.linalg.eigh(T)
    # Clamp: A is SPD but f32 Lanczos can produce tiny negative ritz values.
    evals = jnp.maximum(evals, 1e-10)
    w = evecs[:, 0, :] ** 2  # (p, m) first-row weights
    quad = (w * jnp.log(evals)).sum(axis=-1)  # (p,)
    z_norm2 = (z * z).sum(axis=0)
    if axis_name is not None:
        z_norm2 = jax.lax.psum(z_norm2, axis_name)
    return (z_norm2 * quad).mean()


def logdet_from_cg_tridiag(
    alphas: jax.Array,
    betas: jax.Array,
    tmask: jax.Array,
    z_norm2: jax.Array,
) -> jax.Array:
    """SLQ log-det estimate from CG's recorded tridiag coefficients.

    Args:
      alphas, betas, tmask: (m, p) records from ``cg_solve(...,
        tridiag_m=m)`` for the PROBE columns (drop the y column first).
        The Lanczos tridiagonal of the operator CG ran on (the symmetrically
        preconditioned operator, when preconditioned) is
        T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1}, T[k,k+1] =
        sqrt(beta_k)/alpha_k; dead steps (tmask False) truncate T into a
        decoupled identity pad whose quadrature weight is zero.
      z_norm2: (p,) squared norms of the isotropic starting vectors z (for
        Rademacher probes, exactly n).  When preconditioned, the CG
        right-hand sides are P^{1/2} z, so the implicit starting vectors of
        the preconditioned system are z themselves.

    Returns the scalar estimate of log|A-hat|; add log|P| for log|K_hat|.
    This is GPyTorch's inv_quad_logdet quadrature
    (lazy_tensor._solve + linear_cg n_tridiag path) -- memory O(m p), no
    Lanczos basis, no second operator pass.
    """
    m, p = alphas.shape
    live = tmask
    live_next = jnp.concatenate([tmask[1:], jnp.zeros((1, p), bool)], axis=0)
    safe_a = jnp.where(live, alphas, 1.0)
    inv_a = 1.0 / safe_a
    b_over_a = jnp.where(live, betas, 0.0) * inv_a
    prev_ba = jnp.concatenate([jnp.zeros((1, p), jnp.float32), b_over_a[:-1]], axis=0)
    diag = jnp.where(live, inv_a + prev_ba, 1.0)  # (m, p)
    off = jnp.where(
        live & live_next, jnp.sqrt(jnp.maximum(betas, 0.0)) * inv_a, 0.0
    )[:-1]  # (m-1, p)
    T = tridiag_matrices(diag.T, off.T)  # (p, m, m)
    evals, evecs = jnp.linalg.eigh(T)
    evals = jnp.maximum(evals, 1e-10)
    w = evecs[:, 0, :] ** 2
    quad = (w * jnp.log(evals)).sum(axis=-1)  # (p,)
    return (z_norm2 * quad).mean()


def lanczos_root(
    matmul: Callable[[jax.Array], jax.Array],
    z: jax.Array,
    num_iters: int,
):
    """Rank-m approximations A ~= Q T Q^T from a single probe z (n, 1).

    Returns (Q (n, m), T (m, m)).  Used for LOVE-style fast predictive
    variances (reference `fast_pred_var`, train_simplexgp.py:67): with
    A = K_hat, K_hat^{-1} ~= Q T^{-1} Q^T.
    """
    res = lanczos(matmul, z, num_iters)
    Q = res.vecs[:, :, 0].T  # (n, m)
    T = tridiag_matrices(res.alphas[:1], res.betas[:1])[0]
    return Q, T
