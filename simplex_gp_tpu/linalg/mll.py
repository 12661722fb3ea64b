"""Marginal-likelihood engine: inv_quad + logdet with stochastic gradients.

This is the JAX equivalent of GPyTorch's ``inv_quad_logdet`` -- the
single function behind ``-mll(model(x), y)`` in the reference training loop
(train_simplexgp.py:41; SURVEY.md section 3.1).  For K_hat = s*K + noise*I:

  forward:  inv_quad = y^T K_hat^{-1} y   via preconditioned batched CG
            logdet   = log|K_hat|         via stochastic Lanczos quadrature
  backward: d(inv_quad) = -alpha^T dK_hat alpha          (alpha = K_hat^{-1}y)
            d(logdet)  ~= (1/p) sum_i (K_hat^{-1}z_i)^T dK_hat z_i (Hutchinson)

Both backward terms are u^T dK_hat v forms, evaluated in ONE ``jax.vjp``
through the differentiable lattice filter (ops/filter.py), which is how
lengthscale/ARD/outputscale/noise gradients flow -- mirroring how GPyTorch's
backward replays ``LatticeFilterGeneral.backward`` per CG-era term.

Key structural win over the reference: the CG/Lanczos forward applies
``apply_plan`` against ONE prebuilt lattice plan, while the reference rebuilds
its hash table on every single ``_matmul`` of every CG iteration.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.filter import (
    apply_plan_any,
    build_plan_any,
    lattice_filter,
    lattice_filter_any,
)
from ..ops.kernels import DiscretizedKernel, MixtureKernel, kernel_value_jnp
from .cg import cg_solve
from .lanczos import logdet_from_cg_tridiag, slq_logdet
from .pivoted_cholesky import (
    make_preconditioner,
    pivoted_cholesky_features,
    precond_inv_sqrt,
    precond_solve,
    precond_sqrt,
)

__all__ = ["BBMMConfig", "lattice_inv_quad_logdet", "lattice_nlml"]


@dataclasses.dataclass(frozen=True)
class BBMMConfig:
    """Solver budget, mirroring the reference's gpytorch settings context
    (train_simplexgp.py:34-37): cg_tolerance, max_cg_iterations,
    max_preconditioner_size, max_root_decomposition_size."""

    cg_tolerance: float = 1.0
    max_cg_iterations: int = 500
    max_lanczos_iterations: int = 100
    # Pivoted-Cholesky preconditioner rank; 0 disables.  Default matches the
    # reference's canonical paper config (max_preconditioner_size=100,
    # configs/simplexgp.yml / train_simplexgp.py:36); clamped to n at use.
    precond_rank: int = 100
    num_probes: int = 10
    # Static chain-table capacity for the training-operator plan (see
    # ops/lattice.py build_plan_chain).  Opt-in for very large n: measure
    # occupancy once (count_lattice_points) and leave headroom for
    # lengthscale drift.  An overflow (occupancy > capacity, e.g. after the
    # lengthscales shrink) poisons the filter output -- and thus the loss --
    # with NaN instead of silently corrupting it (apply_plan_chain guard).
    plan_capacity: Optional[int] = None
    # Mesh axis for data-sharded training (set inside shard_map over the data
    # axis; see parallel/shard_filter.py).  x/y/probes then hold this shard's
    # rows; all reductions psum over the axis.  New capability vs the
    # single-device reference (SURVEY.md section 2.7).
    axis_name: Optional[str] = None
    # "exact": autodiff through the real splat/blur/slice pipeline (gradient
    # of the operator actually applied; see ops/filter.py).  "deriv_filter":
    # reference-parity derivative-coefficient filter (bilateral_kernel.py
    # :112-123).
    grad_mode: str = "exact"
    # Log-det estimator.  "cg" (default, GPyTorch-parity): recover the SLQ
    # tridiagonals from the SAME preconditioned-CG pass that produces the
    # solves (linear_cg's n_tridiag path) -- no Lanczos basis is ever
    # materialized (the explicit (m, n, p) basis is ~8 GB at houseelectric
    # scale and doubles the MVM count).  "lanczos": the explicit
    # reorthogonalized-Lanczos path (linalg/lanczos.py), kept for
    # cross-checks and for callers that need the basis.
    slq_mode: str = "cg"


def _khat_matmul_diff(params, x, dk, V, grad_mode: str, axis_name=None, capacity=None):
    """Differentiable K_hat(params) @ V; gradient path per ``grad_mode``."""
    ref = x * params["inv_ell"]
    if axis_name is not None:
        # Sharded path: exact autodiff through the collective filter (the
        # derivative-coefficient approximation is single-device only).
        from ..parallel.shard_filter import filter_sharded

        if isinstance(dk, MixtureKernel):
            ky = sum(
                w * filter_sharded(V, ref * a, dk.base, axis_name)
                for w, a in zip(dk.weights, dk.alphas)
            )
        else:
            ky = filter_sharded(V, ref, dk, axis_name)
    elif grad_mode == "exact" or isinstance(dk, MixtureKernel):
        # Mixtures always use exact autodiff (there is no derivative-tap
        # analog: each component's gradient flows through its own filter).
        ky = lattice_filter_any(V, ref, dk, capacity=capacity)
    else:
        ky = lattice_filter(V, ref, dk)
    return params["outputscale"] * ky + params["noise"] * V


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def lattice_inv_quad_logdet(dk, config, params, x, y, probes):
    """(y^T K_hat^{-1} y, log|K_hat|) for the lattice GP operator.

    Args:
      dk: static DiscretizedKernel.
      config: static BBMMConfig.
      params: dict with positive-valued entries
        ``inv_ell`` (d,), ``outputscale`` (), ``noise`` ().
      x: (n, d) training inputs (no gradient).
      y: (n,) centered targets (gradient defined: 2*alpha).
      probes: (n, p) Rademacher probes (no gradient), shared by the SLQ
        forward and the Hutchinson trace backward, as in GPyTorch.
    """
    out, _ = _iql_fwd(dk, config, params, x, y, probes)
    return out


def build_precond(dk, config, params, ref, n_global: int):
    """Rank-k pivoted-Cholesky preconditioner of K_hat from EXACT kernel rows.

    GPyTorch builds its preconditioner from exact kernel entries (LazyTensor
    row evaluation); ours likewise uses dense O(n d) kernel rows -- NOT
    O(M) one-hot filter MVMs -- so rank 100 costs ~100 cheap dense rows per
    loss eval.  Works data-sharded (rows of ``ref`` sharded over
    ``config.axis_name``).  Returns None when disabled or rank >= n (dense
    regime: CG converges without help and L would be singular).
    """
    rank = min(config.precond_rank, n_global - 1)
    if rank <= 0:
        return None
    s, noise = params["outputscale"], params["noise"]
    kfun = lambda d2: s * kernel_value_jnp(dk, d2)
    pc = pivoted_cholesky_features(
        ref,
        s * jnp.ones((ref.shape[0],), jnp.float32),
        kfun,
        rank,
        axis_name=config.axis_name,
    )
    return make_preconditioner(pc.L, noise, n_global, axis_name=config.axis_name)


def _solve_system(dk, config, params, x, y, probes):
    ref = x * params["inv_ell"]
    if config.axis_name is not None:
        from ..parallel.shard_filter import build_plan_sharded

        if isinstance(dk, MixtureKernel):
            plan = tuple(
                build_plan_sharded(ref * a, dk.base.coeffs, dk.base.variance, config.axis_name)
                for a in dk.alphas
            )
        else:
            plan = build_plan_sharded(ref, dk.coeffs, dk.variance, config.axis_name)
    else:
        plan = build_plan_any(ref, dk, capacity=config.plan_capacity)
    s, noise = params["outputscale"], params["noise"]

    def mv(V):
        return s * apply_plan_any(plan, V, dk, axis_name=config.axis_name) + noise * V

    n_global = x.shape[0]
    if config.axis_name is not None:
        n_global = n_global * jax.lax.axis_size(config.axis_name)
    P = build_precond(dk, config, params, ref, n_global)
    precond = None
    if P is not None:
        precond = lambda V: precond_solve(P, V, config.axis_name)

    m = min(config.max_lanczos_iterations, n_global)
    if config.slq_mode == "cg":
        # GPyTorch-parity single-pass engine: probe right-hand sides are
        # drawn from the preconditioner distribution (b = P^{1/2} z, so the
        # implicit starting vectors of the preconditioned system are the
        # isotropic z), ONE preconditioned CG over [y | b] produces all
        # solves AND the SLQ tridiagonals, and
        # log|K_hat| = log|P| + quadrature.
        b_probes = probes if P is None else precond_sqrt(P, probes, config.axis_name)
        rhs = jnp.concatenate([y[:, None], b_probes], axis=-1)
        res = cg_solve(
            mv,
            rhs,
            tol=config.cg_tolerance,
            max_iters=config.max_cg_iterations,
            precond=precond,
            axis_name=config.axis_name,
            tridiag_m=min(m, config.max_cg_iterations),
        )
        z_norm2 = (probes * probes).sum(axis=0)
        if config.axis_name is not None:
            z_norm2 = jax.lax.psum(z_norm2, config.axis_name)
        logdet = logdet_from_cg_tridiag(
            res.alphas[:, 1:], res.betas[:, 1:], res.tmask[:, 1:], z_norm2
        )
        if P is not None:
            logdet = logdet + P.logdet
        # Right vectors for the Hutchinson trace backward: E[(P^{-1}b) b^T]
        # = I makes (K_hat^{-1}b)^T dK_hat (P^{-1}b) unbiased for
        # tr(K_hat^{-1} dK_hat).
        probes_right = probes if P is None else precond_solve(P, b_probes, config.axis_name)
        return res.x, logdet, probes_right

    rhs = jnp.concatenate([y[:, None], probes], axis=-1)
    res = cg_solve(
        mv,
        rhs,
        tol=config.cg_tolerance,
        max_iters=config.max_cg_iterations,
        precond=precond,
        axis_name=config.axis_name,
    )
    if P is None:
        logdet = slq_logdet(mv, probes, m, axis_name=config.axis_name)
    else:
        # Preconditioned SLQ (GPyTorch-parity): log|K_hat| = log|P| +
        # log|P^{-1/2} K_hat P^{-1/2}|.  The preconditioned operator's
        # spectrum is clustered near 1, so the Lanczos quadrature converges
        # in far fewer iterations for the same budget.
        def mv_pre(V):
            half = precond_inv_sqrt(P, V, config.axis_name)
            return precond_inv_sqrt(P, mv(half), config.axis_name)

        logdet = P.logdet + slq_logdet(mv_pre, probes, m, axis_name=config.axis_name)
    return res.x, logdet, probes


def _iql_fwd(dk, config, params, x, y, probes):
    solves, logdet, probes_right = _solve_system(dk, config, params, x, y, probes)
    alpha = solves[:, 0]
    inv_quad = (y * alpha).sum()
    if config.axis_name is not None:
        inv_quad = jax.lax.psum(inv_quad, config.axis_name)
    residuals = (params, x, y, probes_right, alpha, solves[:, 1:])
    return (inv_quad, logdet), residuals


def _iql_bwd(dk, config, residuals, cotangents):
    a, b = cotangents
    params, x, y, probes, alpha, z_solves = residuals
    p = probes.shape[-1]

    # Left/right vectors of the u^T dK_hat v forms.
    U = jnp.concatenate([(-a) * alpha[:, None], (b / p) * z_solves], axis=-1)
    V = jnp.concatenate([alpha[:, None], probes], axis=-1)

    _, vjp = jax.vjp(
        lambda prm: _khat_matmul_diff(prm, x, dk, V, config.grad_mode, config.axis_name),
        params,
    )
    (grad_params,) = vjp(U)
    # NOTE (sharded): grad_params here is this shard's partial contribution;
    # the data-parallel wrapper psums parameter gradients once at the end
    # (parallel/mesh.py), which also covers the mean-parameter path.

    grad_y = 2.0 * a * alpha
    return grad_params, jnp.zeros_like(x), grad_y, jnp.zeros_like(probes)


lattice_inv_quad_logdet.defvjp(_iql_fwd, _iql_bwd)


def lattice_nlml(dk, config, params, x, y, probes, mean: Optional[jax.Array] = None):
    """Negative log marginal likelihood per datapoint.

    Matches gpytorch's ExactMarginalLogLikelihood convention of dividing by n
    (the reference trains on ``-mll(output, y)``, train_simplexgp.py:41).
    ``params`` may include ``mean`` (constant mean); pass ``mean`` explicitly
    to override.
    """
    n = y.shape[0]
    if config.axis_name is not None:
        n = n * jax.lax.axis_size(config.axis_name)
    mu = params.get("mean", 0.0) if mean is None else mean
    yc = y - mu
    inv_quad, logdet = lattice_inv_quad_logdet(dk, config, params, x, yc, probes)
    return 0.5 * (inv_quad + logdet + n * jnp.log(2.0 * jnp.pi)) / n
