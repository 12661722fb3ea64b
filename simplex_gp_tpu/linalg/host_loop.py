"""Host-orchestrated BBMM engine for very large n.

The single-graph engine (linalg/mll.py) compiles the WHOLE NLML step -- plan
build + preconditioner + a CG ``lax.while_loop`` whose body contains ~d+2
variadic sorts over n*(d+1) rows + the backward filter -- into one XLA
program.  At houseelectric scale (n = 1.3M, d = 11, 15.7M contribution rows)
that program was at the edge of what the toolchain it was first built on
handled (compile-memory exhaustion, very long compiles), while each PIECE
compiled and ran fine.  Whether the fused graph compiles and fits at that
scale on the H100 is unverified; if it does, this module can go.

This module runs the same algorithm with the LOOP ON THE HOST: one jitted
CG iteration (plan and preconditioner passed as arguments, so nothing is
baked into the graph as constants), mean-residual stopping evaluated on the
host, CG-tridiag SLQ coefficients collected per iteration, and the one-call
closed-form backward (the same u^T dK_hat v evaluation as the custom VJP in
linalg/mll.py).  Each iteration pays one host dispatch, small against
multi-second MVMs, and every compiled piece is small.

This is the engine behind ``SimplexGP.nlml_value_and_grad_host`` and
``posterior_cache_host`` (models/exact_gp.py), selected by the trainer for
very large n.  Numerical behavior matches the fused engine exactly
(tests/test_host_loop.py pins values and gradients against it).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.kernels import DiscretizedKernel
from ..ops.lattice import apply_plan, build_plan
from .lanczos import logdet_from_cg_tridiag
from .mll import BBMMConfig, _khat_matmul_diff, build_precond
from .pivoted_cholesky import precond_solve, precond_sqrt

__all__ = ["host_cg_solve", "host_inv_quad_logdet_grads"]


class _CGState(NamedTuple):
    x: jax.Array
    r: jax.Array
    p: jax.Array
    z: jax.Array
    rz: jax.Array
    x_best: jax.Array
    res_best: jax.Array
    done: jax.Array  # (t,) bool: column frozen (breakdown or essentially exact)


@functools.partial(jax.jit, static_argnames=("coeffs",), donate_argnums=(0,))
def _cg_iter(state: _CGState, plan, P, s, noise, coeffs, b_norm):
    """One preconditioned CG iteration on the full RHS block (donated state)."""
    x, r, p, z, rz, x_best, res_best, done = state
    ap = s * apply_plan(plan, p, coeffs) + noise * p
    pap = (p * ap).sum(axis=0)
    # Column breakdown freeze, identical to cg_solve: a negative-pap step
    # (indefinite direction or Woodbury rounding) or negative rz diverges
    # the iterate; freeze at the best iterate instead.
    broken = ~done & (pap <= 0)
    alpha = jnp.where(done | (pap <= 0), 0.0, rz / jnp.where(pap <= 0, 1.0, pap))
    x = x + alpha * p
    r = r - alpha * ap
    z = precond_solve(P, r) if P is not None else r
    rz_new = (r * z).sum(axis=0)
    broken = broken | (~done & (rz_new < 0))
    beta = jnp.where(done | broken | (rz == 0), 0.0, rz_new / jnp.where(rz == 0, 1.0, rz))
    p = z + beta * p
    res = jnp.sqrt((r * r).sum(axis=0)) / b_norm
    better = res < res_best
    x_best = jnp.where(better[None, :], x, x_best)
    res_best = jnp.minimum(res, res_best)
    done = done | broken | (res < 1e-10)
    # rz (the ENTRY value, used for alpha) rides along for the host-side
    # tridiag liveness test -- preconditioner breakdown (rz <= 0) voids the
    # CG<->Lanczos correspondence exactly as in the fused engine.
    return _CGState(x, r, p, z, rz_new, x_best, res_best, done), (alpha, beta, pap, res, rz)


def host_cg_solve(
    plan,
    P,
    s,
    noise,
    coeffs: tuple,
    b: jax.Array,
    tol: float,
    max_iters: int,
    min_iters: int = 10,
    tridiag_m: int = 0,
    stall_window: int = 50,
):
    """Python-loop preconditioned CG: semantics of ``cg_solve(stop_mode="mean")``.

    Returns (x_best, res_best, iters, alphas, betas, tmask) with the tridiag
    records as (m, t) numpy arrays (empty when tridiag_m == 0).
    """
    b = b.astype(jnp.float32)
    b_norm = jnp.sqrt((b * b).sum(axis=0))
    b_norm = jnp.where(b_norm == 0, 1.0, b_norm)
    z0 = precond_solve(P, b) if P is not None else b
    rz0 = (b * z0).sum(axis=0)
    res0 = jnp.sqrt((b * b).sum(axis=0)) / b_norm
    # Distinct buffers for every donated state leaf: with P=None, r/p/z all
    # alias b, and _cg_iter donates its state (donating one buffer twice is
    # a runtime error; donating b would invalidate the caller's array).
    state = _CGState(
        jnp.zeros_like(b), jnp.copy(b), jnp.copy(z0), jnp.copy(z0),
        rz0, jnp.zeros_like(b), res0, jnp.zeros(res0.shape, bool),
    )

    t = b.shape[-1]
    A = np.ones((max(tridiag_m, 1), t), np.float32)
    B = np.zeros((max(tridiag_m, 1), t), np.float32)
    TM = np.zeros((max(tridiag_m, 1), t), bool)
    t_alive = np.ones((t,), bool)
    conv = np.zeros((t,), bool)  # columns already essentially exact

    floor = min(min_iters, max_iters)
    it = 0
    best_mean = float("inf")
    since_improved = 0
    for it in range(1, max_iters + 1):
        state, (alpha, beta, pap, res, rz_in) = _cg_iter(
            state, plan, P, s, noise, coeffs, b_norm
        )
        # One small device->host pull per iteration (the host-side stop test).
        alpha_h, beta_h, pap_h, res_h, rz_h = (
            np.asarray(alpha), np.asarray(beta), np.asarray(pap),
            np.asarray(res), np.asarray(rz_in),
        )
        k = it - 1
        if tridiag_m and k < tridiag_m:
            # Mirror cg_solve's liveness condition exactly: a step is a valid
            # Lanczos step only while the column has never converged
            # (res < 1e-10 at an earlier iteration: post-convergence steps
            # have near-zero alpha and would inject huge 1/alpha diagonal
            # entries) or broken down (pap <= 0: operator indefinite along p;
            # rz <= 0: preconditioner breakdown).
            ok = t_alive & ~conv & (pap_h > 0) & (rz_h > 0) & np.isfinite(alpha_h)
            A[k] = np.where(ok, alpha_h, 1.0)
            B[k] = np.where(ok, beta_h, 0.0)
            TM[k] = ok
            t_alive = ok
        conv |= res_h < 1e-10
        if it >= floor and float(res_h.mean()) < tol:
            break
        # Stall guard (identical semantics in the fused engine, cg_solve's
        # `stall_window`): when the operator is effectively indefinite
        # (lattice-degenerate regime: exact-kernel preconditioner vs a
        # heavily-discretized operator), the residual may NEVER cross tol --
        # without this guard a tol=1.0 training solve burns all max_iters at
        # multi-second MVM cost.  The best-residual iterate is retained
        # either way.
        m = float(np.asarray(state.res_best).mean())
        if m < 0.99 * best_mean:
            best_mean, since_improved = m, 0
        else:
            since_improved += 1
            if stall_window and it >= floor and since_improved >= stall_window:
                break
    return state.x_best, state.res_best, it, A[:tridiag_m], B[:tridiag_m], TM[:tridiag_m]


@functools.partial(jax.jit, static_argnames=("dk", "grad_mode", "capacity"))
def _backward_filter(params, x, dk: DiscretizedKernel, U, V, grad_mode, capacity):
    """grad_params of sum(U * K_hat(params) V): the closed-form NLML backward."""
    _, vjp = jax.vjp(
        lambda prm: _khat_matmul_diff(prm, x, dk, V, grad_mode, capacity=capacity),
        params,
    )
    (grad_params,) = vjp(U)
    return grad_params


def host_inv_quad_logdet_grads(
    dk: DiscretizedKernel,
    config: BBMMConfig,
    params: dict,
    x: jax.Array,
    yc: jax.Array,
    probes: jax.Array,
):
    """(inv_quad, logdet, alpha, grad_params) -- the NLML core, host-looped.

    Mirrors linalg/mll.py's slq_mode="cg" engine piece for piece; gradients
    are w.r.t. the CONSTRAINED params dict (chain rule through the
    constraint transform happens in the caller's small jit).
    """
    ref = x * params["inv_ell"]
    s, noise = params["outputscale"], params["noise"]
    plan = build_plan(ref, dk.coeffs, dk.variance, capacity=config.plan_capacity)
    P = build_precond(dk, config, params, ref, x.shape[0])

    b_probes = probes if P is None else precond_sqrt(P, probes)
    rhs = jnp.concatenate([yc[:, None], b_probes], axis=-1)
    m = min(config.max_lanczos_iterations, config.max_cg_iterations, x.shape[0])
    xs, _, iters, A, B, TM = host_cg_solve(
        plan, P, s, noise, dk.coeffs, rhs,
        tol=config.cg_tolerance, max_iters=config.max_cg_iterations, tridiag_m=m,
    )
    alpha = xs[:, 0]
    z_solves = xs[:, 1:]
    inv_quad = float(np.asarray((yc * alpha).sum()))
    z_norm2 = (probes * probes).sum(axis=0)
    logdet = float(np.asarray(logdet_from_cg_tridiag(
        jnp.asarray(A[:, 1:]), jnp.asarray(B[:, 1:]), jnp.asarray(TM[:, 1:]), z_norm2
    )))
    if P is not None:
        logdet += float(np.asarray(P.logdet))

    # d(-2 log lik terms): d(inv_quad) = -alpha^T dK alpha;
    # d(logdet) ~= (1/p) sum_i (K^{-1} b_i)^T dK (P^{-1} b_i).
    p = probes.shape[-1]
    probes_right = probes if P is None else precond_solve(P, b_probes)
    U = jnp.concatenate([-alpha[:, None], z_solves / p], axis=-1)
    V = jnp.concatenate([alpha[:, None], probes_right], axis=-1)
    grad_params = _backward_filter(
        params, x, dk, U, V, config.grad_mode, config.plan_capacity
    )
    return inv_quad, logdet, alpha, grad_params, iters
