"""Batched preconditioned conjugate gradients, pure JAX.

The reference drives all solves through GPyTorch's ``linear_cg`` (BBMM,
SURVEY.md section 2.4): batched CG over multiple right-hand sides against an
implicit operator, preconditioned, with a loose tolerance during training
(reference config ``cg_tolerance=1.0``, ``eval_cg_tolerance=1e-2``,
``max_cg_iterations=500`` -- configs/simplexgp.yml).

Formulation: a single ``lax.while_loop`` whose state carries all
right-hand sides at once; the operator is applied to the full (n, t) block so
every MVM is one fused lattice filter / one big matmul, and
inner products reduce over the data axis (a ``psum`` when sharded).
Converged columns are frozen by masking rather than dropped, keeping shapes
static for XLA.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["CGResult", "cg_solve"]


class CGResult(NamedTuple):
    x: jax.Array  # (n, t) best-residual iterate per column
    iterations: jax.Array  # () int32, iterations actually run
    residual_norm: jax.Array  # (t,) best relative residual norms
    # CG-tridiagonalization record (present when tridiag_m > 0): the Lanczos
    # tridiagonal of the (preconditioned) operator with starting vector
    # b-hat/|b-hat| per column, recovered from the CG step/conjugacy
    # coefficients.  tmask[k, j] marks iteration k of column j as live
    # (pre-convergence); dead steps carry (alpha=1, beta=0), which pads T
    # with a decoupled identity block that contributes nothing to the
    # quadrature.
    alphas: Optional[jax.Array] = None  # (m, t) step sizes rz/pAp
    betas: Optional[jax.Array] = None  # (m, t) conjugacy coefficients rz'/rz
    tmask: Optional[jax.Array] = None  # (m, t) bool live-step mask


def cg_solve(
    matmul: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    tol: float = 1.0,
    max_iters: int = 500,
    precond: Optional[Callable[[jax.Array], jax.Array]] = None,
    axis_name: Optional[str] = None,
    min_iters: int = 10,
    tridiag_m: int = 0,
    stop_mode: str = "mean",
    stall_window: int = 50,
) -> CGResult:
    """Solve ``A x = b`` for an SPD implicit operator, all columns at once.

    Args:
      matmul: V (n, t) -> A @ V.  Must be (numerically) symmetric
        positive-definite.
      b: (n, t) right-hand sides.
      tol: stop when every column's residual norm relative to its RHS norm is
        below this (GPyTorch stops on mean residual norm; per-column is
        stricter and freezes converged columns).
      max_iters: static iteration cap.
      precond: optional V -> P^{-1} V.
      axis_name: if set (inside shard_map), rows of b are sharded over that
        mesh axis: every inner product becomes a psum, and matmul
        must be the data-sharded operator.  All shards run the identical
        iteration (same scalars after psum), so control flow stays in sync.
      min_iters: iteration FLOOR before the tolerance check may stop a
        column.  GPyTorch's linear_cg guards its tolerance test with
        ``k >= min(10, max_iter - 1)`` -- without that floor, the reference's
        canonical TRAINING tolerance of 1.0 (configs/simplexgp.yml) would
        stop after a single iteration and train on near-garbage solves.
        Parity requires the same floor; ``min(min_iters, max_iters)`` is
        used so tiny explicit budgets still work.
      stop_mode: "mean" (default, GPyTorch-parity): stop the WHOLE solve
        when the mean relative residual over columns drops below ``tol``
        (linear_cg's ``residual_norm.mean() < tolerance`` break); a column
        only freezes individually once essentially exact (res < 1e-10,
        linear_cg's ``stop_updating_after``).  At the reference's training
        tolerance of 1.0 this stops at the 10-iteration floor nearly always
        -- uniform epoch cost and a CONSISTENT (same-truncation) NLML
        estimate even when some column of the indefinite lattice operator
        refuses to converge; per-column stopping instead alternates between
        ~10-iteration and max-iteration epochs, which is the late-epoch
        MLL bimodality of the r3 elevators run.  "column": stop each column
        at its own tolerance (stricter; used by tests that assert
        per-column convergence behavior).
      stall_window: stop the whole solve after this many consecutive
        iterations (past the ``min_iters`` floor) in which the mean
        best-residual improved by less than 1% -- the same guard as the
        host-orchestrated loop (linalg/host_loop.py), so fused and host
        engines are iteration-identical in the indefinite regime the guard
        exists for (lattice-degenerate operators whose residual never
        crosses tol would otherwise burn all ``max_iters`` at full MVM
        cost; the best-residual iterate is retained either way).  0
        disables.
      tridiag_m: when > 0, also record the first ``tridiag_m`` CG step/
        conjugacy coefficients per column (GPyTorch linear_cg's
        ``n_tridiag`` path): the Lanczos tridiagonal of the preconditioned
        operator is T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1},
        T[k,k+1] = sqrt(beta_k)/alpha_k, which is what SLQ log-det
        quadrature needs -- with NO Lanczos basis storage (the (m, n, p)
        basis of linalg/lanczos.py is the houseelectric-scale OOM).

    Returns:
      CGResult with the solution block and diagnostics.
    """
    if precond is None:
        precond = lambda v: v

    def dot(u, v):  # column-wise inner products over the (possibly sharded) rows
        s = (u * v).sum(axis=0)
        return jax.lax.psum(s, axis_name) if axis_name is not None else s

    b = b.astype(jnp.float32)
    b_norm = jnp.sqrt(dot(b, b))  # (t,)
    b_norm = jnp.where(b_norm == 0, 1.0, b_norm)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)  # (t,)

    floor = min(min_iters, max_iters)

    def cond(state):
        it, done = state[5], state[6]
        return (it < max_iters) & ~jnp.all(done)

    def body(state):
        x, r, p, z, rz, it, done, x_best, res_best, best_mean, since = state[:11]
        ap = matmul(p)
        pap = dot(p, ap)
        # Column breakdown: pap <= 0 means the (preconditioned) operator
        # looked indefinite along p -- truly indefinite lattice operator, or
        # f32 rounding in the Woodbury projection at numerically-low-rank
        # geometries (the r5 precipitation bug).  A negative alpha step
        # DIVERGES the iterate; freeze the column at its best iterate
        # instead.  Same for a negative rz (preconditioner breakdown).
        broken = ~done & (pap <= 0)
        alpha = jnp.where(done | (pap <= 0), 0.0, rz / jnp.where(pap <= 0, 1.0, pap))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        broken = broken | (~done & (rz_new < 0))
        beta = jnp.where(
            done | broken | (rz == 0), 0.0, rz_new / jnp.where(rz == 0, 1.0, rz)
        )
        p = z + beta * p
        res = jnp.sqrt(dot(r, r)) / b_norm
        # Track the minimum-residual iterate per column.  For a healthy SPD
        # solve this IS (numerically) the final iterate; when the operator is
        # indefinite -- the lattice kernel's blur passes do not commute, and
        # at long lengthscales the discretized operator picks up negative
        # eigenvalues -- plain CG can diverge, and returning the best iterate
        # degrades gracefully (x0 = 0, relative residual 1, is always a
        # candidate, so a failed solve falls back to the prior mean instead
        # of amplifying garbage into predictions).
        better = res < res_best
        x_best = jnp.where(better[None, :], x, x_best)
        res_best = jnp.minimum(res, res_best)
        # Stall guard (identical to linalg/host_loop.py's): mean best
        # residual must improve by >= 1% at least once per `stall_window`
        # iterations past the floor, else the whole solve stops with the
        # best iterate.  best_mean/since are shard-identical when sharded
        # (res comes from psum'd dots), keeping mesh control flow in sync.
        m_best = res_best.mean()
        improved = m_best < 0.99 * best_mean
        best_mean = jnp.where(improved, m_best, best_mean)
        since = jnp.where(improved, 0, since + 1)
        stalled = (
            (since >= stall_window) & (it + 1 >= floor)
            if stall_window
            else jnp.bool_(False)
        )
        # GPyTorch-parity iteration floor: the tolerance may not stop a
        # column before `floor` iterations have run (see docstring).
        if stop_mode == "mean":
            # res is already a global quantity when sharded (dots psum), so
            # the column mean is shard-identical and control flow stays in
            # sync across the mesh.
            stop_all = (res.mean() < tol) & (it + 1 >= floor)
            new_done = done | stop_all | stalled | (res < 1e-10) | broken
        else:
            new_done = done | ((res < tol) & (it + 1 >= floor)) | stalled | broken
        out = (x, r, p, z, rz_new, it + 1, new_done, x_best, res_best, best_mean, since)
        if tridiag_m:
            A, B, TM, t_alive = state[11:]
            # A step is a valid Lanczos step only while the column has never
            # converged or broken down (pap <= 0: the operator looked
            # indefinite along p; rz <= 0: preconditioner breakdown) -- once
            # either happens the CG<->Lanczos correspondence is void for
            # that column, permanently.
            ok = t_alive & ~done & (pap > 0) & (rz > 0)
            rec = ok & (it < tridiag_m)
            k = jnp.minimum(it, tridiag_m - 1)
            A = A.at[k].set(jnp.where(rec, alpha, A[k]))
            B = B.at[k].set(jnp.where(rec, beta, B[k]))
            TM = TM.at[k].set(jnp.where(rec, True, TM[k]))
            out = out + (A, B, TM, ok)
        return out

    res0 = jnp.sqrt(dot(r0, r0)) / b_norm
    # Never mark a column converged at iteration ZERO.  res0 is
    # sqrt(dot(b,b))/b_norm -- mathematically 1, but the numerator and
    # denominator are separate f32 reductions that can round one ulp apart,
    # and which way they round depends on the VALUES of b (e.g. the drifting
    # mean parameter during training).  At the reference's training
    # tolerance tol=1.0 (configs/simplexgp.yml), `res0 < tol` then flips
    # between epochs: a spuriously "pre-converged" column stays frozen at
    # x0 = 0, zeroing its inv_quad term and jumping the NLML by ~0.4
    # nats/point (the r2 "bimodal MLL" pathology -- see
    # analysis/NLML_BIMODAL.md).  One CG iteration is always sound on an
    # SPD operator, so start every column live.
    done0 = jnp.zeros(res0.shape, bool)
    state = (
        x0, r0, p0, z0, rz0, jnp.int32(0), done0, x0, res0,
        jnp.float32(jnp.inf), jnp.int32(0),
    )
    if tridiag_m:
        t = b.shape[-1]
        state = state + (
            jnp.ones((tridiag_m, t), jnp.float32),
            jnp.zeros((tridiag_m, t), jnp.float32),
            jnp.zeros((tridiag_m, t), bool),
            jnp.ones((t,), bool),
        )
    final = jax.lax.while_loop(cond, body, state)
    it, x_best, res_best = final[5], final[7], final[8]
    if tridiag_m:
        return CGResult(
            x=x_best, iterations=it, residual_norm=res_best,
            alphas=final[11], betas=final[12], tmask=final[13],
        )
    return CGResult(x=x_best, iterations=it, residual_norm=res_best)
