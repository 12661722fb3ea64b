"""Exact-GP models: lattice-accelerated (Simplex-GP) and dense baselines.

The JAX equivalent of the reference's model stack
(experiments/train_simplexgp.py:13-26):

    ConstantMean + ScaleKernel(RBFLattice/MaternLattice, ard_num_dims=d)
    + GaussianLikelihood(GreaterThan(min_noise))

trained by exact marginal log-likelihood through the BBMM engine
(linalg/mll.py) and predicted with cached CG solves + LOVE-style Lanczos-root
variances (reference eval settings train_simplexgp.py:63-67).

``DenseGP`` is the same model with dense Cholesky algebra -- the analog of the
reference's KeOps exact baseline (experiments/train_keops.py) and the "exact"
side of the Snelson parity test (tests/train_snelson.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..linalg.cg import cg_solve
from ..linalg.mll import BBMMConfig, build_precond, lattice_nlml
from ..linalg.pivoted_cholesky import precond_solve
from ..ops.filter import apply_plan_any, build_plan_any, lattice_filter_rect
from ..ops.kernels import DiscretizedKernel, matern_kernel, mixture_kernel, rbf_kernel
from ..ops.lattice import apply_plan
from .components import constrain, init_raw_params

__all__ = ["SimplexGP", "DenseGP"]


def _mm(a, b):
    """Full-f32 matrix product: these products feed solver and gold paths
    whose accuracy a TF32 product (10 mantissa bits) would spoil."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _rademacher(key, shape):
    return jax.random.rademacher(key, shape, dtype=jnp.float32)


@functools.partial(jax.jit, static_argnames=("coeffs",))
def _host_mv_wide(plan, s, noise, coeffs: tuple, V: jax.Array) -> jax.Array:
    """``s * K_lattice @ V + noise * V`` for wide V, plan passed at runtime.

    Chunked chain-plan apply (ops/filter.py's wide-at-large-n dispatch) with
    everything variable as an argument, so the host eval path compiles this
    ONCE per (n, m) shape instead of once per posterior cache build.
    """
    chunk = 8  # ops/filter.py _WIDE_CHUNK
    n, c = V.shape
    g = -(-c // chunk)
    pad = g * chunk - c
    Vp = jnp.concatenate([V, jnp.zeros((n, pad), V.dtype)], axis=1) if pad else V
    blocks = jnp.moveaxis(Vp.reshape(n, g, chunk), 1, 0)
    out = jax.lax.map(lambda b: apply_plan(plan, b, coeffs), blocks)
    out = jnp.moveaxis(out, 0, 1).reshape(n, g * chunk)[:, :c]
    return s * out + noise * V


@dataclasses.dataclass(frozen=True)
class SimplexGP:
    """Lattice-accelerated exact GP regression model.

    Static configuration object; parameters live in a separate raw dict
    (see models/components.py) so training is pure-functional.
    """

    num_dims: int
    kernel: str = "rbf"  # "rbf" | "matern" | "mixture"
    nu: float = 1.5
    order: int = 1
    min_noise: float = 1e-4
    # "mixture" kernel: Gaussian-mixture discretization targeting matern-nu
    # (ops/kernels.py MixtureKernel) -- higher accuracy than the matern tap
    # filter at J x the apply cost.  ``mix_weights`` overrides the profile-fit
    # weights (see with_fitted_mixture).
    mix_components: int = 8
    mix_weights: Optional[tuple] = None
    bbmm: BBMMConfig = BBMMConfig()
    eval_cg_tolerance: float = 1e-2  # reference train_simplexgp.py:63
    # ARD dimension screening for lattice INFERENCE (0 disables).  At eval
    # time, input dims whose trained inverse lengthscale falls below this
    # fraction of the max are dropped before the lattice posterior is built:
    # a dim with lengthscale L contributes <= (dx/L)^2 to scaled distances
    # (negligible for the near-irrelevant dims ARD identifies), while every
    # embedded dim degrades the permutohedral approximation (the reference's
    # own rel-err tables worsen with d -- protein d=9: 0.506, BASELINE.md:22).
    # A capability the reference lacks; rationale in analysis/QUALITY_GAP.md.
    # Training always runs on the full dims.
    prune_thresh: float = 0.0

    @property
    def dk(self):
        if self.kernel == "rbf":
            return rbf_kernel(self.order)
        if self.kernel == "matern":
            return matern_kernel(self.nu, self.order)
        if self.kernel == "mixture":
            mk = mixture_kernel(self.nu, self.order, self.mix_components)
            if self.mix_weights is not None:
                mk = dataclasses.replace(mk, weights=self.mix_weights)
            return mk
        raise ValueError(f"unknown kernel {self.kernel!r}")

    def with_fitted_mixture(self, raw: dict, x: jax.Array, m: int = 1024, seed: int = 0):
        """Refit mixture weights against a dense subset operator at the
        CURRENT lengthscales (ops/kernels.py fit_mixture_weights_subset) and
        return the updated model.  No-op for non-mixture kernels."""
        if self.kernel != "mixture":
            return self
        import numpy as np

        from ..ops.kernels import fit_mixture_weights_subset

        params = self.constrained(raw)
        ref = np.asarray(x) * np.asarray(params["inv_ell"])
        mk = fit_mixture_weights_subset(self.dk, ref, m=m, seed=seed)
        return dataclasses.replace(self, mix_weights=mk.weights)

    def init_params(self, **kwargs) -> dict:
        return init_raw_params(self.num_dims, **kwargs)

    def constrained(self, raw: dict) -> dict:
        return constrain(raw, self.min_noise)

    # ----- training -----

    def nlml(
        self,
        raw: dict,
        x: jax.Array,
        y: jax.Array,
        key: jax.Array,
        axis_name: Optional[str] = None,
    ) -> jax.Array:
        """Negative log marginal likelihood / n (the training loss).

        With ``axis_name`` (inside shard_map over the data axis) x/y hold
        this shard's rows and the full BBMM engine runs data-sharded
        (parallel/shard_filter.py).  The probe key is folded with the shard
        index so Hutchinson probes are independent ACROSS shards -- identical
        per-shard blocks would bias the trace estimator.
        """
        cfg = self.bbmm
        if axis_name is not None:
            key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
            cfg = dataclasses.replace(cfg, axis_name=axis_name)
        probes = _rademacher(key, (x.shape[0], cfg.num_probes))
        return lattice_nlml(self.dk, cfg, self.constrained(raw), x, y, probes)

    def nlml_value_and_grad_host(self, raw: dict, x: jax.Array, y: jax.Array, key: jax.Array):
        """(loss, grads) via the host-orchestrated engine (linalg/host_loop.py).

        Same algorithm as ``jax.value_and_grad(self.nlml)`` with
        slq_mode="cg"/stop_mode="mean", but the CG loop runs on the host over
        one small jitted iteration, so every compiled piece is small.  Kept
        for very large n; whether the fused graph needs it on the GPU is
        unverified (see linalg/host_loop.py).
        """
        import numpy as np

        from ..linalg.host_loop import host_inv_quad_logdet_grads

        if self.kernel == "mixture":
            raise NotImplementedError(
                "mixture kernel is not wired into the host-orchestrated CG "
                "loop yet; use the fused engine (nlml) for mixture models"
            )
        cfg = self.bbmm
        probes = _rademacher(key, (x.shape[0], cfg.num_probes))
        params, pullback = jax.vjp(lambda r: constrain(r, self.min_noise), raw)
        n = x.shape[0]
        yc = y - params["mean"]
        inv_quad, logdet, alpha, g_params, iters = host_inv_quad_logdet_grads(
            self.dk, cfg, params, x, yc, probes
        )
        loss = 0.5 * (inv_quad + logdet + n * float(jnp.log(2.0 * jnp.pi))) / n
        scale = 0.5 / n
        cot = {k: jnp.asarray(v) * scale for k, v in g_params.items()}
        # d inv_quad / d mean = -2 sum(alpha)  (yc = y - mean).
        cot["mean"] = jnp.asarray(-2.0 * scale * np.asarray(alpha).sum(), jnp.float32)
        (grads_raw,) = pullback(cot)
        return loss, grads_raw

    def posterior_cache_host(self, raw: dict, x: jax.Array, y: jax.Array, key: jax.Array, root_rank: Optional[int] = None):
        """posterior_cache with the eval CG loop on the host (very large n).

        The sketch MVMs reuse the CG's already-built chain plan through one
        jitted chunked apply with the plan as a RUNTIME argument: the former
        per-call plan rebuild paid a multi-second houseelectric chain-plan
        build twice per cache, and closing a jit over the plan arrays would
        bake them as constants and recompile every eval (r4 advisor
        finding).  The returned dict records the solve's final mean residual
        and iteration count so a stall-guard truncation (host_cg_solve) is
        detectable by callers.
        """
        from ..linalg.host_loop import host_cg_solve
        from ..ops.lattice import build_plan as _build_plan

        if self.kernel == "mixture":
            raise NotImplementedError(
                "mixture kernel is not wired into the host eval loop yet; "
                "use posterior_cache (fused engine) for mixture models"
            )
        params = self.constrained(raw)
        ref = x * params["inv_ell"]
        s, noise = params["outputscale"], params["noise"]
        plan = _build_plan(ref, self.dk.coeffs, self.dk.variance, capacity=self.bbmm.plan_capacity)
        P = build_precond(self.dk, self.bbmm, params, ref, x.shape[0])
        yc = y - params["mean"]
        xs, res, iters, *_ = host_cg_solve(
            plan, P, s, noise, self.dk.coeffs, yc[:, None],
            tol=self.eval_cg_tolerance, max_iters=self.bbmm.max_cg_iterations,
        )
        alpha = xs[:, 0]

        n = x.shape[0]
        m = min(root_rank or self.bbmm.max_lanczos_iterations, n)
        omega = jax.random.normal(key, (n, m), jnp.float32)
        Q, _ = jnp.linalg.qr(_host_mv_wide(plan, s, noise, self.dk.coeffs, omega))
        T = _mm(Q.T, _host_mv_wide(plan, s, noise, self.dk.coeffs, Q))
        T = 0.5 * (T + T.T)
        evals, evecs = jnp.linalg.eigh(T)
        evals = jnp.maximum(evals, 1e-8)
        root_inv = _mm(Q, evecs / jnp.sqrt(evals)[None, :])
        return {
            "alpha": alpha,
            "root_inv": root_inv,
            "params": params,
            "cg_res": float(jnp.asarray(res).mean()),
            "cg_iters": int(iters),
        }

    # ----- prediction -----

    def screened(self, raw: dict):
        """(sub_model, raw_sub, keep) with near-irrelevant ARD dims dropped.

        Host-side (shapes are data-dependent, so this cannot live under
        jit): reads the trained inverse lengthscales and returns a reduced-
        dimension copy of the model plus the subset raw params and the kept
        column indices (``keep is None`` when screening is off or keeps
        everything).
        """
        import numpy as np

        if self.prune_thresh <= 0:
            return self, raw, None
        inv_ell = np.asarray(self.constrained(raw)["inv_ell"])
        keep = np.where(inv_ell >= self.prune_thresh * inv_ell.max())[0]
        if len(keep) == self.num_dims:
            return self, raw, None
        sub = dataclasses.replace(self, num_dims=len(keep), prune_thresh=0.0)
        raw_sub = dict(raw)
        raw_sub["raw_lengthscale"] = jnp.asarray(raw["raw_lengthscale"])[jnp.asarray(keep)]
        return sub, raw_sub, keep

    def posterior_cache_screened(self, raw, x, y, key, host: bool = False):
        """posterior_cache with ARD screening applied (see ``prune_thresh``).

        The returned cache carries the screened sub-model and kept columns;
        pair with :meth:`predict_from_cache_screened`.  No-ops to the plain
        cache when screening is off.
        """
        sub, raw_sub, keep = self.screened(raw)
        xs = x if keep is None else x[:, jnp.asarray(keep)]
        cache = (sub.posterior_cache_host if host else sub.posterior_cache)(raw_sub, xs, y, key)
        cache = dict(cache)
        cache["keep"], cache["sub"] = keep, sub
        return cache

    def predict_from_cache_screened(self, cache: dict, x: jax.Array, x_test: jax.Array):
        sub = cache.get("sub", self)
        keep = cache.get("keep")
        if keep is not None:
            ka = jnp.asarray(keep)
            x, x_test = x[:, ka], x_test[:, ka]
        inner = {k: cache[k] for k in ("alpha", "root_inv", "params")}
        return sub.predict_from_cache(inner, x, x_test)

    def _khat_mv(self, params, plan):
        s, noise = params["outputscale"], params["noise"]

        def mv(V):
            return s * apply_plan_any(plan, V, self.dk) + noise * V

        return mv

    @functools.partial(jax.jit, static_argnums=(0,), static_argnames=("root_rank",))
    def posterior_cache(self, raw: dict, x: jax.Array, y: jax.Array, key: jax.Array, root_rank: Optional[int] = None):
        """Precompute alpha = Khat^{-1} y_c and the LOVE root for variances.

        Mirrors GPyTorch's prediction caches under fast_pred_var
        (train_simplexgp.py:67): a rank-m root Khat ~= Q T Q^T, inverted as
        Khat^{-1} ~= (Q U L^{-1/2}) (Q U L^{-1/2})^T.

        Root construction: GPyTorch runs m SEQUENTIAL Lanczos
        steps from one probe; here the basis is a zero-power-iteration
        randomized rangefinder (Halko-Martinsson-Tropp's basic scheme) --
        Y = Khat @ Omega, Q = qr(Y), T = Q^T (Khat @ Q) -- i.e. TWO batched
        m-column filter MVMs instead of m dependent single-column
        ones, and a measurably richer rank-m subspace than a single-probe
        Krylov basis (validated against the dense lattice posterior in
        tests/test_snelson.py).  The second MVM forms T, it does not
        power-iterate the basis; Khat's spectrum decays fast enough here
        that q=0 suffices (tests/test_love.py pins the accuracy).
        """
        params = self.constrained(raw)
        ref = x * params["inv_ell"]
        plan = build_plan_any(ref, self.dk, capacity=self.bbmm.plan_capacity)
        mv = self._khat_mv(params, plan)
        yc = y - params["mean"]

        # Pivoted-Cholesky preconditioner matters most here: eval solves run
        # at the tight eval_cg_tolerance (1e-2 vs training's 1.0, reference
        # train_simplexgp.py:63), where clustering the spectrum saves the
        # most iterations.
        P = build_precond(self.dk, self.bbmm, params, ref, x.shape[0])
        precond = None if P is None else (lambda V: precond_solve(P, V))
        alpha = cg_solve(
            mv, yc[:, None], tol=self.eval_cg_tolerance,
            max_iters=self.bbmm.max_cg_iterations, precond=precond,
        ).x[:, 0]

        n = x.shape[0]
        m = min(root_rank or self.bbmm.max_lanczos_iterations, n)
        omega = jax.random.normal(key, (n, m), jnp.float32)
        # The sketch MVMs are m ~ 100 columns wide: the engine dispatch in
        # ops/filter.py picks the join engine (column-count-independent
        # gathers) at moderate n and the chunked chain plan at very large n
        # (the join engine's (rows, m) tables OOM at houseelectric scale).
        s, noise = params["outputscale"], params["noise"]
        from ..ops.filter import make_wide_filter_any

        # Plan built once at trace time and shared by both sketch MVMs
        # (this whole method is one jit, so the build appears once in the
        # graph by construction rather than by XLA CSE -- r4 advisor).
        kmv = make_wide_filter_any(ref, self.dk, capacity=self.bbmm.plan_capacity)
        mv_wide = lambda V: s * kmv(V) + noise * V
        Q, _ = jnp.linalg.qr(mv_wide(omega))  # (n, m) orthonormal range sketch
        T = _mm(Q.T, mv_wide(Q))
        T = 0.5 * (T + T.T)
        evals, evecs = jnp.linalg.eigh(T)
        evals = jnp.maximum(evals, 1e-8)
        root_inv = _mm(Q, evecs / jnp.sqrt(evals)[None, :])  # (n, m)
        return {"alpha": alpha, "root_inv": root_inv, "params": params}

    @functools.partial(jax.jit, static_argnums=(0,))
    def predict_from_cache(self, cache: dict, x: jax.Array, x_test: jax.Array):
        """Posterior mean and variance at x_test from a precomputed cache.

        ONE rectangular filter call of 1+m columns ([alpha | root_inv]) --
        the mean and LOVE-variance cross-covariance MVMs share the joint
        plan over [train; test] positions, so prediction at a new test block
        costs a single join-plan build + apply (the reference's eval
        likewise reuses its training caches under fast_pred_var,
        train_simplexgp.py:63-71; rebuilding the posterior per predict call
        made every eval pay a full solve).
        """
        params = cache["params"]
        ref = x * params["inv_ell"]
        ref_test = x_test * params["inv_ell"]
        s = params["outputscale"]

        cols = jnp.concatenate([cache["alpha"][:, None], cache["root_inv"]], axis=-1)
        F = lattice_filter_rect(cols, ref, ref_test, self.dk)  # (n_test, 1+m)

        # mean* = K(test, train) alpha + mu.
        mean = s * F[:, 0] + params["mean"]

        # var* = k** + noise - || s * K(test, train) root_inv ||^2 row-wise,
        # k** = outputscale (normalized kernel has unit diagonal,
        # bilateral_kernel.py:139-140).
        S = s * F[:, 1:]
        var = s + params["noise"] - (S * S).sum(axis=-1)
        var = jnp.maximum(var, 1e-8)
        return mean, var

    def predict(self, raw: dict, x: jax.Array, y: jax.Array, x_test: jax.Array, key: jax.Array):
        """Posterior mean and variance (with observation noise) at x_test.

        Convenience wrapper: build the posterior cache, predict once.  Eval
        loops that predict at several test blocks (val + test) should call
        :meth:`posterior_cache` once and :meth:`predict_from_cache` per
        block (experiments/common.py does).
        """
        cache = self.posterior_cache(raw, x, y, key)
        return self.predict_from_cache(cache, x, x_test)


@dataclasses.dataclass(frozen=True)
class DenseGP:
    """Dense exact GP (Cholesky): the KeOps-exact-baseline analog.

    Same parameterization as SimplexGP; O(n^2) memory / O(n^3) time.
    """

    num_dims: int
    kernel: str = "rbf"
    nu: float = 1.5
    min_noise: float = 1e-4

    def init_params(self, **kwargs) -> dict:
        return init_raw_params(self.num_dims, **kwargs)

    def constrained(self, raw: dict) -> dict:
        return constrain(raw, self.min_noise)

    def _kmat(self, params, x1, x2):
        r1 = x1 * params["inv_ell"]
        r2 = x2 * params["inv_ell"]
        # Matmul-form squared distances: the (a, b, d) broadcast temp OOMs at
        # (62k, 8k, d) eval shapes.  The form cancels badly, so the inner
        # product runs in full f32 (never TF32) for this dense gold.
        d2 = (r1 * r1).sum(-1)[:, None] + (r2 * r2).sum(-1)[None, :] - 2.0 * _mm(r1, r2.T)
        d2 = jnp.maximum(d2, 0.0)
        if self.kernel == "rbf":
            k = jnp.exp(-d2)
        elif self.kernel == "matern" and self.nu == 1.5:
            d = jnp.sqrt(d2 + 1e-12)
            k = (1 + jnp.sqrt(3.0) * d) * jnp.exp(-jnp.sqrt(3.0) * d)
        elif self.kernel == "matern" and self.nu == 2.5:
            d = jnp.sqrt(d2 + 1e-12)
            k = (1 + jnp.sqrt(5.0) * d + (5.0 / 3.0) * d2) * jnp.exp(-jnp.sqrt(5.0) * d)
        else:
            raise ValueError(f"unsupported kernel {self.kernel}/{self.nu}")
        return params["outputscale"] * k

    def nlml(self, raw: dict, x: jax.Array, y: jax.Array, key=None) -> jax.Array:
        params = self.constrained(raw)
        n = x.shape[0]
        K = self._kmat(params, x, x) + params["noise"] * jnp.eye(n)
        yc = y - params["mean"]
        L = jnp.linalg.cholesky(K)
        a = jax.scipy.linalg.cho_solve((L, True), yc[:, None])[:, 0]
        return 0.5 * ((yc * a).sum() + 2 * jnp.log(jnp.diag(L)).sum() + n * jnp.log(2 * jnp.pi)) / n

    def predict(
        self,
        raw: dict,
        x: jax.Array,
        y: jax.Array,
        x_test: jax.Array,
        key=None,
        block: int = 2048,
    ):
        """Posterior mean/variance, blocked over test rows.

        The train-side Cholesky is O(n^2) memory regardless, but the
        cross-covariance is streamed in ``block``-row chunks so large
        val/test sets (precipitation: 62k rows) never materialize an
        (n_test, n) f32 matrix plus its solve temps at once.  The triangular
        solve materializes ~(n, block) temps several times over; the block
        size is untuned on the H100.
        """
        params = self.constrained(raw)
        n = x.shape[0]
        K = self._kmat(params, x, x) + params["noise"] * jnp.eye(n)
        L = jnp.linalg.cholesky(K)
        yc = y - params["mean"]
        a = jax.scipy.linalg.cho_solve((L, True), yc[:, None])[:, 0]
        means, vars = [], []
        for i in range(0, x_test.shape[0], block):
            Kst = self._kmat(params, x_test[i : i + block], x)
            means.append(_mm(Kst, a) + params["mean"])
            v = jax.scipy.linalg.solve_triangular(L, Kst.T, lower=True)
            vars.append(params["outputscale"] + params["noise"] - (v * v).sum(axis=0))
        mean = jnp.concatenate(means) if len(means) > 1 else means[0]
        var = jnp.concatenate(vars) if len(vars) > 1 else vars[0]
        return mean, jnp.maximum(var, 1e-8)
