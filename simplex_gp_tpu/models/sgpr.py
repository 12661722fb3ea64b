"""SGPR baseline: sparse GP regression with inducing points.

Baseline-parity target: the reference's SGPR trainer
(experiments/train_sgpr.py) wraps GPyTorch's ``InducingPointKernel`` with 512
inducing points sampled from the training set (SURVEY.md section 2.5).  That
construction trains the inducing locations jointly and evaluates the exact GP
NLML of the Nystrom-approximate kernel K_nm K_mm^{-1} K_mn with a diagonal
(FITC-free, SoR) correction folded in by GPyTorch's preconditioned solves; the
standard equivalent-quality formulation is Titsias' collapsed variational
bound, which is what we implement -- O(n m^2) time, O(n m) memory, exact in
the m -> n limit.

Everything is tall-skinny (n, m) matmuls and m x m Cholesky; no lattice is
involved.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .components import constrain, init_raw_params

__all__ = ["SGPR"]


@dataclasses.dataclass(frozen=True)
class SGPR:
    num_dims: int
    num_inducing: int = 512
    kernel: str = "rbf"
    nu: float = 1.5
    min_noise: float = 1e-4

    def init_params(self, x: jax.Array, seed: int = 0, **kwargs) -> dict:
        raw = init_raw_params(self.num_dims, **kwargs)
        # Inducing locations initialized from a random training subset, as in
        # the reference (train_sgpr.py: inducing points sampled from train x).
        key = jax.random.PRNGKey(seed)
        idx = jax.random.choice(key, x.shape[0], (min(self.num_inducing, x.shape[0]),), replace=False)
        raw["inducing"] = x[idx]
        return raw

    def constrained(self, raw: dict) -> dict:
        p = constrain(raw, self.min_noise)
        p["inducing"] = raw["inducing"]
        return p

    def _k(self, params, x1, x2):
        r1 = x1 * params["inv_ell"]
        r2 = x2 * params["inv_ell"]
        # Matmul-form squared distances (no (a, b, d) broadcast temp).  The
        # form cancels badly, so the inner product runs in full f32, never TF32.
        d2 = (r1 * r1).sum(-1)[:, None] + (r2 * r2).sum(-1)[None, :] - 2.0 * jnp.matmul(
            r1, r2.T, precision=jax.lax.Precision.HIGHEST
        )
        d2 = jnp.maximum(d2, 0.0)
        if self.kernel == "rbf":
            k = jnp.exp(-d2)
        elif self.kernel == "matern" and self.nu == 1.5:
            d = jnp.sqrt(d2 + 1e-12)
            k = (1 + jnp.sqrt(3.0) * d) * jnp.exp(-jnp.sqrt(3.0) * d)
        else:
            raise ValueError(f"unsupported kernel {self.kernel}/{self.nu}")
        return params["outputscale"] * k

    def _common(self, params, x, y):
        z = params["inducing"]
        m = z.shape[0]
        n = x.shape[0]
        noise = params["noise"]
        kmm = self._k(params, z, z) + 1e-5 * jnp.eye(m)
        kmn = self._k(params, z, x)  # (m, n)
        L = jnp.linalg.cholesky(kmm)
        A = jax.scipy.linalg.solve_triangular(L, kmn, lower=True) / jnp.sqrt(noise)  # (m, n)
        B = jnp.eye(m) + A @ A.T
        LB = jnp.linalg.cholesky(B)
        yc = (y - params["mean"]) / jnp.sqrt(noise)
        Ay = A @ yc  # (m,)
        c = jax.scipy.linalg.solve_triangular(LB, Ay, lower=True)
        return dict(L=L, A=A, LB=LB, c=c, yc=yc, m=m, n=n, noise=noise)

    def nlml(self, raw: dict, x: jax.Array, y: jax.Array, key=None) -> jax.Array:
        """Titsias collapsed bound / n (negated), the SGPR training loss."""
        params = self.constrained(raw)
        q = self._common(params, x, y)
        n, noise = q["n"], q["noise"]
        # log|Qnn + noise I| = log|B| + n log noise
        logdet = 2 * jnp.log(jnp.diag(q["LB"])).sum() + n * jnp.log(noise)
        quad = (q["yc"] * q["yc"]).sum() - (q["c"] * q["c"]).sum()
        # Trace correction: (1/noise) * tr(Knn - Qnn)
        kdiag = params["outputscale"] * jnp.ones((n,))
        qdiag = noise * (q["A"] * q["A"]).sum(axis=0)
        trace = (kdiag.sum() - qdiag.sum()) / noise
        bound = 0.5 * (logdet + quad + n * jnp.log(2 * jnp.pi) + trace)
        return bound / n

    def predict(self, raw: dict, x: jax.Array, y: jax.Array, x_test: jax.Array, key=None):
        params = self.constrained(raw)
        q = self._common(params, x, y)
        z = params["inducing"]
        kts = self._k(params, z, x_test)  # (m, n_test)
        lk = jax.scipy.linalg.solve_triangular(q["L"], kts, lower=True)  # (m, nt)
        w = jax.scipy.linalg.solve_triangular(q["LB"], lk, lower=True)  # (m, nt)
        mean = w.T @ q["c"] + params["mean"]
        var = (
            params["outputscale"]
            - (lk * lk).sum(axis=0)
            + (w * w).sum(axis=0)
            + q["noise"]
        )
        return mean, jnp.maximum(var, 1e-8)
