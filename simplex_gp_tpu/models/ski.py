"""SKIP baseline: structured kernel interpolation with product structure.

Baseline-parity target: the reference's SKIP trainer (experiments/
train_skip.py) composes GPyTorch's ``ProductStructureKernel(
GridInterpolationKernel(base, grid_size, num_dims=1))``: a per-dimension 1-D
KISS-GP kernel (cubic interpolation onto a regular grid, Toeplitz structure)
whose d factors are multiplied elementwise, with MVMs done by iterated
Hadamard products (SKIP, Gardner et al. 2018).

Formulation implemented here:

  * per-dimension 1-D grid kernel: W_j K_j W_j^T with W_j the sparse cubic
    interpolation matrix (n x g) and K_j the 1-D stationary kernel on a
    regular grid.  K_j is Toeplitz; its MVM is computed densely (g x g) since
    grid sizes are ~100 (a g log g FFT path is unnecessary at this size);
  * product structure: K = prod_j (W_j K_j W_j^T) elementwise.  Exact
    elementwise-product MVMs are exponential in d, so (like SKIP's rank-r
    Lanczos factorization) each factor is truncated to rank r via its grid
    eigendecomposition: W_j K_j W_j^T ~= sum_k lambda_k (W_j u_k)(W_j u_k)^T,
    and factors are combined pairwise keeping the top-r outer products.
  * the result is a rank-r symmetric factorization K ~= R R^T feeding the
    same BBMM CG/NLML machinery as the lattice kernel.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .components import constrain, init_raw_params

__all__ = ["SKIP"]


def _cubic_kernel(s):
    """Keys cubic convolution interpolation weights (a = -0.5), |s| <= 2."""
    s = jnp.abs(s)
    w1 = (1.5 * s - 2.5) * s * s + 1.0  # |s| <= 1
    w2 = ((-0.5 * s + 2.5) * s - 4.0) * s + 2.0  # 1 < |s| <= 2
    return jnp.where(s <= 1.0, w1, jnp.where(s <= 2.0, w2, 0.0))


def _interp_1d(x: jax.Array, grid_min: float, grid_step: float, grid_size: int):
    """Sparse cubic interpolation of points onto a 1-D regular grid.

    Returns (idx (n, 4), w (n, 4)) with idx in [0, grid_size).
    """
    pos = (x - grid_min) / grid_step  # fractional grid coordinate
    base = jnp.floor(pos).astype(jnp.int32)
    offs = jnp.arange(-1, 3)
    idx = base[:, None] + offs[None, :]
    w = _cubic_kernel(pos[:, None] - idx.astype(pos.dtype))
    idx = jnp.clip(idx, 0, grid_size - 1)
    w = w / jnp.maximum(w.sum(axis=-1, keepdims=True), 1e-12)
    return idx, w


@dataclasses.dataclass(frozen=True)
class SKIP:
    """Product-structure KISS-GP regression model (SKIP baseline)."""

    num_dims: int
    grid_size: int = 100
    rank: int = 64
    kernel: str = "rbf"
    nu: float = 1.5
    min_noise: float = 1e-4

    def init_params(self, **kwargs) -> dict:
        return init_raw_params(self.num_dims, **kwargs)

    def constrained(self, raw: dict) -> dict:
        return constrain(raw, self.min_noise)

    def _grid_kernel_1d(self, inv_ell_j, grid: jax.Array) -> jax.Array:
        d2 = ((grid[:, None] - grid[None, :]) * inv_ell_j) ** 2
        if self.kernel == "rbf":
            return jnp.exp(-d2)
        if self.kernel == "matern" and self.nu == 1.5:
            dd = jnp.sqrt(d2 + 1e-12)
            return (1 + jnp.sqrt(3.0) * dd) * jnp.exp(-jnp.sqrt(3.0) * dd)
        raise ValueError(f"unsupported kernel {self.kernel}/{self.nu}")

    def _root(self, params, x: jax.Array) -> jax.Array:
        """Rank-r root R with K ~= R R^T (without outputscale)."""
        n, d = x.shape
        g = self.grid_size
        r = min(self.rank, g)

        # Per-dim grids span the data with a 2-cell margin (GPyTorch pads
        # its grid bounds similarly for the cubic stencil).
        R = None
        for j in range(d):
            xj = x[:, j]
            lo = xj.min()
            hi = xj.max()
            step = (hi - lo) / (g - 5) + 1e-12
            grid = lo - 2 * step + step * jnp.arange(g)
            idx, w = _interp_1d(xj, lo - 2 * step, step, g)
            Kg = self._grid_kernel_1d(params["inv_ell"][j], grid)
            evals, evecs = jnp.linalg.eigh(Kg)
            evals = jnp.maximum(evals[-r:], 0.0)
            U = evecs[:, -r:] * jnp.sqrt(evals)[None, :]  # (g, r)
            # Interpolate grid factors to the data points: (n, r).
            Fj = (w[:, :, None] * U[idx]).sum(axis=1)
            if R is None:
                R = Fj
            else:
                # Hadamard (elementwise) product of two rank-r factors is
                # rank r^2; truncate back to rank r via QR + SVD.
                M = R[:, :, None] * Fj[:, None, :]  # (n, r, r)
                M = M.reshape(n, -1)
                # Top-r via randomized range finding (deterministic seed).
                key = jax.random.PRNGKey(j)
                omega = jax.random.normal(key, (M.shape[1], r), M.dtype)
                Y = M @ omega
                Q, _ = jnp.linalg.qr(Y)
                B = Q.T @ M  # (r, r^2)
                Ub, sb, _ = jnp.linalg.svd(B, full_matrices=False)
                R = (Q @ Ub[:, :r]) * sb[:r][None, :]
        return R

    def _khat(self, params, x):
        R = self._root(params, x)  # (n, r)
        s, noise = params["outputscale"], params["noise"]

        def mv(V):
            return s * (R @ (R.T @ V)) + noise * V

        return mv, R

    def nlml(self, raw: dict, x: jax.Array, y: jax.Array, key=None) -> jax.Array:
        """Exact NLML of the rank-r + noise operator (Woodbury/lemma)."""
        params = self.constrained(raw)
        _, R = self._khat(params, x)
        n, r = R.shape
        s, noise = params["outputscale"], params["noise"]
        yc = y - params["mean"]
        A = s * (R.T @ R) / noise + jnp.eye(r)  # (r, r)
        L = jnp.linalg.cholesky(A)
        logdet = 2 * jnp.log(jnp.diag(L)).sum() + n * jnp.log(noise)
        Rty = R.T @ yc
        sol = jax.scipy.linalg.cho_solve((L, True), Rty)
        quad = ((yc * yc).sum() - s * (Rty * sol).sum() / noise) / noise
        return 0.5 * (quad + logdet + n * jnp.log(2 * jnp.pi)) / n

    def predict(self, raw: dict, x: jax.Array, y: jax.Array, x_test: jax.Array, key=None):
        params = self.constrained(raw)
        s, noise = params["outputscale"], params["noise"]
        n = x.shape[0]
        nt = x_test.shape[0]
        # Joint root over [train; test] so cross-covariances share the grid.
        R = self._root(params, jnp.concatenate([x, x_test], axis=0))
        Rtr, Rte = R[:n], R[n:]
        yc = y - params["mean"]
        r = R.shape[1]
        A = s * (Rtr.T @ Rtr) / noise + jnp.eye(r)
        L = jnp.linalg.cholesky(A)
        Rty = Rtr.T @ yc
        sol = jax.scipy.linalg.cho_solve((L, True), Rty)
        alpha_r = (Rty - s * (Rtr.T @ (Rtr @ sol)) / noise) / noise  # R^T Khat^{-1} yc
        mean = s * (Rte @ alpha_r) + params["mean"]
        # var = s*k** + noise - s^2 * diag(Rte (R^T Khat^-1 R) Rte^T) with
        # R^T Khat^{-1} R = (C - s C A^{-1} C / noise) / noise, C = R^T R.
        C = Rtr.T @ Rtr
        AinvC = jax.scipy.linalg.cho_solve((L, True), C)
        inner = (C - s * C @ AinvC / noise) / noise
        var = s + noise - (s**2) * ((Rte @ inner) * Rte).sum(axis=-1)
        return mean, jnp.maximum(var, 1e-8)
