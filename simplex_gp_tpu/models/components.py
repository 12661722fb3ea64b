"""Mean functions, likelihood, and parameter constraints.

JAX equivalents of the GPyTorch pieces the reference composes its
models from (SURVEY.md section 2.4): ConstantMean, ScaleKernel outputscale,
ARD lengthscales, GaussianLikelihood with a GreaterThan(min_noise) constraint
(train_simplexgp.py:15-21).  Everything is functional: raw (unconstrained)
parameters live in plain dicts and are mapped through softplus transforms, so
the whole model is a pytree jax.grad can traverse.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["softplus", "inv_softplus", "constrain", "init_raw_params"]


def softplus(x):
    return jnp.logaddexp(x, 0.0)


def inv_softplus(y):
    # inverse of softplus for y > 0
    return jnp.log(jnp.expm1(jnp.maximum(y, 1e-8)))


def constrain(raw: dict, min_noise: float) -> dict:
    """Map raw parameters to the positive quantities the kernel consumes.

    GPyTorch convention: lengthscale/outputscale through softplus (Positive
    constraint), noise through softplus shifted by the GreaterThan floor
    (reference train_simplexgp.py:15-16).
    """
    return {
        "inv_ell": 1.0 / softplus(raw["raw_lengthscale"]),
        "outputscale": softplus(raw["raw_outputscale"]),
        "noise": min_noise + softplus(raw["raw_noise"]),
        "mean": raw["mean"],
    }


def init_raw_params(
    num_dims: int,
    lengthscale: float = 0.6931,
    outputscale: float = 0.6931,
    noise: float = 0.6931,
    mean: float = 0.0,
) -> dict:
    """Raw parameters matching GPyTorch's defaults (softplus(0) = 0.6931)."""
    return {
        "raw_lengthscale": jnp.full((num_dims,), inv_softplus(jnp.float32(lengthscale)), jnp.float32),
        "raw_outputscale": jnp.asarray(inv_softplus(jnp.float32(outputscale)), jnp.float32),
        "raw_noise": jnp.asarray(inv_softplus(jnp.float32(noise)), jnp.float32),
        "mean": jnp.float32(mean),
    }
