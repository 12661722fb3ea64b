"""End-to-end Snelson 1-D parity test -- the canonical verification.

JAX mirror of the reference's `tests/train_snelson.py` (documented as
THE verification at README.md:97-105): train a Simplex-GP (RBF lattice,
order=1) and a dense exact GP for 100 Adam epochs at lr=0.1 on the raw
Snelson data and assert the final train MLLs agree within 0.1
(train_snelson.py:96).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simplex_gp_tpu import BBMMConfig, DenseGP, SimplexGP
from simplex_gp_tpu.utils import fit_adam, load_snelson


@pytest.fixture(scope="module")
def snelson():
    x, y = load_snelson()
    return jnp.asarray(x), jnp.asarray(y)


def test_snelson_mll_parity(snelson):
    x, y = snelson

    simplex = SimplexGP(
        num_dims=1,
        kernel="rbf",
        order=1,
        min_noise=1e-4,
        bbmm=BBMMConfig(
            cg_tolerance=1e-4,
            max_cg_iterations=500,
            max_lanczos_iterations=100,
            num_probes=10,
        ),
    )
    raw_s, hist_s = fit_adam(
        lambda raw, key: simplex.nlml(raw, x, y, key),
        simplex.init_params(),
        epochs=100,
        lr=0.1,
    )

    dense = DenseGP(num_dims=1, kernel="rbf", min_noise=1e-4)
    raw_d, hist_d = fit_adam(
        lambda raw, key: dense.nlml(raw, x, y, key),
        dense.init_params(),
        epochs=100,
        lr=0.1,
    )

    # Final train MLL (positive, per datapoint), evaluated with a fresh key.
    key = jax.random.PRNGKey(123)
    mll_simplex = -float(simplex.nlml(raw_s, x, y, key))
    mll_dense = -float(dense.nlml(raw_d, x, y))
    delta = abs(mll_simplex - mll_dense)
    assert delta < 0.1, f"Simplex MLL {mll_simplex:.4f} vs dense {mll_dense:.4f} (delta {delta:.4f})"


def test_snelson_prediction_quality(snelson):
    # Posterior predictions on held-out points: train on even indices,
    # predict odd; lattice predictions should track the dense exact GP.
    x, y = snelson
    xt, yt = x[::2], y[::2]
    xe, ye = x[1::2], y[1::2]

    simplex = SimplexGP(num_dims=1, kernel="rbf", order=1, min_noise=1e-4,
                        bbmm=BBMMConfig(cg_tolerance=1e-4, max_lanczos_iterations=100))
    raw, _ = fit_adam(lambda r, k: simplex.nlml(r, xt, yt, k), simplex.init_params(), epochs=60, lr=0.1)
    mean, var = simplex.predict(raw, xt, yt, xe, jax.random.PRNGKey(0))

    rmse = float(jnp.sqrt(((mean - ye) ** 2).mean()))
    assert rmse < 0.35, f"Snelson held-out RMSE {rmse}"
    assert np.all(np.asarray(var) > 0)
    # Calibration sanity: most held-out residuals within 3 sigma.
    z = np.abs(np.asarray(mean - ye)) / np.sqrt(np.asarray(var))
    assert (z < 3).mean() > 0.9


def test_love_variance_matches_dense_lattice_posterior():
    """VERDICT item 7: the fast-predictive-variance cache (randomized rank-m
    root, the fast_pred_var analogue) must reproduce the DENSE posterior of
    the same lattice operator -- isolating LOVE quality from the lattice
    discretization error -- to ~15% relative on most points."""
    import jax
    import jax.numpy as jnp

    from simplex_gp_tpu import BBMMConfig, SimplexGP
    from simplex_gp_tpu.ops.filter import lattice_filter_rect
    from simplex_gp_tpu.ops.lattice import apply_plan, build_plan

    n, n_test, d = 1024, 128, 2
    rng = np.random.default_rng(21)
    x = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    y = jnp.asarray(np.sin(2 * np.asarray(x[:, 0])) + 0.3 * rng.normal(size=n), jnp.float32)
    x_test = jnp.asarray(rng.normal(size=(n_test, d)), jnp.float32)

    model = SimplexGP(
        num_dims=d, kernel="rbf", order=1,
        bbmm=BBMMConfig(cg_tolerance=1e-4, max_cg_iterations=400,
                        max_lanczos_iterations=128, num_probes=8),
        eval_cg_tolerance=1e-4,
    )
    raw = model.init_params()
    mean_fast, var_fast = model.predict(raw, x, y, x_test, jax.random.PRNGKey(3))

    # Dense posterior of the SAME operator: materialize Khat and the cross
    # block through the identical filter pipeline.
    params = model.constrained(raw)
    s, noise = params["outputscale"], params["noise"]
    ref = x * params["inv_ell"]
    ref_t = x_test * params["inv_ell"]
    plan = build_plan(ref, model.dk.coeffs, model.dk.variance)
    Khat = s * np.asarray(apply_plan(plan, jnp.eye(n, dtype=jnp.float32), model.dk.coeffs))
    Khat = 0.5 * (Khat + Khat.T) + float(noise) * np.eye(n)
    Kst = s * np.asarray(
        lattice_filter_rect(jnp.eye(n, dtype=jnp.float32), ref, ref_t, model.dk)
    )  # (n_test, n)

    yc = np.asarray(y) - float(params["mean"])
    sol = np.linalg.solve(Khat, yc)
    mean_dense = Kst @ sol + float(params["mean"])
    var_dense = (
        float(s) + float(noise)
        - np.einsum("tn,nm,tm->t", Kst, np.linalg.inv(Khat), Kst)
    )

    np.testing.assert_allclose(np.asarray(mean_fast), mean_dense, rtol=0.05, atol=0.02)
    rel = np.abs(np.asarray(var_fast) - var_dense) / np.abs(var_dense)
    assert np.median(rel) < 0.10, float(np.median(rel))
    assert np.quantile(rel, 0.9) < 0.20, float(np.quantile(rel, 0.9))
