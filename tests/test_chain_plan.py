"""Differential tests: sort-chain plan vs join plan (and via it, vs dense).

The join plan (build_plan_join/apply_plan_join) is itself validated against
dense O(n^2) kernels and the native C++ golden model (test_lattice.py,
test_cpu_ref.py); here the chain engine -- the production path -- is held
to the join engine at float precision on the same (src, ref, coeffs), across
dimensions, orders, and kernels, plus property checks of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simplex_gp_tpu.ops import kernels, lattice


def _data(n, d, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(n, c)).astype(np.float32))
    return x, v


@pytest.mark.parametrize(
    "n,d,order,kernel",
    [
        (200, 1, 1, "rbf"),
        (300, 3, 1, "rbf"),
        (257, 5, 2, "rbf"),
        (150, 2, 3, "matern"),
        (400, 9, 1, "matern"),
        (64, 17, 1, "rbf"),
    ],
)
def test_chain_matches_join(n, d, order, kernel):
    dk = kernels.rbf_kernel(order) if kernel == "rbf" else kernels.matern_kernel(1.5, order)
    x, v = _data(n, d)
    pj = lattice.build_plan_join(x, dk.coeffs, dk.variance)
    aj = np.asarray(lattice.apply_plan_join(pj, v, dk.coeffs))
    pc = lattice.build_plan_chain(x, dk.coeffs, dk.variance)
    ac = np.asarray(lattice.apply_plan_chain(pc, v, dk.coeffs))
    rel = np.linalg.norm(ac - aj) / np.linalg.norm(aj)
    assert rel < 2e-5, rel
    assert int(pc.n_lattice) == int(pj.n_lattice)


def test_chain_is_default_plan():
    dk = kernels.rbf_kernel(1)
    x, v = _data(128, 4)
    plan = lattice.build_plan(x, dk.coeffs, dk.variance)
    assert isinstance(plan, lattice.ChainPlan)
    out = lattice.apply_plan(plan, v, dk.coeffs)
    ref = lattice.apply_plan_chain(plan, v, dk.coeffs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref))


def test_chain_symmetry_matches_join():
    """The operator's (small) asymmetry is the blur-axis commutator, inherent
    to the splat->sequential-axis-blurs->slice algorithm (the reference has
    it too: bilateral_kernel.py:111 treats K as symmetric).  The chain engine
    must reproduce the join engine's quadratic forms exactly -- same operator,
    same commutator."""
    dk = kernels.rbf_kernel(1)
    x, _ = _data(300, 4)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.normal(size=(300, 1)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(300, 1)).astype(np.float32))

    def forms(bp, ap):
        plan = bp(x, dk.coeffs, dk.variance)
        Ku = ap(plan, u, dk.coeffs)
        Kv = ap(plan, v, dk.coeffs)
        return float((u * Kv).sum()), float((v * Ku).sum())

    cj = forms(lattice.build_plan_join, lattice.apply_plan_join)
    cc = forms(lattice.build_plan_chain, lattice.apply_plan_chain)
    np.testing.assert_allclose(cc, cj, rtol=1e-5)


def test_chain_linearity():
    dk = kernels.rbf_kernel(2)
    x, _ = _data(200, 3)
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.normal(size=(200, 2)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(200, 2)).astype(np.float32))
    plan = lattice.build_plan_chain(x, dk.coeffs, dk.variance)
    lhs = lattice.apply_plan_chain(plan, 2.0 * u - 3.0 * v, dk.coeffs)
    rhs = 2.0 * lattice.apply_plan_chain(plan, u, dk.coeffs) - 3.0 * lattice.apply_plan_chain(
        plan, v, dk.coeffs
    )
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), rtol=1e-4, atol=1e-5)


def test_chain_grad_matches_join_grad():
    """Reverse-mode AD through the chain pipeline (sorts/cumsum/gathers) must
    agree with AD through the join pipeline (segment_sum/gathers): both
    differentiate the same math w.r.t. src and ref (through the barycentric
    weights)."""
    dk = kernels.rbf_kernel(1)
    x, v = _data(120, 3, c=1, seed=3)

    def loss_chain(xx, vv):
        p = lattice.build_plan_chain(xx, dk.coeffs, dk.variance)
        return (lattice.apply_plan_chain(p, vv, dk.coeffs) ** 2).sum()

    def loss_join(xx, vv):
        p = lattice.build_plan_join(xx, dk.coeffs, dk.variance)
        return (lattice.apply_plan_join(p, vv, dk.coeffs) ** 2).sum()

    gx_c, gv_c = jax.grad(loss_chain, argnums=(0, 1))(x, v)
    gx_j, gv_j = jax.grad(loss_join, argnums=(0, 1))(x, v)
    np.testing.assert_allclose(np.asarray(gv_c), np.asarray(gv_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gx_c), np.asarray(gx_j), rtol=1e-3, atol=1e-4)


def test_chunked_build_matches_fused(monkeypatch):
    """The houseelectric-scale chunked mid-axes plan build (lax.map, one axis
    per step) must produce an identical plan to the fused batched sort."""
    import numpy as np
    import jax.numpy as jnp

    import simplex_gp_tpu.ops.lattice as lat

    dk_coeffs = (0.5, 1.0, 0.5)
    var = 0.125
    rng = np.random.default_rng(33)
    x = jnp.asarray(rng.normal(size=(300, 5)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(300, 2)), jnp.float32)

    fused = lat.build_plan_chain(x, dk_coeffs, var)
    monkeypatch.setattr(lat, "_FUSED_BUILD_MAX_ROWS", 0)
    lat.build_plan_chain.clear_cache()
    try:
        chunked = lat.build_plan_chain(x, dk_coeffs, var)
        for f, c in zip(fused, chunked):
            np.testing.assert_array_equal(np.asarray(f), np.asarray(c))
        out_f = lat.apply_plan_chain(fused, v, dk_coeffs)
        out_c = lat.apply_plan_chain(chunked, v, dk_coeffs)
        np.testing.assert_allclose(np.asarray(out_f), np.asarray(out_c), rtol=1e-6)
    finally:
        lat.build_plan_chain.clear_cache()


def test_capacity_trim_exact_and_overflow_guard():
    """A sufficient capacity gives bit-identical output; an UNDERSIZED
    capacity must poison the output with NaN rather than silently corrupt it
    (the r2 advisor's medium finding: lengthscale drift during training can
    push occupancy past a capacity measured at init)."""
    dk = kernels.rbf_kernel(1)
    x, v = _data(400, 5, c=2, seed=7)

    full = lattice.build_plan_chain(x, dk.coeffs, dk.variance)
    n_lat = int(full.n_lattice)
    out_full = np.asarray(lattice.apply_plan_chain(full, v, dk.coeffs))

    trimmed = lattice.build_plan_chain(x, dk.coeffs, dk.variance, capacity=n_lat + 8)
    assert int(trimmed.n_lattice) == n_lat
    out_trim = np.asarray(lattice.apply_plan_chain(trimmed, v, dk.coeffs))
    np.testing.assert_allclose(out_trim, out_full, rtol=1e-6, atol=1e-6)

    under = lattice.build_plan_chain(x, dk.coeffs, dk.variance, capacity=max(8, n_lat // 2))
    assert int(under.n_lattice) == n_lat  # occupancy is still reported truthfully
    out_under = np.asarray(lattice.apply_plan_chain(under, v, dk.coeffs))
    assert np.isnan(out_under).all()


def test_searchsorted_compaction_matches_sort_path():
    """The binary-search leader compaction (used when the trimmed capacity is
    a small fraction of the contribution count -- the precipitation regime)
    must agree with the full-M compaction sort in both the plan build and the
    fused one-shot filter."""
    dk = kernels.rbf_kernel(1)
    rng = np.random.default_rng(11)
    # Low-occupancy geometry: many points share few lattice cells.
    base = rng.normal(size=(60, 3)).astype(np.float32)
    x = jnp.asarray(base[rng.integers(0, 60, size=4096)] + 1e-3 * rng.normal(size=(4096, 3)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(4096, 2)).astype(np.float32))

    full = lattice.build_plan_chain(x, dk.coeffs, dk.variance)  # sort path (Mc == M)
    n_lat = int(full.n_lattice)
    cap = -(-int(n_lat * 1.25) // 128) * 128
    M = x.shape[0] * (x.shape[1] + 1)
    assert cap <= lattice._COMPACT_SEARCH_MAX_MC and M >= lattice._COMPACT_SEARCH_MIN_RATIO * cap, (
        "test geometry no longer triggers the searchsorted compaction path"
    )
    trimmed = lattice.build_plan_chain(x, dk.coeffs, dk.variance, capacity=cap)
    assert int(trimmed.n_lattice) == n_lat
    out_full = np.asarray(lattice.apply_plan_chain(full, v, dk.coeffs))
    out_trim = np.asarray(lattice.apply_plan_chain(trimmed, v, dk.coeffs))
    np.testing.assert_allclose(out_trim, out_full, rtol=1e-6, atol=1e-6)

    fused = np.asarray(lattice.filter_fused(v, x, dk.coeffs, dk.variance, capacity=cap))
    np.testing.assert_allclose(fused, out_full, rtol=1e-5, atol=1e-6)

    # Undersized capacity must still poison with NaN through the search path.
    if n_lat >= 2:
        under = np.asarray(
            lattice.filter_fused(v, x, dk.coeffs, dk.variance, capacity=max(8, n_lat // 2))
        )
        assert np.isnan(under).all()


@pytest.mark.parametrize(
    "n,d,order,c",
    [(300, 3, 1, 1), (257, 5, 2, 3), (64, 17, 1, 2), (200, 1, 1, 1)],
)
def test_fused_filter_matches_plan_path(n, d, order, c):
    """filter_fused (the one-shot rebuild-every-MVM engine) applies the SAME
    operator as build_plan_chain + apply_plan_chain: identical axis order and
    summation order, differing only under 64-bit hash collisions."""
    dk = kernels.rbf_kernel(order)
    x, v = _data(n, d, c=c)
    plan = lattice.build_plan_chain(x, dk.coeffs, dk.variance)
    ref = np.asarray(lattice.apply_plan_chain(plan, v, dk.coeffs))
    fused = np.asarray(lattice.filter_fused(v, x, dk.coeffs, dk.variance))
    np.testing.assert_allclose(fused, ref, rtol=1e-5, atol=1e-6)

    nl = int(plan.n_lattice)
    trimmed = np.asarray(
        lattice.filter_fused(v, x, dk.coeffs, dk.variance, capacity=nl + 8)
    )
    np.testing.assert_allclose(trimmed, ref, rtol=1e-5, atol=1e-6)
    if nl >= 2:  # capacity nl-1 is guaranteed undersized
        under = np.asarray(
            lattice.filter_fused(v, x, dk.coeffs, dk.variance, capacity=nl - 1)
        )
        assert np.isnan(under).all()


def test_fused_grad_matches_plan_path():
    """Plain autodiff through filter_fused (sorts/cumsums/gathers all the
    way down) must produce the same value AND position gradients as the
    build+apply chain path -- this licenses routing the one-shot callers
    (custom-vjp backward, rect prediction MVM) through the fused engine."""
    dk = kernels.rbf_kernel(1)
    x, v = _data(150, 4, c=2, seed=3)

    def loss_plan(xx, vv):
        p = lattice.build_plan_chain(xx, dk.coeffs, dk.variance)
        return (lattice.apply_plan_chain(p, vv, dk.coeffs) ** 2).sum()

    def loss_fused(xx, vv):
        return (lattice.filter_fused(vv, xx, dk.coeffs, dk.variance) ** 2).sum()

    gx_p, gv_p = jax.grad(loss_plan, argnums=(0, 1))(x, v)
    gx_f, gv_f = jax.grad(loss_fused, argnums=(0, 1))(x, v)
    np.testing.assert_allclose(np.asarray(gv_f), np.asarray(gv_p), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gx_f), np.asarray(gx_p), rtol=1e-3, atol=1e-4)
