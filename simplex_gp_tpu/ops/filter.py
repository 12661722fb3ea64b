"""Differentiable lattice filter: the autograd bridge (reference L2).

``lattice_filter(src, ref, dk)`` computes ``K(ref, ref) @ src`` via the
permutohedral filter and is differentiable w.r.t. both ``src`` and ``ref``,
mirroring ``LatticeFilterGeneral`` (reference bilateral_kernel.py:59-124):

  * grad_source: one more forward filter of the cotangent (K treated as
    symmetric, reference :111);
  * grad_reference: ONE fused filter call with the *derivative* coefficients
    over the concatenation [g, g*ref, src, src*ref] (n x (2L + 2Ld)), then the
    product-rule combination (reference :112-123).

Deliberate behavioral fixes over the reference (documented divergences):

  1. The reference multiplies the derivative-filter combination by the
     hardcoded constant -2 (bilateral_kernel.py:122).  Because the derivative
     taps are center-normalized by k'(0), the correct constant is 2*k'(0),
     which is -2 only for RBF (k'(0) = -1).  We use ``2 * dk.dk0``
     (k'(0) = -3/2 for Matern nu=1.5, -5/6 for nu=2.5).
  2. When both grads are needed the reference reuses the derivative-filter
     output ``wg`` as grad_source (bilateral_kernel.py:123) -- exact only for
     RBF where the normalized derivative taps equal the forward taps.  We
     always compute grad_source with the forward coefficients.

Second-order autograd is not defined (same as the reference, :101); the BBMM
engine only needs first-order VJPs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .kernels import DiscretizedKernel, MixtureKernel
from .lattice import apply_plan, apply_plan_join, build_plan, build_plan_join

__all__ = [
    "lattice_filter",
    "lattice_filter_exact_grad",
    "lattice_filter_any",
    "make_wide_filter",
    "make_wide_filter_any",
    "build_plan_any",
    "apply_plan_any",
]

# Chain-plan transition sorts carry EVERY value column as a sort operand,
# so their compile and run time grow with the column count.  Above this
# width the gather-join engine (column-count-independent) is used.  The
# value is untuned on the H100.
_WIDE_COLS = 16

# The join engine materializes (table_rows, c) arrays (segment_sum output,
# blurred table, (n, d+1, c) slice gather); above this many n*(d+1) rows a
# wide filter instead builds ONE chain plan and lax.maps over 8-column
# chunks -- bounded memory at any n (the houseelectric eval regime, where
# a c=100 join table would be ~6-8 GB).  Untuned on the H100.
_JOIN_MAX_ROWS = 4 * 1024 * 1024
_WIDE_CHUNK = 8


def lattice_filter_wide_chunked(
    src: jax.Array, ref: jax.Array, dk: DiscretizedKernel,
    capacity: "int | None" = None,
) -> jax.Array:
    """K(ref, ref) @ src for wide ``src`` at very large n: chunked chain plan.

    Builds the sort-chain plan once and applies it to ``_WIDE_CHUNK``-column
    blocks under ``lax.map`` (one traced apply, sequential execution), so
    peak memory is the plan plus one narrow block -- independent of the
    total column count.  Differentiable by plain autodiff like the other
    engines (sorts/gathers contribute no tangent).
    """
    n, c = src.shape
    plan = build_plan(ref, dk.coeffs, dk.variance, capacity=capacity)
    g = -(-c // _WIDE_CHUNK)
    pad = g * _WIDE_CHUNK - c
    v = jnp.concatenate([src, jnp.zeros((n, pad), src.dtype)], axis=1) if pad else src
    blocks = jnp.moveaxis(v.reshape(n, g, _WIDE_CHUNK), 1, 0)  # (g, n, chunk)
    out = jax.lax.map(lambda b: apply_plan(plan, b, dk.coeffs), blocks)
    return jnp.moveaxis(out, 0, 1).reshape(n, g * _WIDE_CHUNK)[:, :c]


def make_wide_filter(
    ref: jax.Array, dk: DiscretizedKernel, capacity: "int | None" = None
):
    """Reusable ``mv(V) -> K(ref, ref) @ V`` closure for WIDE value blocks.

    Builds the plan ONCE and closes over it, keeping ``_filter_plain``'s
    engine dispatch for wide sources (join engine at moderate n, chunked
    chain plan above ``_JOIN_MAX_ROWS``) without rebuilding the plan on
    every call -- the LOVE range-sketch in models/exact_gp.py calls the wide
    MVM twice per cache build, and on the host path each chain-plan rebuild
    at houseelectric scale costs seconds (r4 advisor finding).
    """
    if ref.shape[0] * (ref.shape[-1] + 1) > _JOIN_MAX_ROWS:
        plan = build_plan(ref, dk.coeffs, dk.variance, capacity=capacity)

        def mv(src: jax.Array) -> jax.Array:
            n, c = src.shape
            g = -(-c // _WIDE_CHUNK)
            pad = g * _WIDE_CHUNK - c
            v = (
                jnp.concatenate([src, jnp.zeros((n, pad), src.dtype)], axis=1)
                if pad
                else src
            )
            blocks = jnp.moveaxis(v.reshape(n, g, _WIDE_CHUNK), 1, 0)
            out = jax.lax.map(lambda b: apply_plan(plan, b, dk.coeffs), blocks)
            return jnp.moveaxis(out, 0, 1).reshape(n, g * _WIDE_CHUNK)[:, :c]

        return mv
    jplan = build_plan_join(ref, dk.coeffs, dk.variance)
    return lambda src: apply_plan_join(jplan, src, dk.coeffs)


def _filter_plain(
    src: jax.Array, ref: jax.Array, dk: DiscretizedKernel,
    capacity: "int | None" = None,
) -> jax.Array:
    """One filter application, engine chosen by value width (static).

    Narrow values use the fused one-shot engine (ops/lattice.py
    filter_fused: fewer sort passes than build+apply for single-shot use,
    and its plain-autodiff gradients match the plan path --
    tests/test_chain_plan.py::test_fused_grad_matches_plan_path).  These
    one-shot callers are the custom-vjp backward's u^T dK v evaluation and
    the rectangular prediction MVM; the CG/SLQ forward reuses ONE prebuilt
    plan instead (linalg/mll.py)."""
    if src.shape[-1] > _WIDE_COLS:
        if src.shape[0] * (ref.shape[-1] + 1) > _JOIN_MAX_ROWS:
            return lattice_filter_wide_chunked(src, ref, dk, capacity=capacity)
        plan = build_plan_join(ref, dk.coeffs, dk.variance)
        return apply_plan_join(plan, src, dk.coeffs)
    from .lattice import filter_fused

    return filter_fused(src, ref, dk.coeffs, dk.variance, capacity=capacity)


def lattice_filter_exact_grad(
    src: jax.Array, ref: jax.Array, dk: DiscretizedKernel,
    capacity: "int | None" = None,
) -> jax.Array:
    """K(ref, ref) @ src, differentiable by PLAIN JAX autodiff.

    The reference cannot differentiate through its hash-table C++ filter, so
    it approximates grad_reference with a second filter using derivative
    coefficients (bilateral_kernel.py:112-123) -- an estimate of the *dense*
    kernel's gradient that can disagree in sign with the gradient of the
    actual discretized operator when the model is near a lengthscale optimum.

    Our pipeline is segment_sum/gather/elementwise all the way down, and the
    barycentric weights are (piecewise) smooth in ``ref``, so reverse-mode AD
    through splat -> blur -> slice yields the EXACT gradient of the operator
    actually being applied (validated against finite differences).  Integer
    lattice bookkeeping (keys, sort, neighbor indices) is piecewise constant
    and contributes no tangent.  This is the default gradient path for
    hyperparameter training; ``lattice_filter`` keeps reference-parity
    derivative-filter gradients.
    """
    return _filter_plain(src, ref, dk, capacity=capacity)


def lattice_filter_any(src, ref, dk, capacity=None) -> jax.Array:
    """K(ref, ref) @ src for a DiscretizedKernel OR MixtureKernel.

    Differentiable by plain autodiff (exact operator gradients) in both
    cases.  A mixture is one RBF-lattice filter per component at scaled
    positions ``ref * alpha_j``, combined with the static nonnegative
    weights (ops/kernels.py MixtureKernel) -- PSD by construction.
    ``capacity`` applies to single-kernel plans only: component occupancies
    differ with alpha, so mixture plans use the untrimmed bound.
    """
    if isinstance(dk, MixtureKernel):
        out = None
        for w, a in zip(dk.weights, dk.alphas):
            term = w * _filter_plain(src, ref * a, dk.base)
            out = term if out is None else out + term
        return out
    return _filter_plain(src, ref, dk, capacity=capacity)


def build_plan_any(ref, dk, capacity=None):
    """Prebuilt reusable plan(s) for ``dk``: one ChainPlan, or a tuple of
    per-component plans for a MixtureKernel.  Pair with :func:`apply_plan_any`."""
    if isinstance(dk, MixtureKernel):
        return tuple(
            build_plan(ref * a, dk.base.coeffs, dk.base.variance) for a in dk.alphas
        )
    return build_plan(ref, dk.coeffs, dk.variance, capacity=capacity)


def apply_plan_any(plan, V, dk, axis_name=None):
    """Apply plan(s) from :func:`build_plan_any`: K @ V (no outputscale/noise)."""
    if isinstance(dk, MixtureKernel):
        out = None
        for w, p in zip(dk.weights, plan):
            term = w * apply_plan(p, V, dk.base.coeffs, axis_name=axis_name)
            out = term if out is None else out + term
        return out
    return apply_plan(plan, V, dk.coeffs, axis_name=axis_name)


def make_wide_filter_any(ref, dk, capacity=None):
    """``mv(V) -> K @ V`` closure over prebuilt plan(s), wide-source safe."""
    if isinstance(dk, MixtureKernel):
        mvs = [make_wide_filter(ref * a, dk.base) for a in dk.alphas]

        def mv(src: jax.Array) -> jax.Array:
            out = None
            for w, f in zip(dk.weights, mvs):
                term = w * f(src)
                out = term if out is None else out + term
            return out

        return mv
    return make_wide_filter(ref, dk, capacity=capacity)


def lattice_filter_rect(
    src: jax.Array, x_from: jax.Array, x_to: jax.Array, dk
) -> jax.Array:
    """Cross-covariance MVM ``K(x_to, x_from) @ src`` via the zero-pad trick.

    Joint-filters ``[src; 0]`` over the concatenated positions
    ``[x_from; x_to]`` and keeps the x_to rows -- the reference's
    RectangularLazyLattice._matmul (bilateral_kernel.py:150-156), used for
    test-time prediction.
    """
    n_from = x_from.shape[0]
    x_large = jnp.concatenate([x_from, x_to], axis=0)
    v_large = jnp.concatenate(
        [src, jnp.zeros((x_to.shape[0], src.shape[-1]), src.dtype)], axis=0
    )
    return lattice_filter_any(v_large, x_large, dk)[n_from:]


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def lattice_filter(src: jax.Array, ref: jax.Array, dk: DiscretizedKernel) -> jax.Array:
    """K(ref, ref) @ src for the discretized stationary kernel ``dk``.

    Args:
      src: (n, L) float values to filter.
      ref: (n, d) float positions (already divided by lengthscales).
      dk: static DiscretizedKernel (hashable; passed as nondiff argnum).

    Returns:
      (n, L) filtered output, approximately ``K @ src`` with unit diagonal.
    """
    return _filter_plain(src, ref, dk)


def _fwd(src, ref, dk):
    out = lattice_filter(src, ref, dk)
    return out, (src, ref)


def _bwd(dk, residuals, g):
    src, ref = residuals
    n, L = src.shape
    d = ref.shape[-1]

    # grad_source: K^T g = K g (symmetric up to blur-axis commutator error).
    grad_src = lattice_filter(g, ref, dk)

    # grad_reference: fused derivative filter over [g, g x ref, src, src x ref].
    gf = g[:, :, None] * ref[:, None, :]  # (n, L, d)
    sf = src[:, :, None] * ref[:, None, :]
    stacked = jnp.concatenate(
        [g, gf.reshape(n, L * d), src, sf.reshape(n, L * d)], axis=-1
    )
    # Join plan here: ``stacked`` has 2L(1+d) columns, and the chain plan's
    # transition sorts carry every column as a sort operand (gathers in the
    # join plan are column-count-independent; see apply_plan_chain docstring).
    dplan = build_plan_join(ref, dk.deriv_coeffs, dk.deriv_variance)
    filtered = apply_plan_join(dplan, stacked, dk.deriv_coeffs)
    wg = filtered[:, :L]
    wgf = filtered[:, L : L + L * d].reshape(n, L, d)
    ws = filtered[:, L + L * d : 2 * L + L * d]
    wsf = filtered[:, 2 * L + L * d :].reshape(n, L, d)

    grad_ref = (2.0 * dk.dk0) * (
        sf * wg[:, :, None]
        - src[:, :, None] * wgf
        + gf * ws[:, :, None]
        - g[:, :, None] * wsf
    ).sum(axis=1)
    return grad_src, grad_ref


lattice_filter.defvjp(_fwd, _bwd)
