"""Stationary kernel functions (of squared distance) and their discretizations.

Each kernel is provided twice: a numpy form (used once, on host, by the
coefficient search in :mod:`coeffs`) and analytic facts needed by the filter
VJP (the derivative of the kernel w.r.t. squared distance at zero).

Behavioral parity target: reference ``bilateral_kernel.py:202-254``
(``rbf``, ``matern``, ``Matern`` autograd Function, ``DiscretizedKernelFN``).
The Matern derivative is written in its closed form (which is finite at
tau=0 for nu >= 1.5), sidestepping the non-differentiable sqrt(d^2) that the
reference handles with a hand-written backward (``bilateral_kernel.py:205-232``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from .coeffs import get_coeffs, tap_variance

__all__ = [
    "DiscretizedKernel",
    "MixtureKernel",
    "rbf_kernel",
    "matern_kernel",
    "mixture_kernel",
    "fit_mixture_weights_subset",
    "kernel_value_jnp",
]


def _rbf(d2: np.ndarray) -> np.ndarray:
    return np.exp(-d2)


def _rbf_deriv(d2: np.ndarray) -> np.ndarray:
    # d/dz exp(-z) = -exp(-z)
    return -np.exp(-d2)


def _matern(d2: np.ndarray, nu: float) -> np.ndarray:
    d = np.sqrt(np.abs(d2))
    exp_component = np.exp(-np.sqrt(2 * nu) * d)
    if nu == 0.5:
        poly = 1.0
    elif nu == 1.5:
        poly = np.sqrt(3) * d + 1.0
    elif nu == 2.5:
        poly = np.sqrt(5) * d + 1.0 + (5.0 / 3.0) * d**2
    else:
        raise NotImplementedError(f"Matern nu={nu} not supported (use 0.5, 1.5, 2.5)")
    return poly * exp_component


def _matern_deriv(d2: np.ndarray, nu: float) -> np.ndarray:
    """d/dz matern(z, nu) evaluated at z = d2 (closed form, finite at 0 for nu>=1.5)."""
    d = np.sqrt(np.abs(d2))
    exp_component = np.exp(-np.sqrt(2 * nu) * d)
    if nu == 1.5:
        poly = -1.5
    elif nu == 2.5:
        poly = -(5.0 / 6.0) * (1.0 + np.sqrt(5) * d)
    else:
        raise NotImplementedError(f"Matern derivative for nu={nu} not supported")
    return poly * exp_component


@dataclasses.dataclass(frozen=True)
class DiscretizedKernel:
    """A stationary kernel discretized to (2*order+1) filter taps.

    Instances are hashable (taps stored as float tuples) so they can be
    closed over / passed as static arguments to jitted functions.

    Attributes:
      name: human-readable kernel name.
      order: filter order r; the blur has 2r+1 taps.
      coeffs: forward filter taps, center-normalized, tuple of 2r+1 floats.
      deriv_coeffs: taps of dk/d(d^2), center-normalized, tuple of 2r+1 floats.
      dk0: dk/d(d^2) at d^2=0 -- the true (signed) scale of the derivative
        kernel, lost by center-normalization.  The filter VJP multiplies the
        derivative-filter output by ``2*dk0``; the reference hardcodes -2
        (exact for RBF where dk0=-1; see bilateral_kernel.py:122).
      variance / deriv_variance: discrete tap variances, used to calibrate
        the lattice scale factors (permutohedral.h:388-389).
    """

    name: str
    order: int
    coeffs: tuple
    deriv_coeffs: tuple
    dk0: float
    variance: float
    deriv_variance: float
    nu: float = 0.0  # Matern smoothness; 0.0 for RBF

    @staticmethod
    def build(name: str, kernel_fn, deriv_fn, order: int, nu: float = 0.0) -> "DiscretizedKernel":
        coeffs = get_coeffs(lambda tau: kernel_fn(tau**2), order)
        deriv_coeffs = get_coeffs(lambda tau: deriv_fn(tau**2), order)
        dk0 = float(deriv_fn(np.zeros(1))[0])
        return DiscretizedKernel(
            name=name,
            order=order,
            coeffs=tuple(float(c) for c in coeffs),
            deriv_coeffs=tuple(float(c) for c in deriv_coeffs),
            dk0=dk0,
            variance=tap_variance(coeffs),
            deriv_variance=tap_variance(deriv_coeffs),
            nu=nu,
        )


@functools.lru_cache(maxsize=None)
def rbf_kernel(order: int = 2) -> DiscretizedKernel:
    """Discretized RBF kernel k(d^2) = exp(-d^2) (reference RBFLattice default order=2)."""
    return DiscretizedKernel.build("rbf", _rbf, _rbf_deriv, order)


@functools.lru_cache(maxsize=None)
def matern_kernel(nu: float = 1.5, order: int = 3) -> DiscretizedKernel:
    """Discretized Matern kernel, nu in {1.5, 2.5} (reference MaternLattice default order=3)."""
    return DiscretizedKernel.build(
        f"matern{nu}",
        lambda d2: _matern(d2, nu),
        lambda d2: _matern_deriv(d2, nu),
        order,
        nu=nu,
    )


@dataclasses.dataclass(frozen=True)
class MixtureKernel:
    """Gaussian-mixture discretization of a stationary kernel.

    Matern kernels are scale mixtures of Gaussians; the permutohedral lattice
    is most accurate for Gaussians (it is designed for them), so approximating

        k(r)  ~=  sum_j  w_j * exp(-(alpha_j * r)^2),   w_j >= 0

    and filtering each component with the plain RBF lattice at scaled
    positions ``ref * alpha_j`` replaces the matern tap profile's
    discretization error with the (much smaller) RBF floor per component.
    Measured on elevators-geometry d=18 (analysis/QUALITY_GAP.md):
    matern nu=1.5 taps rel_err 0.178 at n=2048 vs 0.105 for the mixture --
    and 0.467 at n=16599 for the reference-parity taps (BASELINE.md:22 shows
    the reference's own filter has the same profile).  This is an accuracy
    mode the reference does NOT have.

    Nonnegative weights keep every component PSD, so the mixture operator is
    PSD by construction -- CG/SLQ stay well-posed.

    Cost: one lattice apply per component (J plans built per loss eval,
    J applies per MVM).  Static/hashable like DiscretizedKernel, so it
    drops into the same static-argument slots; ``weights`` are fit on host
    at construction (profile NNLS) or refit against a dense subset operator
    (:func:`fit_mixture_weights_subset`).
    """

    name: str
    order: int
    alphas: tuple  # per-component inverse-lengthscale multipliers
    weights: tuple  # nonnegative mixture weights, sum-normalized at k(0)=1
    base: DiscretizedKernel  # shared RBF taps (components differ by ref scale)
    nu: float = 1.5  # target matern smoothness (0.0 = target was RBF-like)

    @property
    def coeffs(self):  # parity with DiscretizedKernel for generic logging
        return self.base.coeffs

    @property
    def variance(self):
        return self.base.variance


def _fit_profile_weights(
    kernel_fn, alphas: np.ndarray, r_max: float = 8.0, n_grid: int = 512
) -> np.ndarray:
    """Nonnegative LSQ fit of ``kernel_fn(r^2)`` by sum_j w_j exp(-(a_j r)^2).

    Frobenius-style weighting: for random v, E||(Khat-K)v||^2 integrates the
    squared profile error against the pairwise-distance density; absent the
    data, a flat-in-r weight on [0, r_max] is the geometry-agnostic default
    (the subset-operator refit below adapts to the actual data/discretization
    when an x sample is available).
    """
    from scipy.optimize import nnls

    r = np.linspace(0.0, r_max, n_grid)
    target = np.asarray(kernel_fn(r**2), dtype=np.float64)
    comp = np.exp(-np.outer(r**2, np.asarray(alphas, np.float64) ** 2))
    w, _ = nnls(comp, target)
    # Normalize k(0) = sum_j w_j to exactly 1: the model layer assumes a
    # unit-diagonal normalized kernel (bilateral_kernel.py:139-140 parity).
    return w / max(w.sum(), 1e-12)


@functools.lru_cache(maxsize=None)
def mixture_kernel(
    nu: float = 1.5,
    order: int = 1,
    n_components: int = 8,
    alpha_range: tuple = (0.25, 4.0),
) -> MixtureKernel:
    """Gaussian-mixture discretization targeting Matern-``nu`` (see MixtureKernel)."""
    alphas = np.geomspace(alpha_range[0], alpha_range[1], n_components)
    w = _fit_profile_weights(lambda d2: _matern(d2, nu), alphas)
    return MixtureKernel(
        name=f"mixture:matern{nu}",
        order=order,
        alphas=tuple(float(a) for a in alphas),
        weights=tuple(float(x) for x in w),
        base=rbf_kernel(order),
        nu=nu,
    )


def fit_mixture_weights_subset(
    mk: MixtureKernel, ref: np.ndarray, m: int = 1024, n_probe: int = 8, seed: int = 0
) -> MixtureKernel:
    """Refit mixture weights against the EXACT operator on a data subset.

    Runs each component's actual lattice filter on an m-point random subset
    of the (already lengthscale-scaled) positions and NNLS-fits the weights
    to the dense target kernel's action on probe vectors.  This absorbs each
    component's own discretization error, which the geometry-agnostic profile
    fit cannot (prototype: rel_err 0.39 profile vs 0.11 subset-fit at d=18).
    O(m^2 d) dense work on an m ~= 1024 subset -- cheap at any production n.
    """
    import jax.numpy as jnp
    from scipy.optimize import nnls

    from .filter import lattice_filter_exact_grad

    rng = np.random.default_rng(seed)
    ref = np.asarray(ref)
    idx = rng.permutation(ref.shape[0])[: min(m, ref.shape[0])]
    rs = ref[idx]
    # Matmul-form squared distances cancel badly in f32: form them in f64.
    r64 = rs.astype(np.float64)
    d2 = (
        (r64 * r64).sum(-1)[:, None]
        + (r64 * r64).sum(-1)[None, :]
        - 2.0 * (r64 @ r64.T)
    )
    d2 = np.maximum(d2, 0.0)
    target = np.asarray(_matern(d2, mk.nu))
    v = rng.normal(size=(rs.shape[0], n_probe)).astype(np.float32)
    b = (target @ v).ravel()
    rj = jnp.asarray(rs)
    cols = [
        np.asarray(
            lattice_filter_exact_grad(jnp.asarray(v), rj * float(a), mk.base)
        ).ravel()
        for a in mk.alphas
    ]
    w, _ = nnls(np.stack(cols, axis=1), b)
    # NOT normalized: each lattice component under-delivers mass relative to
    # the ideal Gaussian (splat/slice interpolation), so the fit weights sum
    # well above 1 to make the OPERATOR (not the ideal profile) match the
    # unit-diagonal target -- normalizing would reintroduce a global scale
    # error (prototype: normalized profile weights 0.50 rel_err vs 0.17 for
    # the unnormalized subset fit at elevators n=8192).
    return dataclasses.replace(mk, weights=tuple(float(x) for x in w))


def kernel_value_jnp(dk, d2):
    """Exact (undiscretized) kernel value k(d2) as traced jnp math.

    The same stationary kernels as the reference's ``rbf``/``matern``
    (bilateral_kernel.py:202-245), used for exact kernel rows (pivoted-
    Cholesky preconditioner columns) and dense baselines.  For a
    :class:`MixtureKernel` this is the TARGET kernel (matern-nu): the lattice
    mixture operator is fit to approximate the unit-diagonal target, exactly
    as the matern tap filter approximates it -- so the preconditioner sees
    the same exact rows in both modes.  (The naive sum of ideal Gaussians
    would be wrong under subset-fit weights, which compensate for each
    component's own mass loss and sum well above 1.)
    """
    if isinstance(dk, MixtureKernel):
        dk = matern_kernel(dk.nu, dk.order)
    if dk.name == "rbf":
        return jnp.exp(-d2)
    if dk.name.startswith("matern"):
        nu = dk.nu
        d = jnp.sqrt(jnp.maximum(d2, 1e-30))
        e = jnp.exp(-jnp.sqrt(2.0 * nu) * d)
        if nu == 0.5:
            return e
        if nu == 1.5:
            return (1.0 + jnp.sqrt(3.0) * d) * e
        if nu == 2.5:
            return (1.0 + jnp.sqrt(5.0) * d + (5.0 / 3.0) * d2) * e
    raise ValueError(f"unknown kernel {dk.name!r}")
