"""simplex_gp_tpu: a scalable Gaussian-process framework in JAX.

A JAX/XLA implementation with the capabilities of
activatedgeek/simplex-gp ("SKIing on Simplices", ICML 2021): O(n d)
stationary-kernel MVMs via a permutohedral-lattice filter, driving exact-GP
training (preconditioned CG + stochastic Lanczos log-det) and prediction,
data-sharded across a device mesh.

Public API parity with the reference package export
(gpytorch_lattice_kernel/__init__.py): ``RBFLattice`` and ``MaternLattice``
construct lattice-accelerated GP models; lower layers are exposed under
``ops`` (filter), ``linalg`` (BBMM engine), ``models``, ``parallel`` and
``utils``.
"""

from . import linalg, models, ops, utils  # noqa: F401
from .linalg import BBMMConfig  # noqa: F401
from .models import DenseGP, SimplexGP  # noqa: F401


def RBFLattice(num_dims: int, order: int = 2, **kwargs) -> SimplexGP:
    """Lattice-accelerated RBF GP (reference bilateral_kernel.py:247-248)."""
    return SimplexGP(num_dims=num_dims, kernel="rbf", order=order, **kwargs)


def MaternLattice(num_dims: int, nu: float = 1.5, order: int = 3, **kwargs) -> SimplexGP:
    """Lattice-accelerated Matern GP (reference bilateral_kernel.py:253-254)."""
    return SimplexGP(num_dims=num_dims, kernel="matern", nu=nu, order=order, **kwargs)


def BilateralKernel(num_dims: int, **kwargs) -> SimplexGP:
    """Alias of RBFLattice (reference bilateral_kernel.py:250-251)."""
    return RBFLattice(num_dims, **kwargs)


def MixtureLattice(
    num_dims: int, nu: float = 1.5, order: int = 1, components: int = 8, **kwargs
) -> SimplexGP:
    """Gaussian-mixture lattice GP targeting Matern-``nu``.

    Accuracy mode beyond the reference: matern is a scale mixture of
    Gaussians, and the permutohedral filter is most accurate for Gaussians,
    so filtering ``components`` RBF lattices at scaled positions and
    combining them with nonnegative host-fit weights beats the matern
    tap-filter's discretization error (ops/kernels.py MixtureKernel) at
    ``components`` x the apply cost.
    """
    return SimplexGP(
        num_dims=num_dims, kernel="mixture", nu=nu, order=order,
        mix_components=components, **kwargs,
    )


__all__ = [
    "BBMMConfig",
    "BilateralKernel",
    "DenseGP",
    "MaternLattice",
    "MixtureLattice",
    "RBFLattice",
    "SimplexGP",
]
