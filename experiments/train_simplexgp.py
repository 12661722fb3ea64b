"""Simplex-GP trainer CLI (reference: experiments/train_simplexgp.py).

Example:
    python experiments/train_simplexgp.py --dataset elevators --order 1 \
        --kernel matern --nu 1.5 --cg-iter 500 --cg-tol 1.0
(the reference paper config, configs/simplexgp.yml).
"""

import argparse
import pathlib
import sys

_ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
_HERE = str(pathlib.Path(__file__).resolve().parent)
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)

from common import add_common_args, init_kwargs, load_dataset, run_training  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument(
        "--kernel", default="rbf", choices=["rbf", "matern", "mixture"],
        help="'mixture': Gaussian-mixture lattice targeting matern-nu "
        "(weights subset-fit to the dense operator at init lengthscales; "
        "higher accuracy than the matern tap filter at ~components x cost)",
    )
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--mix-components", type=int, default=8)
    p.add_argument("--cg-tol", type=float, default=1.0)
    p.add_argument("--cg-iter", type=int, default=500)
    p.add_argument("--lanc-iter", type=int, default=100)
    # Reference canonical default: max_preconditioner_size=100
    # (configs/simplexgp.yml, train_simplexgp.py:36).
    p.add_argument("--pre-size", type=int, default=100)
    p.add_argument("--num-probes", type=int, default=10)
    p.add_argument(
        "--prune-thresh", type=float, default=0.0,
        help="ARD dimension screening for lattice INFERENCE: at eval time "
        "drop dims whose inverse lengthscale is below this fraction of the "
        "max (models/exact_gp.py SimplexGP.prune_thresh; 0 disables)",
    )
    return p


def build_model(args, ds):
    """(model, initial raw params) for the parsed CLI ``args`` on ``ds``."""
    from simplex_gp_tpu import BBMMConfig, SimplexGP

    plan_capacity = None
    if args.plan_capacity == -1:
        from simplex_gp_tpu.ops.kernels import matern_kernel, rbf_kernel
        from simplex_gp_tpu.ops.lattice import count_lattice_points

        dk = rbf_kernel(args.order) if args.kernel == "rbf" else matern_kernel(args.nu, args.order)
        kw = init_kwargs(args, ds)
        ell = float(kw.get("lengthscale", 0.6931))
        occ = int(count_lattice_points(ds.train_x / ell, dk.variance, dk.coeffs))
        n, d = ds.train_x.shape
        plan_capacity = min(-(-int(occ * 1.25) // 8192) * 8192, n * (d + 1))
        print(f"plan capacity: occupancy {occ} -> capacity {plan_capacity} "
              f"(worst case {n * (d + 1)})", flush=True)
    elif args.plan_capacity > 0:
        plan_capacity = args.plan_capacity
    model = SimplexGP(
        num_dims=ds.train_x.shape[-1],
        kernel=args.kernel,
        nu=args.nu,
        order=args.order,
        min_noise=args.min_noise,
        prune_thresh=args.prune_thresh,
        mix_components=args.mix_components,
        bbmm=BBMMConfig(
            cg_tolerance=args.cg_tol,
            max_cg_iterations=args.cg_iter,
            max_lanczos_iterations=args.lanc_iter,
            precond_rank=args.pre_size,
            num_probes=args.num_probes,
            plan_capacity=plan_capacity,
        ),
    )
    raw0 = model.init_params(**init_kwargs(args, ds))
    if args.kernel == "mixture":
        import jax.numpy as jnp

        model = model.with_fitted_mixture(raw0, jnp.asarray(ds.train_x))
        print(f"mixture weights (subset fit): "
              f"{[round(w, 4) for w in model.mix_weights]}", flush=True)
    return model, raw0


def main():
    args = build_parser().parse_args()
    ds = load_dataset(args)
    model, raw0 = build_model(args, ds)
    run_training(model, raw0, ds, args, "simplexgp")


if __name__ == "__main__":
    main()
