"""MVM accuracy/speed benchmark: lattice vs exact (reference: experiments/mvm_err.py).

Computes K(X, X) @ y with the lattice filter and with the dense kernel,
reporting scale-corrected relative error (mvm_err.py:94), cosine error, and
wall times.  Dense side is O(n^2): capped at --max-exact points (the error
metrics then use that subset for both operators, mirroring the reference's
CPU fallback path).
"""

import argparse
import json
import pathlib
import sys

import numpy as np

_ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
_HERE = str(pathlib.Path(__file__).resolve().parent)
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)

from common import add_common_args, load_dataset  # noqa: E402

from simplex_gp_tpu.utils.timing import time_call  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern", "mixture"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--max-exact", type=int, default=20000)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from simplex_gp_tpu.ops import kernels as K
    from simplex_gp_tpu.ops.lattice import count_lattice_points, filter_once

    ds = load_dataset(args)
    x_all = np.concatenate([ds.train_x, ds.val_x, ds.test_x], axis=0)
    y_all = np.concatenate([ds.train_y, ds.val_y, ds.test_y], axis=0)

    if args.kernel == "rbf":
        dk = K.rbf_kernel(args.order)
    elif args.kernel == "matern":
        dk = K.matern_kernel(args.nu, args.order)
    else:
        # Gaussian-mixture lattice targeting matern-nu, weights subset-fit to
        # the dense operator on this dataset's geometry (ops/kernels.py).
        dk = K.fit_mixture_weights_subset(
            K.mixture_kernel(args.nu, args.order), x_all, m=1024
        )

    # --- lattice MVM timing on the full dataset ---
    x = jnp.asarray(x_all)
    v = jnp.asarray(y_all[:, None])
    if args.kernel == "mixture":
        from simplex_gp_tpu.ops.filter import lattice_filter_any

        lat = jax.jit(lambda vv, xx: lattice_filter_any(vv, xx, dk))
    else:
        cap = None
        if x_all.shape[0] * (x_all.shape[1] + 1) > 1024 * 1024:
            # Trim the chain table to measured occupancy (see baseline_table.py).
            occ = int(count_lattice_points(x, dk.variance, dk.coeffs))
            c = -(-int(occ * 1.05) // 8192) * 8192
            if c < 0.9 * x_all.shape[0] * (x_all.shape[1] + 1):
                cap = c
        lat = jax.jit(lambda vv, xx: filter_once(vv, xx, dk.coeffs, dk.variance, cap))
    t_lattice = time_call(lat, v, x, reps=args.iters)

    # --- accuracy vs dense on a subset ---
    ns = min(args.max_exact, x_all.shape[0])
    xs, vs = x_all[:ns], y_all[:ns, None]
    if args.kernel == "mixture":
        from simplex_gp_tpu.ops.filter import lattice_filter_any

        # Weights are geometry-specific (they absorb each component's OWN
        # discretization at the given point set); the accuracy measurement
        # runs on the ns-row subset, so fit the measured kernel THERE --
        # fitting at full n and evaluating on the subset mixes two
        # different discretizations and overstates the error.
        dk_sub = K.fit_mixture_weights_subset(
            K.mixture_kernel(args.nu, args.order), xs, m=1024
        )
        lat_sub = jax.jit(lambda vv, xx: lattice_filter_any(vv, xx, dk_sub))
    else:
        lat_sub = jax.jit(lambda vv, xx: filter_once(vv, xx, dk.coeffs, dk.variance))
    lat_s = np.asarray(lat_sub(jnp.asarray(vs), jnp.asarray(xs)))

    xj = jnp.asarray(xs)

    @jax.jit
    def dense_mvm(vv):
        d2 = ((xj[:, None, :] - xj[None, :, :]) ** 2).sum(-1)
        # Exact kernel of the SAME family/nu as the lattice side, in full f32.
        Km = K.kernel_value_jnp(dk, d2)
        return jnp.matmul(Km, vv, precision=jax.lax.Precision.HIGHEST)

    t_exact = time_call(dense_mvm, jnp.asarray(vs), reps=args.iters)
    exact = np.asarray(dense_mvm(jnp.asarray(vs)))

    scale = (lat_s * exact).sum() / (lat_s * lat_s).sum()
    rel = float(np.linalg.norm(scale * lat_s - exact) / np.linalg.norm(exact))
    cos = float(
        (lat_s * exact).sum() / (np.linalg.norm(lat_s) * np.linalg.norm(exact))
    )

    print(
        json.dumps(
            {
                "dataset": args.dataset,
                "n": int(x_all.shape[0]),
                "d": int(x_all.shape[1]),
                "order": args.order,
                "kernel": args.kernel,
                "nu": args.nu if args.kernel in ("matern", "mixture") else None,
                "rel_err": rel,
                "cos_err": cos,
                "ts/lattice": t_lattice,
                "ts/exact_subset": t_exact,
                "exact_subset_n": ns,
            }
        )
    )


if __name__ == "__main__":
    main()
