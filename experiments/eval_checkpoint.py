"""Evaluate a saved SimplexGP checkpoint: one posterior cache, val+test.

Separates the expensive eval pass from training at very large n (the
houseelectric regime): train with ``--no-eval`` for pure NLML throughput,
then run this driver once on the saved ``model_final.pkl``/``model_best.pkl``.
Mirrors the reference's test() pass (train_simplexgp.py:60-84: cached train
solves under fast_pred_var, eval CG tolerance 1e-2).

Usage:
  python experiments/eval_checkpoint.py --run-dir runs/simplexgp_houseelectric_s0 \
      --dataset houseelectric --kernel matern --nu 1.5 [--root-rank 50]
"""

import argparse
import json
import pathlib
import pickle
import sys
import time

_ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
_HERE = str(pathlib.Path(__file__).resolve().parent)
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)

from common import add_common_args, load_dataset, regression_metrics  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    add_common_args(p)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--which", default="model_final.pkl", help="checkpoint file name")
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--eval-cg-tol", type=float, default=1e-2)
    p.add_argument("--cg-iter", type=int, default=500)
    p.add_argument("--pre-size", type=int, default=100)
    p.add_argument(
        "--root-rank", type=int, default=0,
        help="LOVE root rank (0 = the model's max_lanczos_iterations); "
        "reduce at very large n to bound the (n, m) sketch memory",
    )
    p.add_argument(
        "--prune-thresh", type=float, default=0.0,
        help="ARD dimension screening for lattice inference "
        "(SimplexGP.prune_thresh; 0 disables)",
    )
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from simplex_gp_tpu import BBMMConfig, SimplexGP

    ds = load_dataset(args)
    run_dir = pathlib.Path(args.run_dir)
    with open(run_dir / args.which, "rb") as f:
        raw = jax.tree.map(jnp.asarray, pickle.load(f))

    plan_capacity = None
    if args.plan_capacity == -1:
        # Measure occupancy at the CHECKPOINT's lengthscales (they drift
        # during training), reusing the already-loaded raw param dict.
        from simplex_gp_tpu.models.components import constrain
        from simplex_gp_tpu.ops.kernels import matern_kernel, rbf_kernel
        from simplex_gp_tpu.ops.lattice import count_lattice_points

        dk = rbf_kernel(args.order) if args.kernel == "rbf" else matern_kernel(args.nu, args.order)
        inv_ell = constrain(raw, args.min_noise)["inv_ell"]
        occ = int(count_lattice_points(jnp.asarray(ds.train_x) * inv_ell, dk.variance, dk.coeffs))
        n_, d_ = ds.train_x.shape
        plan_capacity = min(-(-int(occ * 1.4) // 8192) * 8192, n_ * (d_ + 1))
        print(f"plan capacity: occupancy {occ} -> {plan_capacity}", flush=True)
    elif args.plan_capacity > 0:
        plan_capacity = args.plan_capacity
    model = SimplexGP(
        num_dims=ds.train_x.shape[-1],
        kernel=args.kernel,
        nu=args.nu,
        order=args.order,
        min_noise=args.min_noise,
        prune_thresh=args.prune_thresh,
        bbmm=BBMMConfig(
            max_cg_iterations=args.cg_iter,
            precond_rank=args.pre_size,
            plan_capacity=plan_capacity,
        ),
        eval_cg_tolerance=args.eval_cg_tol,
    )
    x = jnp.asarray(ds.train_x)
    y = jnp.asarray(ds.train_y)
    key = jax.random.PRNGKey(args.seed + 555)

    t0 = time.perf_counter()
    sub, raw_sub, keep = model.screened(raw)
    x_in = x if keep is None else x[:, jnp.asarray(keep)]
    if keep is not None:
        print(json.dumps({"screened_dims": int(len(keep)), "of": int(model.num_dims)}), flush=True)
    if getattr(args, "host_loop", False):
        cache = sub.posterior_cache_host(raw_sub, x_in, y, key, root_rank=args.root_rank or None)
    else:
        cache = sub.posterior_cache(raw_sub, x_in, y, key, root_rank=args.root_rank or None)
    jax.block_until_ready(cache["alpha"])
    cache_ts = time.perf_counter() - t0

    out = {"cache_ts": cache_ts, "which": args.which, "root_rank": args.root_rank or None}
    if "cg_res" in cache:
        out["cache_cg_res"], out["cache_cg_iters"] = cache["cg_res"], cache["cg_iters"]
    for split, xe, ye in (("val", ds.val_x, ds.val_y), ("test", ds.test_x, ds.test_y)):
        t0 = time.perf_counter()
        # Pad the eval block to the next power of two with copies of row 0:
        # val and test then share ONE compiled predict shape (a per-shape
        # recompile dominated the houseelectric eval cost); duplicate
        # positions add no lattice cells, so real rows' predictions are
        # unchanged.
        xe = jnp.asarray(xe)
        if keep is not None:
            xe = xe[:, jnp.asarray(keep)]
        m_rows = xe.shape[0]
        b = 1 << (m_rows - 1).bit_length()
        if b > m_rows:
            xe = jnp.concatenate([xe, jnp.broadcast_to(xe[:1], (b - m_rows, xe.shape[1]))], axis=0)
        mean, var = sub.predict_from_cache(cache, x_in, xe)
        mean, var = mean[:m_rows], var[:m_rows]
        jax.block_until_ready(mean)
        out[f"{split}/pred_ts"] = time.perf_counter() - t0
        out.update({f"{split}/{k}": v for k, v in regression_metrics(mean, var, ye).items()})
    print(json.dumps(out), flush=True)
    with open(run_dir / "eval.jsonl", "a") as f:
        f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
