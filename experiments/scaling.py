"""Multi-device scaling benchmark: filter MVM/s and NLML step/s vs mesh size.

The BASELINE.json north star is near-linear MVM-throughput scaling over a
device mesh -- a capability the single-device reference lacks entirely
(SURVEY.md section 2.7).  This harness measures, for each mesh size P in a
doubling ladder:

  * data-sharded filter apply (plan reused): the CG-iteration cost,
  * full data-sharded filter (plan build + apply),
  * one NLML loss+grad step (the full data-parallel BBMM engine),

and reports throughput (MVM/s), speedup vs P=1, and parallel efficiency.

On a multi-GPU host the same script runs unchanged; without one, pass
``--virtual 8`` to measure on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count).  Virtual devices
share the same physical cores, so virtual "scaling" mainly validates that
the communication pattern (one psum per MVM, all_gather per plan build) does
not SHRINK throughput as P grows; the linearity claim is for real meshes.

Usage:
    python experiments/scaling.py --virtual 8 --n 16384 -d 3 --out runs/scaling.json
"""

import argparse
import json
import os
import pathlib
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--virtual", type=int, default=0,
                   help="force N virtual CPU devices (sealed environments)")
    p.add_argument("--n", type=int, default=16384, help="global data size")
    p.add_argument("-d", "--dim", type=int, default=3)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--cols", type=int, default=8, help="value columns per MVM")
    p.add_argument("--weak", action="store_true",
                   help="weak scaling: --n rows PER DEVICE instead of global")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None, help="write JSON lines here as well")
    args = p.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        )
        os.environ["JAX_PLATFORMS"] = "cpu"

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

    import jax

    if args.virtual:
        # The config update also holds if jax was imported before the env
        # var was set.
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from simplex_gp_tpu import BBMMConfig, SimplexGP
    from simplex_gp_tpu.ops.kernels import rbf_kernel
    from simplex_gp_tpu.ops.lattice import apply_plan
    from simplex_gp_tpu.parallel import (
        build_plan_sharded,
        data_parallel_loss_fn,
        initialize_distributed,
        make_mesh,
        replicate,
        shard_batch,
    )
    from simplex_gp_tpu.utils.timing import time_call

    initialize_distributed()  # no-op single-process; joins the process group if multi-host
    n_total_dev = len(jax.devices())
    ladder = [m for m in (1, 2, 4, 8, 16, 32) if m <= n_total_dev]
    dk = rbf_kernel(args.order)

    out_f = open(args.out, "a") if args.out else None
    cpad = lambda p: -(-args.cols // p) * p  # padded column count per mesh size
    base = {}
    for n_dev in ladder:
        n = args.n * (n_dev if args.weak else 1)
        n = (n // n_dev) * n_dev
        rng = np.random.default_rng(0)
        x = rng.normal(size=(n, args.dim)).astype(np.float32)
        v = rng.normal(size=(n, args.cols)).astype(np.float32)
        y = rng.normal(size=(n,)).astype(np.float32)

        mesh = make_mesh(n_dev)
        xs, vs, ys = shard_batch(mesh, x, v, y)

        def shard_apply(x_loc, v_loc):
            plan = build_plan_sharded(x_loc, dk.coeffs, dk.variance, "data")
            return apply_plan(plan, v_loc, dk.coeffs, axis_name="data")

        full = jax.jit(shard_map(
            shard_apply, mesh=mesh,
            in_specs=(P("data", None), P("data", None)),
            out_specs=P("data", None), check_vma=False,
        ))

        t_full = time_call(full, xs, vs, reps=args.reps)

        model = SimplexGP(
            num_dims=args.dim, kernel="rbf", order=args.order,
            bbmm=BBMMConfig(cg_tolerance=1.0, max_cg_iterations=100,
                            max_lanczos_iterations=30, num_probes=8),
        )
        loss_fn = data_parallel_loss_fn(model, mesh)
        raw = replicate(mesh, model.init_params())
        key = jax.random.PRNGKey(0)
        t_step = time_call(loss_fn, raw, xs, ys, key, reps=max(2, args.reps // 2))

        rec = {
            "devices": n_dev,
            "platform": jax.devices()[0].platform,
            "n": n,
            "d": args.dim,
            "cols": args.cols,
            "mode": "weak" if args.weak else "strong",
            # Virtual CPU devices all share ONE host's cores (and XLA:CPU
            # already multithreads the 1-device run), so wall-clock speedup
            # is structurally impossible here; these rows validate the
            # communication pattern, not the linearity claim (real-mesh
            # metric).  See module docstring.
            **({"virtual_mesh": True} if args.virtual else {}),
            # Communication accounting (analytic, per MVM, per device):
            # the column-split blur psum_scatters the (M, c_pad) partial
            # table (send (P-1)/P of it) and all_gathers the blurred blocks
            # back (receive the same), so volume = 2 * M*c_pad*4 * (P-1)/P.
            # Plan build all_gathers 12 bytes per lattice vertex once.
            # These separate communication cost from CPU contention in the
            # virtual-mesh rows, where cores are shared (see docstring).
            "comm_table_bytes": n * (args.dim + 1) * cpad(n_dev) * 4,
            "comm_per_device_bytes_per_mvm": int(
                2 * n * (args.dim + 1) * cpad(n_dev) * 4 * (n_dev - 1) / n_dev
            ),
            "comm_plan_build_bytes": n * (args.dim + 1) * 12,
            "filter_full_ms": round(t_full * 1e3, 3),
            "filter_mvm_per_s": round(1.0 / t_full, 3),
            "nlml_step_ms": round(t_step * 1e3, 3),
            "nlml_step_per_s": round(1.0 / t_step, 4),
        }
        if n_dev == ladder[0]:
            base = rec
        scale = n_dev // ladder[0]
        # Strong scaling: speedup = t1/tP. Weak scaling: efficiency = t1/tP
        # at P-proportional work (ideal tP == t1).
        rec["mvm_speedup_vs_1dev"] = round(base["filter_full_ms"] / rec["filter_full_ms"], 3)
        rec["mvm_parallel_efficiency"] = round(
            rec["mvm_speedup_vs_1dev"] / (1 if args.weak else scale), 3)
        rec["step_speedup_vs_1dev"] = round(base["nlml_step_ms"] / rec["nlml_step_ms"], 3)
        print(json.dumps(rec), flush=True)
        if out_f:
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
    if out_f:
        out_f.close()


if __name__ == "__main__":
    main()
