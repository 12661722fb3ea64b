"""Reproduce the reference's headline MVM wall-time table (BASELINE.md).

Times the lattice-filter MVM ``K(X, X) @ y`` at every dataset geometry of the
reference's paper-figure table (``notebooks/viz_compute.ipynb`` cell 3 in the
reference; SURVEY.md section 6), on this machine's accelerator:

  dataset        n          d   reference exact   reference simplex (GPU)
  elevators      16,599     17  0.008 s           0.083 s
  protein        45,730     9   0.014 s           0.034 s
  keggdirected   48,827     20  0.033 s           0.134 s
  precipitation  628,474    3   0.549 s           0.082 s
  houseelectric  2,049,280  11  17.1 s            1.756 s

Two numbers per dataset:
  * ``full_ms``   -- plan build + apply, the reference's rebuild-every-MVM
    convention (its hash table cannot be reused across MVMs);
  * ``apply_ms``  -- plan-reused apply, OUR per-CG-iteration cost (the
    number that governs training throughput).

Data is standard-normal synthetic at the real dataset shapes (as in
bench.py): MVM wall time depends on the shape/occupancy profile, not the
regression targets; pass real ``.mat`` files via DATADIR and --real to use
true inputs.

Usage:
  python experiments/baseline_table.py [--datasets elevators protein ...]
      [--order 1] [--reps 5] [--real]

Prints one JSON line per dataset.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")

# (n, d, ref_exact_s, ref_simplex_s) per BASELINE.md
SHAPES = {
    "elevators": (16599, 17, 0.008, 0.083),
    "protein": (45730, 9, 0.014, 0.034),
    "keggdirected": (48827, 20, 0.033, 0.134),
    "precipitation": (628474, 3, 0.549, 0.082),
    "houseelectric": (2049280, 11, 17.1, 1.756),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", nargs="*", default=list(SHAPES))
    ap.add_argument("--order", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--real", action="store_true", help="load real inputs from DATADIR")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from simplex_gp_tpu.ops import kernels as K
    from simplex_gp_tpu.ops.lattice import (
        apply_plan,
        build_plan,
        count_lattice_points,
        filter_once,
    )
    from simplex_gp_tpu.utils.timing import time_call

    dk = K.rbf_kernel(args.order)
    apply_only = jax.jit(lambda p, vv: apply_plan(p, vv, dk.coeffs))

    # Above this worst-case table size, measure the true occupancy once and
    # trim the plan capacity (houseelectric's M = 24.6M rows is ~4x the
    # occupied count, precipitation's 2.5M is ~4000x, protein's 457k is
    # ~2.5x; every per-row array and sort shrinks accordingly).  Trimming is
    # skipped when occupancy is near the bound (e.g. keggdirected at 99.97%).
    TRIM_ABOVE = 256 * 1024

    for name in args.datasets:
        n, d, ref_exact, ref_simplex = SHAPES[name]
        if args.real:
            from simplex_gp_tpu.utils import load_uci, prepare_dataset

            ds = prepare_dataset(load_uci(name), name=name, standardize=True)
            x = np.asarray(ds.train_x, np.float32)
            n, d = x.shape
        else:
            x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
        x = jnp.asarray(x)
        v = jnp.asarray(np.random.default_rng(1).normal(size=(n, 1)).astype(np.float32))
        try:
            capacity = None
            if n * (d + 1) > TRIM_ABOVE:
                occupied = int(count_lattice_points(x, dk.variance, dk.coeffs))
                cap = -(-int(occupied * 1.05) // 8192) * 8192
                if cap < 0.9 * n * (d + 1):
                    capacity = cap
            full = jax.jit(
                lambda vv, xx: filter_once(vv, xx, dk.coeffs, dk.variance, capacity)
            )
            plan = build_plan(x, dk.coeffs, dk.variance, capacity=capacity)
            n_lat = int(plan.n_lattice)
            assert capacity is None or n_lat <= capacity, (n_lat, capacity)
            t_full = time_call(full, v, x, reps=args.reps)
            t_apply = time_call(apply_only, plan, v, reps=args.reps)
        except Exception as e:  # noqa: BLE001 -- report OOM/compile failures per-row
            print(json.dumps({"dataset": name, "n": n, "d": d, "error": repr(e)[:200]}), flush=True)
            continue
        print(
            json.dumps(
                {
                    "dataset": name,
                    "n": n,
                    "d": d,
                    "order": args.order,
                    "full_ms": round(t_full * 1e3, 3),
                    "apply_ms": round(t_apply * 1e3, 3),
                    "n_lattice": n_lat,
                    "capacity": capacity,
                    "ref_simplex_ms": ref_simplex * 1e3,
                    "ref_exact_ms": ref_exact * 1e3,
                    "vs_ref_simplex_full": round(ref_simplex / t_full, 3),
                    "vs_ref_simplex_apply": round(ref_simplex / t_apply, 3),
                    "device": jax.devices()[0].device_kind,
                }
            ),
            flush=True,
        )
        del plan


if __name__ == "__main__":
    main()
