"""Empirical complexity check: MVM wall time vs n and vs d.

The reference validates the claimed O(n d^2 + n L) filter complexity with
log-log regressions in notebooks/asymptotics.ipynb (SURVEY.md section 6:
"MVM & gradient ~ linear in n; low-order polynomial in d").  This script
reproduces that measurement for this filter and prints the fitted
exponents as JSON.

    python experiments/asymptotics.py --order 1
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

_ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--ns", type=int, nargs="*", default=[2000, 4000, 8000, 16000, 32000])
    p.add_argument("--ds", type=int, nargs="*", default=[2, 4, 8, 12, 16])
    p.add_argument("--fixed-n", type=int, default=8000)
    p.add_argument("--fixed-d", type=int, default=8)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()

    import jax.numpy as jnp

    from simplex_gp_tpu.ops import kernels as K
    from simplex_gp_tpu.ops.lattice import filter_once
    from simplex_gp_tpu.utils.timing import time_call

    import jax

    dk = K.rbf_kernel(args.order)
    rng = np.random.default_rng(0)

    def time_filter(n, d):
        x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
        v = jnp.asarray(rng.normal(size=(n, 1)).astype(np.float32))
        f = jax.jit(lambda vv, xx: filter_once(vv, xx, dk.coeffs, dk.variance))
        return time_call(f, v, x, reps=args.reps)

    t_n = [time_filter(n, args.fixed_d) for n in args.ns]
    t_d = [time_filter(args.fixed_n, d) for d in args.ds]

    slope_n = float(np.polyfit(np.log(args.ns), np.log(t_n), 1)[0])
    slope_d = float(np.polyfit(np.log(args.ds), np.log(t_d), 1)[0])

    print(
        json.dumps(
            {
                "order": args.order,
                "ns": args.ns,
                "t_n_ms": [round(t * 1e3, 2) for t in t_n],
                "ds": args.ds,
                "t_d_ms": [round(t * 1e3, 2) for t in t_d],
                "exponent_n": round(slope_n, 3),
                "exponent_d": round(slope_d, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
