"""Lattice-filter MVM wall time at the elevators geometry on one NVIDIA GPU.

Times ``K(X, X) @ v`` with the permutohedral filter (order 1, RBF) on
standard-normal positions of the elevators shape (n=16599, d=17; BASELINE.md):

  value          full filter, plan build + apply (``filter_once``), the
                 reference's convention: it rebuilds its hash table every MVM;
  apply_ms       plan-reused apply on 1 column (one CG iteration's operator);
  apply_8rhs_ms  plan-reused apply on 8 columns.

Each time is the median of 5 calls after one warm-up call, every call ending
in ``jax.block_until_ready`` (simplex_gp_tpu/utils/timing.py).  The script
fails without a GPU.  It prints the card's name and power limit, then one
JSON line.  The cell-by-cell benchmark is still to be built (ROADMAP.md).

    python bench.py
"""

import json

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from simplex_gp_tpu.ops import kernels as K
    from simplex_gp_tpu.ops.lattice import apply_plan, build_plan, filter_once
    from simplex_gp_tpu.utils.runtime import card_line, configure_compile_cache, require_gpu
    from simplex_gp_tpu.utils.timing import time_call

    configure_compile_cache()
    dev = require_gpu()
    print(f"card: {card_line()}", flush=True)

    n, d = 16599, 17
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(n, 1)).astype(np.float32))
    v8 = jnp.asarray(rng.normal(size=(n, 8)).astype(np.float32))
    dk = K.rbf_kernel(1)

    full = jax.jit(lambda vv, xx: filter_once(vv, xx, dk.coeffs, dk.variance))
    apply = jax.jit(lambda p, vv: apply_plan(p, vv, dk.coeffs))
    plan = build_plan(x, dk.coeffs, dk.variance)
    result = {
        "metric": "elevators_lattice_mvm_time",
        "value": round(time_call(full, v, x) * 1e3, 3),
        "unit": "ms",
        "apply_ms": round(time_call(apply, plan, v) * 1e3, 3),
        "apply_8rhs_ms": round(time_call(apply, plan, v8) * 1e3, 3),
        "n": n,
        "d": d,
        "order": 1,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
