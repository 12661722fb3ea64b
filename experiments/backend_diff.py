"""Cross-backend differential check: XLA filter vs the C++ golden model.

The reference's experiments/cuda_test.py pushes the same (src, ref, coeffs)
through its CPU and CUDA backends and asserts allclose, as its substitute for
race detection on the GPU hash table (SURVEY.md section 4.3).  This is the
same harness for this framework's two independent implementations: the XLA
sort/segment/gather pipeline and the sequential C++ hash-table golden model
(csrc/lattice_ref.cpp, compiled on first use).

    python experiments/backend_diff.py --n 10000 --d 6 --order 2
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
    p.add_argument("--n", type=int, default=10000)
    p.add_argument("--d", type=int, default=6)
    p.add_argument("--c", type=int, default=3)
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--kernel", default="rbf", choices=["rbf", "matern"])
    p.add_argument("--nu", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from simplex_gp_tpu.ops import kernels as K
    from simplex_gp_tpu.ops.cpu_ref import available, filter_ref
    from simplex_gp_tpu.ops.lattice import filter_once
    from simplex_gp_tpu.utils.timing import time_call

    if not available():
        print(json.dumps({"error": "g++ golden model unavailable"}))
        return 1

    dk = (
        K.rbf_kernel(args.order)
        if args.kernel == "rbf"
        else K.matern_kernel(args.nu, args.order)
    )
    rng = np.random.default_rng(args.seed)
    x = rng.normal(size=(args.n, args.d)).astype(np.float32)
    v = rng.normal(size=(args.n, args.c)).astype(np.float32)

    import time

    t0 = time.perf_counter()
    ref_out = filter_ref(v, x, np.asarray(dk.coeffs, np.float32), dk.variance)
    t_cpp = time.perf_counter() - t0

    f = jax.jit(lambda vv, xx: filter_once(vv, xx, dk.coeffs, dk.variance))
    t_xla = time_call(f, jnp.asarray(v), jnp.asarray(x), reps=args.iters)
    xla_out = np.asarray(f(jnp.asarray(v), jnp.asarray(x)))

    abs_err = np.abs(xla_out - ref_out)
    denom = np.maximum(np.abs(ref_out), 1e-6)
    rel = float(np.linalg.norm(xla_out - ref_out) / max(np.linalg.norm(ref_out), 1e-30))
    print(
        json.dumps(
            {
                "n": args.n,
                "d": args.d,
                "c": args.c,
                "order": args.order,
                "kernel": args.kernel,
                "rel_err": rel,
                "max_abs_err": float(abs_err.max()),
                "max_pointwise_rel": float((abs_err / denom).max()),
                "allclose_1e4": bool(np.allclose(xla_out, ref_out, rtol=1e-4, atol=1e-4)),
                "ts/cpp": round(t_cpp, 4),
                "ts/xla": round(t_xla, 4),
                "speedup": round(t_cpp / t_xla, 2),
                "device": str(jax.devices()[0]),
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
