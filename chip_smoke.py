"""Smoke test of the Simplex-GP main path on NVIDIA GPUs.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the data-sharded path on four cards

One process holds the card(s); its only children are ``nvidia-smi`` and the
``g++`` build of the C++ golden model.  Phases, in order:

  device   the first JAX device must be a GPU (there is no CPU fallback);
  filter   the elevators stand-in at the shape utils/data.py generates
           (16,599 rows x 18 inputs): every lattice engine the
           program dispatches to (chain plan, join plan, fused one-shot) at
           1 and 11 value columns, RBF and Matern-1.5 order 1, against the
           C++ golden model, plus the chain engine's error against an exact
           dense MVM;
  train    the paper config (configs/simplexgp.yml) through the trainer's
           own entry points for 3 epochs, after one NLML value-and-gradient
           compared between the GPU and the host's CPU backend.

``--four-cards`` runs only the data-sharded NLML value-and-gradient on a
four-GPU mesh at the precipitation stand-in's training split, compared with
the single-device engine on the same rows and probes.

Any failed check raises, and the script exits non-zero.  The last stdout
line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
for _p in (ROOT, ROOT / "experiments"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from simplex_gp_tpu.utils.runtime import card_line, configure_compile_cache, require_gpu  # noqa: E402

# The golden-model tolerance of tests/test_cpu_ref.py.
GOLD_RTOL = GOLD_ATOL = 2e-4
# GPU vs CPU backend, same probes, CG run to relative residual 1e-4 on both:
# each run's solves are within ~cond(K_hat) * 1e-4 of the exact ones, and
# cond(K_hat) is O(1-10) at the initial hyperparameters, so the gradients
# (linear in the solves) agree to ~1e-3 and the loss (a quadratic form plus
# an SLQ log-det from the converged tridiagonals) to ~1e-4.
NLML_CG_TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-3
PRECISION = (
    "f32 data; every matmul on these paths at Precision.HIGHEST (lattice "
    "elevation, preconditioner, Lanczos, LOVE root, dense exact MVM); the "
    "filter itself is sorts, gathers and sums, with no matmul"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device(count: int = 1) -> jax.Device:
    """The first GPU; RuntimeError on any other platform or too few cards."""
    dev = require_gpu()
    if len(jax.devices()) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(jax.devices())}")
    return dev


def peak_bytes(dev: jax.Device) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


# ---------------------------------------------------------------- filter ---


def engines(dk):
    """Every lattice engine the program dispatches to: name -> (v, x) -> K v."""
    from simplex_gp_tpu.ops.lattice import (
        apply_plan,
        apply_plan_join,
        build_plan,
        build_plan_join,
        filter_fused,
    )

    return {
        "chain": lambda v, x: apply_plan(build_plan(x, dk.coeffs, dk.variance), v, dk.coeffs),
        "join": lambda v, x: apply_plan_join(build_plan_join(x, dk.coeffs, dk.variance), v, dk.coeffs),
        "fused": lambda v, x: filter_fused(v, x, dk.coeffs, dk.variance),
    }


def gold_error(ours: np.ndarray, gold: np.ndarray) -> tuple[float, float]:
    """(worst-row allclose ratio, max abs error) of ``ours`` against ``gold``.

    The ratio is max over rows of max over columns of
    |ours - gold| / (atol + rtol |gold|): at most 1 means the rows pass
    ``np.testing.assert_allclose(ours, gold, rtol, atol)``.
    """
    err = np.abs(ours - gold)
    ratio = err / (GOLD_ATOL + GOLD_RTOL * np.abs(gold))
    return float(ratio.max(axis=1).max()), float(err.max())


def golden(x: np.ndarray, v: np.ndarray, dk) -> np.ndarray:
    """K v from the C++ golden model (compiled from csrc/ on first use)."""
    from simplex_gp_tpu.ops.cpu_ref import filter_ref

    return filter_ref(v, x, np.asarray(dk.coeffs), dk.variance)


def compare_engines(x: np.ndarray, v: np.ndarray, dk, device=None, gold=None) -> dict:
    """Each engine's (worst-row ratio, max abs error) against the golden model.

    ``device`` (default: JAX's default device) is where the engines run;
    ``gold`` (default: computed here) is the golden model's K v.
    """
    if gold is None:
        gold = golden(x, v, dk)
    xj, vj = jax.device_put((jnp.asarray(x), jnp.asarray(v)), device)
    out = {}
    for name, f in engines(dk).items():
        ours = np.asarray(jax.block_until_ready(f(vj, xj)))
        if ours.shape != gold.shape or not np.all(np.isfinite(ours)):
            raise RuntimeError(f"{name}: shape {ours.shape} or non-finite output")
        out[name] = gold_error(ours, gold)
    return out


def dense_mvm(x: jax.Array, v: jax.Array, dk, block: int = 1024) -> jax.Array:
    """Exact K(x, x) @ v, ``block`` rows of K at a time, products at HIGHEST."""
    from simplex_gp_tpu.ops.kernels import kernel_value_jnp

    n = x.shape[0]
    g = -(-n // block)
    xp = jnp.concatenate([x, jnp.zeros((g * block - n, x.shape[1]), x.dtype)])

    def rows(xb):
        d2 = ((xb[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        return jnp.matmul(kernel_value_jnp(dk, d2), v, precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.map(rows, xp.reshape(g, block, -1))
    return out.reshape(g * block, -1)[:n]


def scaled_rel_err(lat: np.ndarray, exact: np.ndarray) -> tuple[float, float]:
    """(scale-corrected relative error, cosine) as experiments/mvm_err.py."""
    scale = (lat * exact).sum() / (lat * lat).sum()
    rel = float(np.linalg.norm(scale * lat - exact) / np.linalg.norm(exact))
    cos = float((lat * exact).sum() / (np.linalg.norm(lat) * np.linalg.norm(exact)))
    return rel, cos


def elevators_inputs():
    """Standardised elevators stand-in, all rows: (x (n, d), y (n,))."""
    from simplex_gp_tpu.utils import load_uci, prepare_dataset

    ds = prepare_dataset(load_uci("elevators"), name="elevators")
    x = np.concatenate([ds.train_x, ds.val_x, ds.test_x]).astype(np.float32)
    y = np.concatenate([ds.train_y, ds.val_y, ds.test_y]).astype(np.float32)
    return x, y


def phase_filter(x: np.ndarray, y: np.ndarray) -> None:
    from simplex_gp_tpu.ops import kernels as K

    n, d = x.shape
    log(f"[filter] n={n} d={d} tolerance rtol=atol={GOLD_RTOL}; precision: {PRECISION}")
    rng = np.random.default_rng(0)
    v = np.concatenate([y[:, None], rng.choice([-1.0, 1.0], size=(n, 10))], axis=1)
    v = v.astype(np.float32)
    misses = []
    for kname, dk in (("rbf", K.rbf_kernel(1)), ("matern15", K.matern_kernel(1.5, 1))):
        # The filter acts on each column alone, so the 1-column golden output
        # is the first column of the 11-column one.
        gold = golden(x, v, dk)
        for c in (1, 11):
            t0 = time.perf_counter()
            res = compare_engines(x, v[:, :c], dk, gold=gold[:, :c])
            for eng, (ratio, err) in res.items():
                ok = ratio <= 1.0
                log(f"[filter] {kname} order=1 c={c} {eng}: worst-row ratio={ratio:.4g} "
                    f"max|err|={err:.3g} {'ok' if ok else 'MISS'}")
                if not ok:
                    misses.append((kname, c, eng))
            log(f"[filter] {kname} c={c}: {time.perf_counter() - t0:.1f} s, compile included")
        exact = np.asarray(dense_mvm(jnp.asarray(x), jnp.asarray(y[:, None]), dk))
        lat = np.asarray(engines(dk)["chain"](jnp.asarray(y[:, None]), jnp.asarray(x)))
        rel, cos = scaled_rel_err(lat, exact)
        log(f"[filter] {kname} order=1 chain vs exact dense MVM: rel_err={rel:.4f} cos={cos:.4f}")
        if not (math.isfinite(rel) and rel < 1.0):
            raise RuntimeError(f"{kname}: chain engine rel_err {rel} against the exact MVM")
    if misses:
        cpu = jax.devices("cpu")[0]
        for kname, c, eng in misses:
            dk = K.rbf_kernel(1) if kname == "rbf" else K.matern_kernel(1.5, 1)
            ratio, err = compare_engines(x, v[:, :c], dk, device=cpu)[eng]
            log(f"[filter] same case on the CPU backend: {kname} c={c} {eng}: "
                f"worst-row ratio={ratio:.4g} max|err|={err:.3g}")
        raise RuntimeError(f"engines outside the golden tolerance: {misses}")


# ----------------------------------------------------------------- train ---


def paper_args(overrides: dict):
    """The trainer's parsed arguments for configs/simplexgp.yml + overrides."""
    from sweep import load_config
    from train_simplexgp import build_parser

    params = load_config(str(ROOT / "configs" / "simplexgp.yml"))["parameters"]
    flags = {k: spec["value"] for k, spec in params.items() if "value" in spec}
    flags.update(overrides)
    argv = [a for k, v in flags.items() for a in (f"--{k}", str(v))]
    return build_parser().parse_args(argv)


def flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in jax.tree.leaves(tree)])


def rel_diff(a, b) -> float:
    """||a - b|| / ||b|| over all leaves."""
    fa, fb = flat(a), flat(b)
    return float(np.linalg.norm(fa - fb) / max(np.linalg.norm(fb), 1e-30))


def nlml_cpu_vs_device(model, raw, x, y, key) -> dict:
    """One NLML value-and-grad at CG tolerance NLML_CG_TOL, default device vs CPU."""
    tight = dataclasses.replace(
        model, bbmm=dataclasses.replace(model.bbmm, cg_tolerance=NLML_CG_TOL)
    )
    vg = jax.jit(jax.value_and_grad(tight.nlml))
    args = (raw, jnp.asarray(x), jnp.asarray(y), key)
    t0 = time.perf_counter()
    compiled = vg.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, grads = jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    loss_c, grads_c = jax.block_until_ready(vg(*jax.device_put(args, jax.devices("cpu")[0])))
    return {
        "loss": float(loss),
        "loss_cpu": float(loss_c),
        "loss_rel": abs(float(loss) - float(loss_c)) / abs(float(loss_c)),
        "grad_rel": rel_diff(grads, grads_c),
        "finite": bool(np.all(np.isfinite(flat(grads))) and math.isfinite(float(loss))),
        "compile_s": t_compile,
        "run_s": t_run,
    }


def phase_train(overrides: dict) -> None:
    from common import load_dataset, run_training
    from train_simplexgp import build_model

    dev = jax.devices()[0]
    with tempfile.TemporaryDirectory() as out:
        args = paper_args({"epochs": 3, "log-int": 3, "seed": 0, "out": out, **overrides})
        ds = load_dataset(args)
        model, raw = build_model(args, ds)
        log(f"[train] {args.dataset}: n_train={ds.train_x.shape[0]} d={ds.train_x.shape[1]} "
            f"{model.kernel} nu={model.nu} order={model.order} lr={args.lr} "
            f"cg_iter={args.cg_iter} cg_tol={args.cg_tol} lanc_iter={args.lanc_iter} "
            f"pre_size={args.pre_size} min_noise={args.min_noise} probes={args.num_probes}; "
            f"precision: {PRECISION}")

        r = nlml_cpu_vs_device(model, raw, ds.train_x, ds.train_y, jax.random.PRNGKey(args.seed))
        log(f"[train] first NLML value-and-grad at cg_tol={NLML_CG_TOL}: loss {r['loss']:.7g} "
            f"(cpu {r['loss_cpu']:.7g}, rel diff {r['loss_rel']:.3g} <= {LOSS_RTOL}); "
            f"grads rel diff {r['grad_rel']:.3g} <= {GRAD_RTOL}; "
            f"compile {r['compile_s']:.1f} s, run {r['run_s']:.3f} s")
        if not (r["finite"] and r["loss_rel"] <= LOSS_RTOL and r["grad_rel"] <= GRAD_RTOL):
            raise RuntimeError(f"NLML value-and-grad: device and CPU backend disagree: {r}")

        _, final = run_training(model, raw, ds, args, "simplexgp")
        name = f"simplexgp_{args.dataset}_s{args.seed}"
        lines = (pathlib.Path(args.out) / name / "metrics.jsonl").read_text().splitlines()
    recs = [rec for rec in map(json.loads, lines) if "epoch" in rec]
    if len(recs) != args.epochs:
        raise RuntimeError(f"{len(recs)} epoch records for {args.epochs} epochs")
    vals = [rec["train/mll"] for rec in recs] + [recs[-1]["val/rmse"], recs[-1]["val/nll"]]
    vals += [final["test/rmse"], final["test/nll"]]
    if not all(math.isfinite(v) for v in vals):
        raise RuntimeError(f"non-finite training metrics: {recs} {final}")
    steps = [rec["train/loss_ts"] for rec in recs]
    log(f"[train] losses {[round(-rec['train/mll'], 5) for rec in recs]}; "
        f"val rmse {recs[-1]['val/rmse']:.4f} nll {recs[-1]['val/nll']:.4f}; "
        f"test rmse {final['test/rmse']:.4f} nll {final['test/nll']:.4f}")
    log(f"[train] step 0 (compile + run) {steps[0]:.2f} s; steady step "
        f"{float(np.median(steps[1:])):.3f} s (median of epochs 1-{len(steps) - 1}); "
        f"val eval {recs[-1]['val/pred_ts']:.2f} s; test predict {final['test/pred_ts']:.2f} s; "
        f"process peak device memory {peak_bytes(dev) / 2**30:.3f} GiB; card {card_line()}")


# ------------------------------------------------------------ four cards ---


def shard_probes(key: jax.Array, n: int, num_probes: int, n_dev: int) -> jax.Array:
    """The (n, num_probes) probes ``SimplexGP.nlml`` draws under a data mesh
    of ``n_dev`` shards: shard i draws its rows from ``fold_in(key, i)``."""
    rows = n // n_dev
    return jnp.concatenate([
        jax.random.rademacher(jax.random.fold_in(key, i), (rows, num_probes), dtype=jnp.float32)
        for i in range(n_dev)
    ])


def phase_four_cards(x: np.ndarray, y: np.ndarray, n_dev: int = 4) -> None:
    """``data_parallel_loss_fn`` on an ``n_dev``-device mesh vs the
    single-device engine on the same rows with the same probes."""
    from simplex_gp_tpu import BBMMConfig, SimplexGP
    from simplex_gp_tpu.linalg.mll import lattice_nlml
    from simplex_gp_tpu.parallel import data_parallel_loss_fn, make_mesh, replicate, shard_batch

    n = (x.shape[0] // n_dev) * n_dev
    x, y = x[:n], y[:n]
    model = SimplexGP(
        num_dims=x.shape[1], kernel="matern", nu=1.5, order=1, min_noise=0.1,
        bbmm=BBMMConfig(cg_tolerance=NLML_CG_TOL, max_cg_iterations=500,
                        max_lanczos_iterations=100, precond_rank=100, num_probes=10),
    )
    raw = model.init_params()
    key = jax.random.PRNGKey(0)
    log(f"[four-cards] n={n} d={x.shape[1]} mesh={n_dev} matern nu=1.5 order=1 "
        f"cg_tol={NLML_CG_TOL}; tolerance loss rel {LOSS_RTOL}, grads rel {GRAD_RTOL}; "
        f"precision: {PRECISION}")

    def single_loss(r, xx, yy, zz):
        return lattice_nlml(model.dk, model.bbmm, model.constrained(r), xx, yy, zz)

    probes = shard_probes(key, n, model.bbmm.num_probes, n_dev)
    args1 = jax.device_put((raw, jnp.asarray(x), jnp.asarray(y), probes), jax.devices()[0])
    t0 = time.perf_counter()
    loss1, g1 = jax.block_until_ready(jax.jit(jax.value_and_grad(single_loss))(*args1))
    log(f"[four-cards] single device, the shards' probes: loss {float(loss1):.7g} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")

    mesh = make_mesh(n_dev)
    fn = data_parallel_loss_fn(model, mesh)
    args = (replicate(mesh, raw), *shard_batch(mesh, x, y), key)
    t0 = time.perf_counter()
    lossP, gP = jax.block_until_ready(fn(*args))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t_step = time.perf_counter() - t0
    loss_rel = abs(float(lossP) - float(loss1)) / abs(float(loss1))
    grad_rel = rel_diff(gP, g1)
    log(f"[four-cards] data_parallel_loss_fn: loss {float(lossP):.7g} rel diff {loss_rel:.3g}; "
        f"grads rel diff {grad_rel:.3g}; first call {t_first:.1f} s incl. compile, "
        f"second {t_step:.3f} s")
    finite = math.isfinite(float(lossP)) and np.all(np.isfinite(flat(gP)))
    if not (finite and loss_rel <= LOSS_RTOL and grad_rel <= GRAD_RTOL):
        raise RuntimeError("data_parallel_loss_fn disagrees with the single-device engine")
    for i, d in enumerate(jax.devices()[:n_dev]):
        log(f"[four-cards] device {i} peak memory {peak_bytes(d) / 2**30:.3f} GiB")


# ------------------------------------------------------------------ main ---


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the data-sharded path on four GPUs")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    configure_compile_cache()
    dev = check_device(count)
    log(f"[device] {dev.platform} {dev.device_kind}, {len(jax.devices())} device(s); "
        f"card: {card_line()}")
    t0 = time.perf_counter()
    if args.four_cards:
        from simplex_gp_tpu.utils import load_uci, prepare_dataset

        ds = prepare_dataset(load_uci("precipitation"), name="precipitation")
        phase_four_cards(ds.train_x, ds.train_y)
    else:
        phase_filter(*elevators_inputs())
        log(f"[time] filter phase done at {time.perf_counter() - t0:.0f} s")
        phase_train({"dataset": "elevators"})
    log(f"[time] all phases {time.perf_counter() - t0:.0f} s")
    log(f"[card] {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
