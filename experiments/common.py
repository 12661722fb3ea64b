"""Shared experiment runner: the reference's training-driver skeleton.

Mirrors experiments/train_simplexgp.py's main/train/test structure
(SURVEY.md section 3.1): dataset prep -> model -> NLML Adam loop with
per-epoch timing -> periodic val/test eval (RMSE, MAE, NLL) -> early stopping
-> best-checkpoint save -> metric logging.  Logging goes to JSONL + stdout
(the reference uses wandb; sealed environments get files)."""

from __future__ import annotations

import argparse
import json
import pathlib
import pickle
import time

import numpy as np


def add_common_args(p: argparse.ArgumentParser):
    # Every experiment CLI calls this before it compiles anything: place the
    # persistent compile cache (the full NLML step graph takes long to
    # compile; the cache makes reruns and resumes start fast).
    from simplex_gp_tpu.utils.runtime import configure_compile_cache

    configure_compile_cache()
    p.add_argument("--dataset", default="snelson")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-int", type=int, default=5, help="eval every k epochs (reference log_int)")
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--min-noise", type=float, default=1e-4)
    p.add_argument("--out", default="runs")
    p.add_argument("--max-n", type=int, default=0, help="optional training-subset cap")
    p.add_argument(
        "--ls-init",
        default="default",
        choices=["default", "median"],
        help="lengthscale init: GPyTorch default softplus(0)=0.693, or the "
        "median-pairwise-distance heuristic (essential in high d, where the "
        "default puts all kernel mass below the nearest-neighbour distance "
        "and lengthscale gradients vanish)",
    )
    p.add_argument(
        "--plan-capacity",
        type=int,
        default=0,
        help="lattice-table capacity for the training plan: 0 = worst-case "
        "bound n*(d+1), -1 = measure occupancy at the initial lengthscale "
        "and trim with 1.25x headroom (houseelectric-scale runs need this; "
        "an overflow during training poisons the loss with NaN rather than "
        "corrupting it -- ops/lattice.py capacity guard), >0 = explicit",
    )
    p.add_argument(
        "--no-eval",
        action="store_true",
        help="skip val/test prediction passes (pure NLML training-throughput "
        "runs at scales where the eval path would dominate wall-clock)",
    )
    p.add_argument(
        "--host-loop",
        action="store_true",
        help="run the CG loop on the host over one jitted iteration instead "
        "of a single fused while-loop graph (meant for houseelectric scale; "
        "whether the fused graph needs it on the GPU is unverified, see "
        "linalg/host_loop.py)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="resume from the run directory's checkpoint.pkl (params, "
        "optimizer state, epoch, early-stopper) -- a capability the "
        "reference lacks (SURVEY.md section 5: save-only)",
    )
    return p


def load_dataset(args):
    from simplex_gp_tpu.utils import load_snelson, load_uci, prepare_dataset

    if args.dataset == "snelson":
        x, y = load_snelson()
        data = np.concatenate([x, y[:, None]], axis=-1)
    else:
        data = load_uci(args.dataset, args.data_dir)
    ds = prepare_dataset(data, name=args.dataset, standardize=(args.dataset != "snelson"))
    if args.max_n and ds.train_x.shape[0] > args.max_n:
        ds = ds._replace(train_x=ds.train_x[: args.max_n], train_y=ds.train_y[: args.max_n])
    return ds


def init_kwargs(args, ds) -> dict:
    """Model init_params kwargs implied by the CLI flags (currently --ls-init)."""
    if getattr(args, "ls_init", "default") != "median":
        return {}
    x = np.asarray(ds.train_x)
    sub = x[np.random.default_rng(0).permutation(x.shape[0])[:2000]]
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    med = float(np.sqrt(np.median(d2[d2 > 0])))
    return {"lengthscale": med / np.sqrt(2.0)}


def regression_metrics(mean, var, y):
    mean, var, y = np.asarray(mean), np.asarray(var), np.asarray(y)
    err = mean - y
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mae": float(np.abs(err).mean()),
        "nll": float(0.5 * (np.log(2 * np.pi * var) + err**2 / var).mean()),
    }


def run_training(model, raw, ds, args, name: str):
    """Adam loop with periodic eval + early stopping; returns best raw params."""
    import jax
    import jax.numpy as jnp
    import optax

    from simplex_gp_tpu.utils import EarlyStopper

    out_dir = pathlib.Path(args.out) / f"{name}_{args.dataset}_s{args.seed}"
    out_dir.mkdir(parents=True, exist_ok=True)
    log_f = open(out_dir / "metrics.jsonl", "a")

    # Record the run's FULL configuration as the first line of the metrics
    # log (one line per session when resuming): the reference logs config
    # with every run via wandb.init(config=...) (train_simplexgp.py:91-98);
    # without this, reconstructing a committed run's kernel/order/min_noise/
    # CG settings required digging through commit messages (VERDICT r4).
    cfg_rec = {
        "config": {k: v for k, v in vars(args).items() if not k.startswith("_")},
        "model": repr(model),
    }
    log_f.write(json.dumps(cfg_rec) + "\n")
    log_f.flush()
    print(json.dumps(cfg_rec), flush=True)

    x = jnp.asarray(ds.train_x)
    y = jnp.asarray(ds.train_y)

    opt = optax.adam(args.lr)
    opt_state = opt.init(raw)

    host_loop = getattr(args, "host_loop", False) and hasattr(model, "nlml_value_and_grad_host")
    if host_loop:
        def step(raw, opt_state, key):
            loss, grads = model.nlml_value_and_grad_host(raw, x, y, key)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(raw, updates), opt_state, loss
    else:
        @jax.jit
        def step(raw, opt_state, key):
            loss, grads = jax.value_and_grad(lambda r: model.nlml(r, x, y, key))(raw)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(raw, updates), opt_state, loss

    stopper = EarlyStopper(patience=args.patience)
    key = jax.random.PRNGKey(args.seed)
    start_epoch = 0
    ckpt_path = out_dir / "checkpoint.pkl"
    if getattr(args, "resume", False) and ckpt_path.exists():
        with open(ckpt_path, "rb") as f:
            ck = pickle.load(f)
        raw = jax.tree.map(jnp.asarray, ck["raw"])
        opt_state = jax.tree.map(
            lambda t, c: jnp.asarray(c) if hasattr(t, "dtype") else c,
            opt_state,
            ck["opt_state"],
        )
        stopper = EarlyStopper(patience=args.patience, **ck["stopper"])
        key = jnp.asarray(ck["key"])
        start_epoch = ck["epoch"] + 1
        print(json.dumps({"resumed_from_epoch": ck["epoch"]}), flush=True)

    def save_checkpoint(epoch):
        tonp = lambda t: jax.tree.map(np.asarray, t)
        with open(ckpt_path, "wb") as f:
            pickle.dump(
                {
                    "raw": tonp(raw),
                    "opt_state": tonp(opt_state),
                    "epoch": epoch,
                    "key": np.asarray(key),
                    "stopper": {
                        "min_delta": stopper.min_delta,
                        "best_score": stopper.best_score,
                        "counter": stopper.counter,
                        "best_state": stopper.best_state,
                    },
                },
                f,
            )

    # Cached-posterior eval (VERDICT r3 item 4): build the posterior cache
    # (alpha + LOVE root) ONCE per eval point and share it between the val
    # pass and -- when the best epoch's params are being reused -- the final
    # test pass, mirroring the reference's cached train solves under
    # fast_pred_var (train_simplexgp.py:63-71).  Models without a cache API
    # (DenseGP/SGPR/SKI) fall back to their one-shot predict.
    has_cache = hasattr(model, "posterior_cache")
    best_cache = None  # posterior cache at the early-stopper's best params

    def predict_padded(cache, x_eval):
        """predict_from_cache with the eval block padded to a power of two.

        ``predict_from_cache`` is jitted per test-block SHAPE: val and test
        splits differ in row count, so the final test predict used to pay a
        fresh XLA compile.
        Rounding every eval block up to the next power of two puts val and
        test in the SAME compiled bucket (and makes persistent-cache hits
        across datasets likely).  Pad rows duplicate x_eval[0]: duplicates
        of an existing position add no new lattice cells and carry no splat
        values, so the real rows' predictions are unchanged.
        """
        m = x_eval.shape[0]
        b = 1 << (m - 1).bit_length()
        if b > m:
            pad = jnp.broadcast_to(x_eval[:1], (b - m, x_eval.shape[1]))
            x_eval = jnp.concatenate([x_eval, pad], axis=0)
        if hasattr(model, "predict_from_cache_screened"):
            mean, var = model.predict_from_cache_screened(cache, x, x_eval)
        else:
            mean, var = model.predict_from_cache(cache, x, x_eval)
        return mean[:m], var[:m]

    def eval_block(cur_raw, x_eval, k):
        if not has_cache:
            return None, model.predict(cur_raw, x, y, x_eval, k)
        if hasattr(model, "posterior_cache_screened"):
            cache = model.posterior_cache_screened(cur_raw, x, y, k, host=host_loop)
        elif host_loop:
            cache = model.posterior_cache_host(cur_raw, x, y, k)
        else:
            cache = model.posterior_cache(cur_raw, x, y, k)
        return cache, predict_padded(cache, x_eval)

    def hyp_summary(cur_raw):
        """Per-epoch hyperparameter record (the reference wandb-logs noise/
        outputscale/lengthscales every epoch, train_simplexgp.py:44-55;
        r4's frozen-lengthscale houseelectric failure was invisible without
        this)."""
        if not hasattr(model, "constrained"):
            return {}
        p = model.constrained(cur_raw)
        out = {}
        if "noise" in p:
            out["hyp/noise"] = float(p["noise"])
        if "outputscale" in p:
            out["hyp/outputscale"] = float(p["outputscale"])
        if "inv_ell" in p:
            inv = np.asarray(p["inv_ell"], np.float64).ravel()
            ell = 1.0 / np.maximum(inv, 1e-12)
            out["hyp/ell_mean"] = float(ell.mean())
            out["hyp/ell_min"] = float(ell.min())
            out["hyp/ell_max"] = float(ell.max())
            out["hyp/d_eff_30"] = int((inv >= 0.3 * inv.max()).sum())
        return out

    stopped = False
    for epoch in range(start_epoch, args.epochs):
        key, k1, k2 = jax.random.split(key, 3)
        t0 = time.perf_counter()
        raw, opt_state, loss = step(raw, opt_state, k1)
        loss = float(loss)
        rec = {"epoch": epoch, "train/mll": -loss, "train/loss_ts": time.perf_counter() - t0}
        rec.update(hyp_summary(raw))

        if ((epoch + 1) % args.log_int == 0 or epoch == args.epochs - 1) and not getattr(args, "no_eval", False):
            t0 = time.perf_counter()
            cache, (vm, vv) = eval_block(raw, jnp.asarray(ds.val_x), k2)
            rec.update({f"val/{k}": v for k, v in regression_metrics(vm, vv, ds.val_y).items()})
            rec["val/pred_ts"] = time.perf_counter() - t0
            if stopper.step(rec["val/rmse"], jax.tree.map(np.asarray, raw)):
                stopped = True
            if stopper.is_best:
                best_cache = cache
                with open(out_dir / "model_best.pkl", "wb") as f:
                    pickle.dump(jax.tree.map(np.asarray, raw), f)
            save_checkpoint(epoch)

        print(json.dumps(rec), flush=True)
        log_f.write(json.dumps(rec) + "\n")
        log_f.flush()
        if stopped:
            print(json.dumps({"early_stop": epoch}), flush=True)
            break

    best_raw = stopper.best_state if stopper.best_state is not None else jax.tree.map(np.asarray, raw)
    best_raw = jax.tree.map(jnp.asarray, best_raw)

    if getattr(args, "no_eval", False):
        final = {}
    else:
        key, k3 = jax.random.split(key)
        t0 = time.perf_counter()
        if has_cache and best_cache is not None:
            # The best epoch's val cache IS the posterior at best_raw: reuse.
            tm, tv = predict_padded(best_cache, jnp.asarray(ds.test_x))
        elif has_cache:
            if hasattr(model, "posterior_cache_screened"):
                cache = model.posterior_cache_screened(best_raw, x, y, k3, host=host_loop)
            elif host_loop:
                cache = model.posterior_cache_host(best_raw, x, y, k3)
            else:
                cache = model.posterior_cache(best_raw, x, y, k3)
            tm, tv = predict_padded(cache, jnp.asarray(ds.test_x))
        else:
            tm, tv = model.predict(best_raw, x, y, jnp.asarray(ds.test_x), k3)
        final = {f"test/{k}": v for k, v in regression_metrics(tm, tv, ds.test_y).items()}
        final["test/pred_ts"] = time.perf_counter() - t0
        print(json.dumps(final), flush=True)
        log_f.write(json.dumps(final) + "\n")
    log_f.close()
    with open(out_dir / "model_final.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, best_raw), f)
    return best_raw, final
