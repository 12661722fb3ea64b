"""Training loop utilities: Adam fitting, early stopping, seeding.

JAX equivalents of the reference's experiment scaffolding:
Adam NLML loop (train_simplexgp.py:29-57,120-125), EarlyStopper
(experiments/utils.py:170-199), set_seeds (experiments/utils.py:13-18).
The update step is one jitted function; per-epoch wall times are recorded
like the reference's ``train/loss_ts``/``train/bw_ts`` metrics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import optax

__all__ = ["fit_adam", "EarlyStopper"]


def fit_adam(
    loss_fn: Callable[[dict, jax.Array], jax.Array],
    raw: dict,
    epochs: int = 100,
    lr: float = 0.1,
    seed: int = 0,
    callback: Optional[Callable[[int, dict, float], None]] = None,
):
    """Minimize ``loss_fn(raw_params, key)`` with Adam.

    Returns (final raw params, history dict of per-epoch loss and step time).
    A fresh PRNG key per epoch re-draws the NLML's stochastic probes, as
    GPyTorch re-draws trace probes per loss evaluation.
    """
    opt = optax.adam(lr)
    opt_state = opt.init(raw)

    @jax.jit
    def step(raw, opt_state, key):
        loss, grads = jax.value_and_grad(loss_fn)(raw, key)
        updates, opt_state = opt.update(grads, opt_state)
        raw = optax.apply_updates(raw, updates)
        return raw, opt_state, loss

    key = jax.random.PRNGKey(seed)
    history = {"loss": [], "step_time": []}
    for epoch in range(epochs):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        raw, opt_state, loss = step(raw, opt_state, sub)
        loss = float(loss)
        history["loss"].append(loss)
        history["step_time"].append(time.perf_counter() - t0)
        if callback is not None:
            callback(epoch, raw, loss)
    return raw, history


@dataclasses.dataclass
class EarlyStopper:
    """Patience-based early stopping retaining the best state.

    Mirrors experiments/utils.py:170-199: stop after ``patience`` evals with
    no improvement greater than ``min_delta``; keep the best (params, info).
    """

    patience: int = 10
    min_delta: float = 0.0
    best_score: float = float("inf")
    counter: int = 0
    best_state: Any = None

    def step(self, score: float, state: Any = None) -> bool:
        """Record an eval score (lower is better); return True to stop."""
        if score < self.best_score - self.min_delta:
            self.best_score = score
            self.best_state = state
            self.counter = 0
        else:
            self.counter += 1
        return self.counter > self.patience

    @property
    def is_best(self) -> bool:
        return self.counter == 0
