"""Unit tests for the wall-clock timing helper."""

import jax.numpy as jnp

from simplex_gp_tpu.utils import timing


def test_time_call_counts_warmup_and_reps():
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        return x + 1.0

    t = timing.time_call(f, jnp.zeros((3,)), reps=4, warmup=2)
    assert t >= 0.0
    assert calls["n"] == 6


def test_time_call_returns_median(monkeypatch):
    # Fake clock: rep k takes k+1 seconds (reps 1, 2, 3, 10, 5 s).
    durations = iter([1.0, 2.0, 3.0, 10.0, 5.0])
    clock = {"t": 0.0, "start": True}

    def fake_perf_counter():
        if not clock["start"]:
            clock["t"] += next(durations)
        clock["start"] = not clock["start"]
        return clock["t"]

    monkeypatch.setattr(timing.time, "perf_counter", fake_perf_counter)
    assert timing.time_call(lambda x: x, jnp.ones((2,)), reps=5) == 3.0
