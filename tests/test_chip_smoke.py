"""CPU tests of the GPU smoke script's checks and of the runtime helpers.

The smoke itself refuses to run without a GPU; these tests pin the parts it
is built from: the device check, the compile-cache placement, the golden
comparison of every lattice engine, and the exact dense reference.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simplex_gp_tpu.ops import kernels as K
from simplex_gp_tpu.utils import runtime

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_device_check_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()


def test_compile_cache_honours_env(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where/else")
    assert runtime.configure_compile_cache() == "/some/where/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_inside_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = runtime.configure_compile_cache()
        assert path == str(runtime.REPO_ROOT / ".cache" / "jax")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("kind", ["rbf", "matern"])
def test_every_engine_matches_golden_model(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    v = rng.normal(size=(300, 11)).astype(np.float32)
    dk = K.rbf_kernel(1) if kind == "rbf" else K.matern_kernel(1.5, 1)
    res = chip_smoke.compare_engines(x, v, dk)
    assert set(res) == {"chain", "join", "fused"}
    for ratio, err in res.values():
        assert ratio <= 1.0 and err < 2e-4


def test_golden_filter_acts_on_columns_alone():
    # phase_filter slices the 1-column golden output from the 11-column one.
    rng = np.random.default_rng(6)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    v = rng.normal(size=(200, 11)).astype(np.float32)
    dk = K.matern_kernel(1.5, 1)
    np.testing.assert_array_equal(
        chip_smoke.golden(x, v[:, :1], dk), chip_smoke.golden(x, v, dk)[:, :1]
    )


def test_gold_error_ratio_is_allclose_criterion():
    gold = np.array([[1.0, -2.0], [0.0, 3.0]], np.float32)
    ours = gold + np.array([[0.0, 0.0], [2e-4, 0.0]], np.float32)
    ratio, err = chip_smoke.gold_error(ours, gold)
    assert ratio == pytest.approx(1.0, rel=1e-3) and err == pytest.approx(2e-4, rel=1e-3)


def test_paper_args_are_the_paper_config():
    # The trainer's parser turns the persistent compile cache on; it must be
    # off again for the later tests in this process (tests/conftest.py).
    before = jax.config.jax_compilation_cache_dir
    try:
        args = chip_smoke.paper_args({"epochs": 3, "dataset": "elevators"})
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert (args.kernel, args.nu, args.order, args.lr) == ("matern", 1.5, 1, 0.1)
    assert (args.cg_iter, args.cg_tol, args.lanc_iter, args.pre_size) == (500, 1.0, 100, 100)
    assert (args.min_noise, args.num_probes, args.epochs) == (0.1, 10, 3)


def test_nlml_device_vs_cpu_report():
    from simplex_gp_tpu import BBMMConfig, SimplexGP

    rng = np.random.default_rng(7)
    x = rng.normal(size=(120, 3)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    model = SimplexGP(num_dims=3, kernel="matern", nu=1.5, order=1,
                      bbmm=BBMMConfig(max_lanczos_iterations=20, num_probes=4))
    r = chip_smoke.nlml_cpu_vs_device(model, model.init_params(), x, y, jax.random.PRNGKey(0))
    # Here the default device is the CPU, so both runs are the same program.
    assert r["finite"] and r["loss_rel"] == 0.0 and r["grad_rel"] == 0.0


def test_four_card_phase_on_virtual_cpus(monkeypatch):
    # data_parallel_loss_fn on a 4-device mesh must reproduce the
    # single-device step with the shards' probes (phase_four_cards raises
    # otherwise); peak memory is a GPU statistic, so it is stubbed here.
    monkeypatch.setattr(chip_smoke, "peak_bytes", lambda dev: 0)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(402, 3)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=402)).astype(np.float32)
    chip_smoke.phase_four_cards(x, y, n_dev=4)


def test_dense_mvm_matches_numpy_with_padding():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(37, 3)).astype(np.float32)
    v = rng.normal(size=(37, 2)).astype(np.float32)
    dk = K.matern_kernel(1.5, 1)
    d2 = ((x[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    d = np.sqrt(d2)
    Kx = (1 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d)
    out = np.asarray(chip_smoke.dense_mvm(jnp.asarray(x), jnp.asarray(v), dk, block=16))
    np.testing.assert_allclose(out, Kx @ v, rtol=1e-5, atol=1e-5)
