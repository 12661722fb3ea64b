"""Test harness configuration.

Tests run on CPU with 8 virtual devices so that multi-device sharding
(`simplex_gp_tpu.parallel`) is exercised without GPUs, mirroring the
reference's no-GPU fallback story (the reference runs its canonical test
`tests/train_snelson.py` against the CPU extension when CUDA is absent).
The GPU path is checked by `python chip_smoke.py` on a GPU host.

NOTE: some pytest plugins import jax before this conftest runs, so setting
``JAX_PLATFORMS`` via os.environ here is unreliable (the config default is
snapshotted at jax import).  ``jax.config.update`` works at any point before
backend initialization, so we use that, and fail loudly if a backend was
already created (a test would otherwise silently run on an accelerator).
"""

import os

# XLA reads XLA_FLAGS at backend-creation time (lazily, at first computation),
# so this is still early enough even if jax itself is already imported.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

import jax._src.xla_bridge as _xb  # noqa: E402

assert not _xb._backends, "JAX backends initialized before conftest could force CPU"
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# No persistent compile cache, even if JAX_COMPILATION_CACHE_DIR is set: on
# the CPU backend, sharded executables loaded back from it deadlock in their
# collectives or return NaN (JAX 0.9.0).
jax.config.update("jax_compilation_cache_dir", None)
