"""Process set-up shared by the measurement entry points.

``configure_compile_cache`` places JAX's persistent compilation cache, and
``require_gpu`` / ``card_line`` make a measurement refuse to run anywhere but
an NVIDIA GPU and name the card it ran on.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

__all__ = ["configure_compile_cache", "require_gpu", "card_line", "REPO_ROOT"]

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def configure_compile_cache() -> str:
    """Return the persistent compile-cache directory, setting it if needed.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
    nothing is set here.  Otherwise the cache goes to ``<repo>/.cache/jax``:
    a fixed path, because the cache key includes it.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = REPO_ROOT / ".cache" / "jax"
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return str(path)


def require_gpu() -> jax.Device:
    """The first JAX device, or RuntimeError unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} ({dev.device_kind}); "
            "this measurement runs only on an NVIDIA GPU"
        )
    return dev


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()
