"""What the repository's scripts share: the persistent compile cache and
the device they run on.  This file sits at the root of the checkout, beside
``chip_smoke.py`` and ``bench.py``; it is not part of the library.

The library never touches the cache on import; scripts (``chip_smoke.py``,
``bench.py``, ``benchmarks/``) call :func:`use_compile_cache` once before
their first compile.  A cache directory named by the environment variable
``JAX_COMPILATION_CACHE_DIR`` always wins: JAX reads it itself, and this
helper then sets nothing.  Measurement scripts call :func:`require_gpu`
first: a number taken on the CPU is never reported as a device number.
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["use_compile_cache", "require_gpu", "card_info"]

_CHECKOUT = os.path.dirname(os.path.abspath(__file__))


def use_compile_cache() -> str:
    """Enable the persistent compilation cache; return its directory.

    Without ``JAX_COMPILATION_CACHE_DIR`` the cache lives at
    ``<checkout>/.jax_cache``, a fixed path so that later runs from the
    same checkout hit.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def require_gpu(what: str, count: int = 1) -> dict:
    """The attached devices as ``{"platform", "kind", "count"}``; exits
    with a message naming ``what`` unless JAX finds at least ``count``
    GPUs (there is no CPU fallback)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"{what} needs a GPU; JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < count:
        raise SystemExit(f"{what} needs {count} GPUs; JAX found "
                         f"{len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> list[str]:
    """Each card's name and power limit as ``nvidia-smi`` reports them
    (``--query-gpu=name,power.limit``), one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
