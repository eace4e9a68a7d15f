"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64.

The GPU path is exercised on a card by ``python chip_smoke.py``; tests
validate numerics (float64) and multi-device sharding on the host platform.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
