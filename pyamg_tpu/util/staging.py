"""Host-staging of hierarchy arrays + single batched device upload.

Every individual ``jnp.asarray``/``device_put`` of a host array is its own
host-to-device transfer with its own fixed cost, and a classical hierarchy
finalize performs dozens of them, while ``jax.device_put`` of a *list* of
arrays batches them into one call.

Constructors on the setup path therefore route their uploads through
:func:`stage_array`.  Outside a ``staging()`` block it is exactly
``jnp.asarray`` (eager users see device arrays, unchanged).  Inside, arrays
stay host-side numpy — numpy arrays are valid pytree leaves for every
registered operator/smoother dataclass — and the whole hierarchy is shipped
in ONE call by :func:`batch_device_put` at ``MultilevelSolver._dev()``.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["staging", "staging_active", "stage_array", "batch_device_put"]

_tls = threading.local()


def staging_active() -> bool:
    return getattr(_tls, "depth", 0) > 0


class staging:
    """Context manager: arrays built via stage_array stay host numpy."""

    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.depth -= 1
        return False


def stage_array(x, dtype=None):
    """``jnp.asarray`` that defers the H2D transfer while staging."""
    if staging_active():
        return np.asarray(x, dtype=dtype)
    import jax.numpy as jnp

    return jnp.asarray(x, dtype=dtype)


def batch_device_put(tree):
    """Upload every leaf of ``tree`` in one ``jax.device_put`` call.

    One transfer call for the whole hierarchy instead of one per array;
    leaves already on device pass through unchanged (device_put no-op)."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if not leaves:
        return tree
    return jax.tree_util.tree_unflatten(treedef, jax.device_put(leaves))
