"""Preconditioned conjugate gradient.

Reference parity: pyamg/krylov/_cg.py:11 — same contract, realized as one
``lax.while_loop`` XLA program with the preconditioner inlined.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ._common import (prepare, norm, finalize, operator_jittable,
                      run_core_jit)

__all__ = ["cg", "cg_core", "cg_init", "cg_chunk"]


def cg_core(mv, pre, x, b, tol_t, maxiter):
    """Traceable PCG core: (x, n_iters, res_buf).  ``tol_t`` is a traced
    absolute tolerance so solves at different tolerances share one compile."""

    def body(carry):
        x, r, z, p, rz, it, res_buf = carry
        Ap = mv(p)
        pAp = jnp.vdot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pre(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1, rz)
        p = z + beta * p
        it = it + 1
        res_buf = res_buf.at[it].set(norm(r))
        return (x, r, z, p, rz_new, it, res_buf)

    def cond(carry):
        x, r, z, p, rz, it, res_buf = carry
        return (res_buf[it] > tol_t) & (it < maxiter)

    r = b - mv(x)
    z = pre(r)
    p = z
    rz = jnp.vdot(r, z)
    res_buf = jnp.zeros(maxiter + 1, dtype=jnp.real(b).dtype)
    res_buf = res_buf.at[0].set(norm(r))

    carry = jax.lax.while_loop(cond, body, (x, r, z, p, rz, 0, res_buf))
    x = carry[0]
    it = carry[-2]
    res_buf = carry[-1]
    return x, it, res_buf


def cg_init(mv, pre, x, b, maxiter):
    """Initial PCG carry for :func:`cg_chunk`: ``(x, r, z, p, rz, it,
    res_buf)`` with ``res_buf`` sized for the full solve."""
    r = b - mv(x)
    z = pre(r)
    rz = jnp.vdot(r, z)
    res_buf = jnp.zeros(maxiter + 1, dtype=jnp.real(b).dtype)
    res_buf = res_buf.at[0].set(norm(r))
    return (x, r, z, z, rz, 0, res_buf)


def cg_chunk(mv, pre, carry, tol_t, it_cap):
    """Continue PCG from ``carry`` until ``res <= tol_t`` or ``it >=
    it_cap`` (both traced scalars — one compile serves every chunk length).

    Dispatch-bounded execution: on a device runtime that kills
    long-running programs, a single fused while_loop over hundreds of
    iterations is unsafe on slow hierarchies; the
    caller re-dispatches chunks with the carry, preserving full CG momentum
    (identical iterate sequence to the one-dispatch cg_core)."""

    def body(c):
        x, r, z, p, rz, it, res_buf = c
        Ap = mv(p)
        pAp = jnp.vdot(p, Ap)
        alpha = rz / jnp.where(pAp == 0, 1, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pre(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1, rz)
        p = z + beta * p
        it = it + 1
        res_buf = res_buf.at[it].set(norm(r))
        return (x, r, z, p, rz_new, it, res_buf)

    def cond(c):
        it, res_buf = c[-2], c[-1]
        return (res_buf[it] > tol_t) & (it < it_cap)

    return jax.lax.while_loop(cond, body, carry)


def cg(A, b, x0=None, tol=1e-5, maxiter=None, xtype=None, M=None,
       callback=None, residuals=None):
    """Solve SPD/HPD A x = b with preconditioned CG; returns (x, info).

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu.gallery import poisson
    >>> from pyamg_tpu.krylov import cg
    >>> A = poisson((10, 10), format='csr')
    >>> b = np.ones(A.shape[0])
    >>> x, info = cg(A, b, tol=1e-8, maxiter=300)
    >>> bool(info == 0 and
    ...      np.linalg.norm(b - A @ x) < 1e-6 * np.linalg.norm(b))
    True
    """
    A, M, mv, pre, b, x, maxiter = prepare(A, b, x0, maxiter, M)
    normb = norm(b)
    normb = jnp.where(normb == 0, 1.0, normb)
    tol_t = tol * normb
    if operator_jittable(A, M):
        x, it, res_buf = run_core_jit(cg_core, A, M, x, b, maxiter, tol_t)
    else:
        x, it, res_buf = cg_core(mv, pre, x, b, tol_t, maxiter)
    return finalize(x, res_buf, it + 1, float(tol_t), callback, residuals)
