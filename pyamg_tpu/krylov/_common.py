"""Shared plumbing for the Krylov suite.

Reference parity: pyamg/krylov/ uniform ``(A, b, x0, tol, maxiter, M,
callback, residuals) -> (x, info)`` contract (SURVEY.md §2.2 "Krylov suite").

Device design: each method is a single ``lax.while_loop`` program — the
preconditioner (e.g. one AMG cycle) is inlined into the loop body, so an
entire preconditioned solve is one XLA computation with no host round trips.
Residual histories are recorded into a fixed-size device buffer and trimmed
on host afterwards.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def canonicalize_operator(A):
    """Convert a scipy-sparse operator to a device operator UP FRONT so it
    rides :func:`run_core_jit` as a pytree ARGUMENT.  Left as-is, the eager
    ``while_loop`` core would close over the freshly-uploaded arrays and
    embed them as HLO constants (large programs, slow to compile) and
    re-hash the whole jaxpr on every call."""
    import scipy.sparse as sp
    if sp.issparse(A):
        from ..sparse import device_operator

        return device_operator(A.tocsr())
    return A


def make_matvec(A):
    """Matvec closure from a SparseELL / LinearOperator-like / callable /
    scipy-sparse / dense array (reference krylov accepts any array-like
    operator).  A scipy matrix is converted to a device operator — the
    cores are XLA while_loops, so the matvec must be traceable."""
    if callable(A) and not hasattr(A, "matvec"):
        return A
    mv = getattr(A, "matvec", None)
    if mv is not None:
        return mv
    import scipy.sparse as sp
    if sp.issparse(A):
        from ..sparse import device_operator

        return device_operator(A.tocsr()).matvec
    Ad = jnp.asarray(np.asarray(A))
    return lambda v: Ad @ v


def make_rmatvec(A):
    if hasattr(A, "rmatvec"):
        return A.rmatvec
    import scipy.sparse as sp
    if sp.issparse(A):
        from ..sparse import device_operator

        return device_operator(A.conjugate().T.tocsr()).matvec
    if not callable(A) and not hasattr(A, "matvec"):
        # dense array-like (ndarray, nested list, jnp array) — mirror
        # make_matvec's acceptance
        AH = jnp.asarray(np.asarray(A)).conj().T
        return lambda v: AH @ v
    raise ValueError("operator does not support rmatvec (A^H v)")


def identity_M(M):
    if M is None:
        return lambda r: r
    if callable(M) and not hasattr(M, "matvec"):
        return M
    mv = getattr(M, "matvec", None)
    if mv is None:                      # scipy sparse / dense array
        mv = make_matvec(M)

    def wrapped(r):
        out = mv(r)
        if not isinstance(out, jnp.ndarray):
            out = jnp.asarray(np.asarray(out), dtype=r.dtype)
        return out
    return wrapped


def prepare(A, b, x0, maxiter, M):
    """Returns ``(A, M, mv, pre, b, x, maxiter)`` with scipy-sparse A/M
    canonicalized to device operators (see canonicalize_operator)."""
    A = canonicalize_operator(A)
    if M is not None:
        M = canonicalize_operator(M)
    b = jnp.asarray(b).ravel()
    n = b.shape[0]
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0).ravel().astype(b.dtype)
    if maxiter is None:
        maxiter = n
    maxiter = int(maxiter)
    return A, M, make_matvec(A), identity_M(M), b, x, maxiter


def norm(v):
    return jnp.sqrt(jnp.real(jnp.vdot(v, v)))


def operator_jittable(A, M=None):
    """True when (A, M) can ride a jitted core as pytree ARGUMENTS: every
    operand is either None or a registered pytree exposing ``matvec`` (bare
    callables can't be reconstructed from leaves inside the jit)."""
    for op in (A, M):
        if op is None:
            continue
        if not hasattr(op, "matvec"):
            return False
        try:
            td = jax.tree_util.tree_structure(op)
        except Exception:           # pragma: no cover - exotic operands
            return False
        if jax.tree_util.treedef_is_leaf(td):
            return False            # unregistered object
    return True


@functools.partial(jax.jit, static_argnums=(0, 5, 7))
def run_core_jit(core, A, M, x, b, maxiter, tol_t, extra=()):
    """Dispatch a Krylov core as ONE jitted program with the operator as a
    pytree ARGUMENT.  Eagerly dispatched ``lax.while_loop`` re-hashes the
    whole jaxpr — with the operator arrays embedded as constants — on every
    call; the jitted call with operand arguments hits the C++ fast path
    and shares one executable across operators of equal shapes."""
    return core(make_matvec(A), identity_M(M), x, b, tol_t, maxiter, *extra)


@functools.partial(jax.jit, static_argnums=(0, 6))
def run_core_rmv_jit(core, A, AH, M, x, b, maxiter, tol_t):
    """run_core_jit variant for normal-equation cores that also need
    ``v -> A^H v``: AH rides as a pytree argument (None uses A's own
    ``rmatvec``)."""
    rmv = A.rmatvec if AH is None else make_matvec(AH)
    return core(make_matvec(A), rmv, identity_M(M), x, b, tol_t, maxiter)


def finalize(x, res_buf, n_res, tol_target, callback, residuals):
    """Convert device results to the reference (x, info) contract."""
    x = jax.device_get(x)
    res = np.asarray(jax.device_get(res_buf))
    n_res = int(jax.device_get(n_res))
    res = res[:n_res]
    if residuals is not None:
        residuals.extend([float(r) for r in res])
    if callback is not None:
        callback(np.asarray(x))
    final = res[-1] if len(res) else np.inf
    info = 0 if final <= tol_target else len(res) - 1
    return np.asarray(x), info
