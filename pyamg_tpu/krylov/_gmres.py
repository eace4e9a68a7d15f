"""GMRES family: MGS-Arnoldi GMRES, flexible GMRES, Householder GMRES.

Reference parity: pyamg/krylov/{_gmres.py:10 dispatcher, _gmres_mgs.py:44,
_gmres_householder.py:24, _fgmres.py:24}.

Device design: the Arnoldi build runs as a ``lax.while_loop`` over a
statically-shaped Krylov buffer V (restart+1, n); orthogonalization is
classical Gram-Schmidt with reorthogonalization (CGS2) — two batched
matvec-style products that map onto dense matrix units, replacing the reference's
sequential per-vector MGS loop (numerically comparable at the same restart
sizes).  Givens rotations are carried in vectors and applied in masked form.
The Householder variant keeps the reference's algorithmic contract via a
host-side implementation (its reflector chain is inherently sequential;
amg_core/krylov.h:35,98).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ._common import (prepare, norm, identity_M, make_matvec,
                      operator_jittable)

__all__ = ["gmres", "gmres_mgs", "gmres_householder", "fgmres",
           "gmres_init", "gmres_chunk"]


def gmres(A, b, x0=None, tol=1e-5, restrt=None, maxiter=None, xtype=None,
          M=None, callback=None, residuals=None, orthog="mgs", **kwargs):
    """GMRES dispatcher (reference _gmres.py:10): orthog='mgs' or
    'householder'.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu.gallery import poisson
    >>> from pyamg_tpu.krylov import gmres
    >>> A = poisson((10, 10), format='csr')
    >>> b = np.ones(A.shape[0])
    >>> x, info = gmres(A, b, tol=1e-8, maxiter=300)
    >>> bool(np.linalg.norm(b - A @ x) < 1e-6 * np.linalg.norm(b))
    True
    """
    if orthog == "mgs":
        return gmres_mgs(A, b, x0=x0, tol=tol, restrt=restrt,
                         maxiter=maxiter, M=M, callback=callback,
                         residuals=residuals)
    if orthog == "householder":
        return gmres_householder(A, b, x0=x0, tol=tol, restrt=restrt,
                                 maxiter=maxiter, M=M, callback=callback,
                                 residuals=residuals)
    raise ValueError(f"unknown orthogonalization {orthog!r}")


@functools.partial(jax.jit, static_argnums=(3,))
def _extend_jit(A, M, state, flexible, tol_t):
    """Jitted Arnoldi extension with the operator as a pytree ARGUMENT —
    the eager while_loop dispatch re-hashes the whole jaxpr (operator
    embedded as constants) per call; this path hits the jit C++ fast
    path."""
    return _arnoldi_extend(make_matvec(A), identity_M(M), state, tol_t,
                           flexible)


def _arnoldi_cycle(mv, pre, x, b, m, tol_t, flexible=False,
                   progressive=False, ops=None):
    """One restart cycle: returns (x_new, res_history(m,), n_done).

    Left-preconditioned GMRES on M A; the tracked residual is ||M r||.
    When ``flexible`` is True the preconditioned vectors Z are stored and the
    update uses Z (right-preconditioned FGMRES); the tracked residual is the
    true ||r||.

    For large ``m`` the Krylov buffer GROWS progressively (64 → 128 → … → m)
    instead of being allocated at full size up front: every device op in the
    Arnoldi body — the CGS2 products, the basis-row update — is O(m_buffer)
    regardless of how many basis vectors exist yet, so a full-GMRES solve
    that converges at j ≪ m pays ~m/j times the necessary work.  Growth is
    an exact continuation (state is zero-padded; the iterate sequence is
    identical to the monolithic buffer).
    """
    n = b.shape[0]
    dtype = b.dtype

    if flexible:
        r = b - mv(x)
    else:
        r = pre(b - mv(x))
    beta = norm(r)

    m0 = min(m, 64) if (progressive and m > 96) else m
    state = _arnoldi_state(r, beta, m0, flexible)
    if ops is not None:
        def extend(st):
            return _extend_jit(ops[0], ops[1], st, flexible, tol_t)
    else:
        def extend(st):
            return _arnoldi_extend(mv, pre, st, tol_t, flexible)
    while True:
        state = extend(state)
        cur_m = state[0].shape[0] - 1
        if cur_m >= m:
            break
        k = int(state[-1])           # host sync, once per growth stage
        res_hist = state[-2]
        if k < cur_m or (k and float(res_hist[k - 1]) <= tol_t):
            break
        state = _arnoldi_grow(state, min(2 * cur_m, m))

    x_new, res_hist, k = _arnoldi_finish(x, state, flexible)
    return x_new, res_hist, k, beta


def _row_dots(V, w):
    """h = conj(V) @ w, formulated per dtype.

    f64 takes the elementwise multiply+reduce form of the contraction,
    which was chosen where f64 ``dot_general`` is emulated; whether a
    native-f64 GPU prefers the dot is unmeasured.  f32 keeps the dot, at
    HIGHEST precision so that a GPU does not round it to TF32."""
    if V.dtype in (jnp.float64, jnp.complex128):
        return jnp.sum(jnp.conj(V) * w[None, :], axis=1)
    return jnp.matmul(jnp.conj(V), w, precision=jax.lax.Precision.HIGHEST)


def _col_accum(V, h):
    """u = V.T @ h with the same dtype-gated formulation as _row_dots."""
    if V.dtype in (jnp.float64, jnp.complex128):
        return jnp.sum(V * h[:, None], axis=0)
    return jnp.matmul(V.T, h, precision=jax.lax.Precision.HIGHEST)


def _arnoldi_state(r, beta, m, flexible):
    """Fresh Arnoldi carry with an (m+1, n) basis buffer."""
    n = r.shape[0]
    dtype = r.dtype
    V = jnp.zeros((m + 1, n), dtype=dtype)
    Z = jnp.zeros((m + 1, n), dtype=dtype) if flexible else None
    R = jnp.zeros((m + 1, m + 1), dtype=dtype)   # triangular factor
    g = jnp.zeros(m + 1, dtype=dtype)
    cs = jnp.zeros(m + 1, dtype=dtype)
    sn = jnp.zeros(m + 1, dtype=dtype)
    res_hist = jnp.zeros(m, dtype=jnp.real(r).dtype)
    safe_beta = jnp.where(beta == 0, 1, beta)
    V = V.at[0].set(r / safe_beta)
    g = g.at[0].set(beta.astype(dtype))
    return (V, Z, R, g, cs, sn, res_hist, 0)


def _arnoldi_grow(state, m2):
    """Zero-pad every carry buffer to Krylov size ``m2`` (exact
    continuation: existing rows/columns are preserved in place)."""
    V, Z, R, g, cs, sn, res_hist, j = state

    def pad(arr, shape):
        out = jnp.zeros(shape, dtype=arr.dtype)
        return out.at[tuple(slice(0, s) for s in arr.shape)].set(arr)

    n = V.shape[1]
    V2 = pad(V, (m2 + 1, n))
    Z2 = pad(Z, (m2 + 1, n)) if Z is not None else None
    R2 = pad(R, (m2 + 1, m2 + 1))
    g2 = pad(g, (m2 + 1,))
    cs2 = pad(cs, (m2 + 1,))
    sn2 = pad(sn, (m2 + 1,))
    res2 = pad(res_hist, (m2,))
    return (V2, Z2, R2, g2, cs2, sn2, res2, j)


def _arnoldi_finish(x, state, flexible):
    """Back-substitute y over the first k columns and form the new iterate."""
    V, Z, R, g, cs, sn, res_hist, k = state
    m = V.shape[0] - 1
    dtype = V.dtype
    Rm = R[:m, :m]
    idx = jnp.arange(m)
    diag_fix = jnp.where(idx >= k, 1.0, 0.0).astype(dtype)
    Rm = Rm + jnp.diag(diag_fix)
    gm = jnp.where(idx < k, g[:m], 0.0).astype(dtype)
    y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
    if flexible:
        x_new = x + _col_accum(Z[:m], y)
    else:
        x_new = x + _col_accum(V[:m], y)
    return x_new, res_hist, k


def _arnoldi_extend(mv, pre, state, tol_t, flexible=False):
    """Continue the Arnoldi build inside ``state``'s buffer until it fills
    or the projected residual drops below ``tol_t``."""
    m = state[0].shape[0] - 1
    dtype = state[0].dtype

    def body(carry):
        V, Z, R, g, cs, sn, res_hist, j = carry
        vj = V[j]
        if flexible:
            z = pre(vj)
            Z_new = Z.at[j].set(z)
            w = mv(z)
        else:
            Z_new = Z
            w = pre(mv(vj))
        # CGS2 orthogonalization against all of V (rows > j are zero)
        h1 = _row_dots(V, w)
        w = w - _col_accum(V, h1)
        h2 = _row_dots(V, w)
        w = w - _col_accum(V, h2)
        h = h1 + h2                          # (m+1,)
        hj1 = norm(w)
        safe = jnp.where(hj1 == 0, 1, hj1)
        V_new = V.at[j + 1].set(w / safe)

        # Apply stored Givens rotations 0..j-1 to h.  Rotation i maps
        #   (h_i, h_{i+1}) <- (c̄_i h_i + s̄_i h_{i+1}, -s_i h_i + c_i h_{i+1})
        # and rotation i+1 reads the value rotation i wrote at position i+1,
        # so the chain is a first-order affine recurrence in that carried
        # value:  v_{i+1} = -s_i v_i + c_i h_{i+1},  v_0 = h_0  (h on the
        # right-hand side is the pre-rotation vector).  Evaluating it with
        # an associative scan is O(log m) depth — the sequential form
        # costs m dependent scalar steps per Arnoldi iteration, which made
        # the Givens update O(m^2) over a full-GMRES solve.
        i_idx = jnp.arange(m)
        act = i_idx < j
        a_aff = jnp.where(act, -sn[:m], jnp.ones((), dtype))
        b_aff = jnp.where(act, cs[:m] * h[1:m + 1], jnp.zeros((), dtype))

        def _affine_compose(p, q):
            (a1, b1), (a2, b2) = p, q
            return a2 * a1, a2 * b1 + b2

        Pa, Qa = jax.lax.associative_scan(_affine_compose, (a_aff, b_aff))
        v = jnp.concatenate([h[:1], Pa * h[0] + Qa])        # v_i, i = 0..m
        h = h.at[:m].set(jnp.where(
            act, jnp.conj(cs[:m]) * v[:m] + jnp.conj(sn[:m]) * h[1:m + 1],
            h[:m]))
        h = h.at[j].set(v[j])

        # new rotation to zero h[j+1]
        hj = h[j]
        denom = jnp.sqrt(jnp.abs(hj) ** 2 + jnp.abs(hj1) ** 2)
        safe_d = jnp.where(denom == 0, 1, denom)
        c_new = hj / safe_d
        s_new = (hj1 / safe_d).astype(dtype)
        cs_new = cs.at[j].set(jnp.where(denom == 0, 1.0, c_new))
        sn_new = sn.at[j].set(jnp.where(denom == 0, 0.0, s_new))
        h = h.at[j].set(denom.astype(dtype))
        h = h.at[j + 1].set(0.0)

        R_new = R.at[:, j].set(h)
        gj = g[j]
        g_new = g.at[j].set(jnp.conj(cs_new[j]) * gj)
        g_new = g_new.at[j + 1].set(-sn_new[j] * gj)
        res = jnp.abs(g_new[j + 1])
        res_hist_new = res_hist.at[j].set(res)
        return (V_new, Z_new, R_new, g_new, cs_new, sn_new, res_hist_new,
                j + 1)

    def cond(carry):
        res_hist, j = carry[-2], carry[-1]
        not_conv = jnp.where(j == 0, True, res_hist[jnp.maximum(j - 1, 0)]
                             > tol_t)
        return (j < m) & not_conv

    return jax.lax.while_loop(cond, body, state)


def gmres_core(mv, pre, x, b, tol_t, maxiter, restrt=30, flexible=False):
    """Traceable restarted-GMRES core: (x, n_iters, res_buf).

    The restart loop is a ``lax.while_loop`` around the traceable Arnoldi
    cycle, so an entire preconditioned GMRES solve is one XLA program
    (cacheable via MultilevelSolver._raw_accel like cg/bicgstab).
    """
    restrt = int(min(restrt, b.shape[0], maxiter))
    max_outer = max(1, -(-int(maxiter) // restrt))
    rdtype = jnp.real(b).dtype
    res_buf = jnp.zeros(maxiter + 1, dtype=rdtype)
    r0 = b - mv(x)
    res_buf = res_buf.at[0].set(jnp.linalg.norm(r0))

    def body(carry):
        x, it, res_buf, outer, last = carry
        x_new, res_hist, k, beta = _arnoldi_cycle(mv, pre, x, b, restrt,
                                                  tol_t, flexible=flexible)
        # write this cycle's residual history at offset it+1 (masked)
        idx = it + 1 + jnp.arange(restrt)
        valid = jnp.arange(restrt) < k
        idx = jnp.where(valid, idx, maxiter)     # park invalid writes
        res_buf = res_buf.at[jnp.minimum(idx, maxiter)].set(
            jnp.where(valid, res_hist, res_buf[jnp.minimum(idx, maxiter)]))
        last_new = jnp.where(k > 0, res_hist[jnp.maximum(k - 1, 0)], last)
        return (x_new, it + k, res_buf, outer + 1, last_new)

    def cond(carry):
        _x, it, _res, outer, last = carry
        return (last > tol_t) & (outer < max_outer) & (it < maxiter)

    beta0 = res_buf[0]
    carry = (x, 0, res_buf, 0, beta0)
    x, it, res_buf, _outer, _last = jax.lax.while_loop(cond, body, carry)
    return x, it, res_buf


def gmres_init(mv, pre, x, b, maxiter):
    """Initial restarted-GMRES carry for :func:`gmres_chunk`:
    ``(x, it, res_buf, outer, last)`` — matches gmres_core's loop carry."""
    rdtype = jnp.real(b).dtype
    res_buf = jnp.zeros(maxiter + 1, dtype=rdtype)
    r0 = b - mv(x)
    beta0 = jnp.linalg.norm(r0)
    res_buf = res_buf.at[0].set(beta0)
    return (x, 0, res_buf, 0, beta0)


def gmres_chunk(mv, pre, b, carry, tol_t, it_cap, maxiter, restrt=30,
                flexible=False):
    """Continue restarted GMRES from ``carry`` until ``last <= tol_t`` or
    ``it >= it_cap`` (both traced).

    Chunking happens at RESTART boundaries: each while_loop body is one
    Arnoldi cycle of ≤ ``restrt`` iterations, so a chunk overshoots its cap
    by < restrt iterations and each dispatch stays bounded.  Restart
    boundaries discard the Krylov basis anyway, so the iterate sequence is
    identical to the fused gmres_core."""
    restrt = int(min(restrt, b.shape[0], maxiter))
    max_outer = max(1, -(-int(maxiter) // restrt))

    def body(c):
        x, it, res_buf, outer, last = c
        x_new, res_hist, k, beta = _arnoldi_cycle(
            mv, pre, x, b, restrt, tol_t, flexible=flexible)
        idx = it + 1 + jnp.arange(restrt)
        valid = jnp.arange(restrt) < k
        idx = jnp.where(valid, idx, maxiter)
        res_buf = res_buf.at[jnp.minimum(idx, maxiter)].set(
            jnp.where(valid, res_hist,
                      res_buf[jnp.minimum(idx, maxiter)]))
        last_new = jnp.where(k > 0, res_hist[jnp.maximum(k - 1, 0)], last)
        return (x_new, it + k, res_buf, outer + 1, last_new)

    def cond(c):
        _x, it, _res, outer, last = c
        return (last > tol_t) & (outer < max_outer) & (it < it_cap)

    return jax.lax.while_loop(cond, body, carry)


def _fused_epilogue(mv, x, b, state, flexible, norm_r0):
    """Finish + TRUE final residual + everything the host needs packed
    into ONE array (x_new | res_hist | [k, beta-slot, norm_r0, true_res])
    — each fetched array is a separate device-to-host read, so the whole
    per-stage readback is a single transfer."""
    x_new, res_hist, k = _arnoldi_finish(x, state, flexible)
    true_res = norm(b - mv(x_new))
    dt = x_new.dtype
    stats = jnp.stack([jnp.asarray(k, dt),
                       jnp.abs(state[3][0]).astype(dt),   # |g[0]| = beta
                       norm_r0.astype(dt), true_res.astype(dt)])
    return jnp.concatenate([x_new, res_hist.astype(dt), stats])


@functools.partial(jax.jit, static_argnums=(5, 6))
def _gmres_fused_start(A, M, x, b, tol_t, m, flexible):
    """Stage-1 fused GMRES dispatch: initial residual, Arnoldi build into
    an (m+1, n) buffer, finish, and the final TRUE residual in a single
    program.  The eager progressive path pays 6-8 host round trips for
    the same work; here a solve that
    converges within the first buffer costs ONE dispatch + ONE read.
    Returns (state, packed) — the state stays device-resident for the
    growth continuation."""
    mv, pre = make_matvec(A), identity_M(M)
    r0 = b - mv(x)
    norm_r0 = norm(r0)
    r = r0 if flexible else pre(r0)
    beta = norm(r)
    state = _arnoldi_state(r, beta, m, flexible)
    state = _arnoldi_extend(mv, pre, state, tol_t, flexible)
    return state, _fused_epilogue(mv, x, b, state, flexible, norm_r0)


@functools.partial(jax.jit, static_argnums=(6, 7))
def _gmres_fused_grow(A, M, x, b, state, tol_t, m2, flexible):
    """Growth continuation of :func:`_gmres_fused_start`: zero-pad the
    carried state to ``m2`` (exact continuation — identical iterates to a
    monolithic buffer) and keep extending, again with the epilogue fused."""
    mv, pre = make_matvec(A), identity_M(M)
    state = _arnoldi_grow(state, m2)
    state = _arnoldi_extend(mv, pre, state, tol_t, flexible)
    zero = jnp.zeros((), jnp.real(b).dtype)
    return state, _fused_epilogue(mv, x, b, state, flexible, zero)


# fused-path cutoff: V is (m+1, n); 2^23 elements = 64 MB f64
_SMALL_FUSED_ELEMS = 1 << 23


def _gmres_like(A, b, x0, tol, restrt, maxiter, M, callback, residuals,
                flexible):
    A, M, mv, pre, b, x, _ = prepare(A, b, x0, maxiter or b.shape[0], M)
    n = b.shape[0]
    if maxiter is None:
        maxiter = min(n, 300)
    if restrt is None:
        # reference semantics (_gmres.py): no restart — the Krylov space
        # spans the full iteration budget
        restrt = min(n, int(maxiter))
    restrt = int(min(restrt, n))
    max_outer = max(1, -(-int(maxiter) // restrt))

    normb = float(norm(b))
    if normb == 0:
        normb = 1.0
    tol_t = tol * normb

    ops = (A, M) if operator_jittable(A, M) else None

    if (ops is not None and max_outer == 1 and callback is None
            and n * (restrt + 1) <= _SMALL_FUSED_ELEMS):
        m = restrt
        m_cur = min(m, 256) if m > 384 else m
        tol_dev = jnp.asarray(tol_t, jnp.real(b).dtype)
        state, packed = _gmres_fused_start(A, M, x, b, tol_dev, m_cur,
                                           flexible)
        norm_r0 = None
        while True:
            pk = np.asarray(packed)        # ONE device read per stage
            x_np = pk[:n]
            res_hist = np.real(pk[n:n + m_cur])
            stats = pk[n + m_cur:]
            k = int(np.real(stats[0]))
            true_res = float(np.real(stats[3]))
            if norm_r0 is None:
                norm_r0 = float(np.real(stats[2]))
            done = k < m_cur or (k and res_hist[k - 1] <= tol_t)
            if done or m_cur >= m:
                break
            m_cur = min(2 * m_cur, m)
            state, packed = _gmres_fused_grow(A, M, x, b, state, tol_dev,
                                              m_cur, flexible)
        all_res = [norm_r0] + [float(h) for h in res_hist[:k]]
        if residuals is not None:
            residuals.extend(all_res)
        info = 0 if true_res <= tol * normb * 1.5 or all_res[-1] <= tol_t \
            else len(all_res) - 1
        return x_np, info

    all_res = []
    r0 = b - mv(x)
    all_res.append(float(norm(r0)))
    for _ in range(max_outer):
        x, res_hist, k, beta = _arnoldi_cycle(mv, pre, x, b, restrt, tol_t,
                                              flexible=flexible,
                                              progressive=True, ops=ops)
        k = int(k)
        hist = np.asarray(res_hist)[:k]
        all_res.extend([float(h) for h in hist])
        if len(hist) and hist[-1] <= tol_t:
            break
        if float(beta) <= tol_t:
            break

    x = np.asarray(x)
    true_res = float(np.linalg.norm(np.asarray(b - mv(jnp.asarray(x)))))
    if residuals is not None:
        residuals.extend(all_res)
    if callback is not None:
        callback(x)
    info = 0 if true_res <= tol * normb * 1.5 or all_res[-1] <= tol_t \
        else len(all_res) - 1
    return x, info


def gmres_mgs(A, b, x0=None, tol=1e-5, restrt=None, maxiter=None, xtype=None,
              M=None, callback=None, residuals=None):
    """Restarted left-preconditioned GMRES (reference _gmres_mgs.py:44)."""
    return _gmres_like(A, b, x0, tol, restrt, maxiter, M, callback,
                       residuals, flexible=False)


def fgmres(A, b, x0=None, tol=1e-5, restrt=None, maxiter=None, xtype=None,
           M=None, callback=None, residuals=None):
    """Flexible GMRES — allows a varying preconditioner (e.g. an AMG cycle
    with nonsymmetric smoothing); reference _fgmres.py:24."""
    return _gmres_like(A, b, x0, tol, restrt, maxiter, M, callback,
                       residuals, flexible=True)


def gmres_householder(A, b, x0=None, tol=1e-5, restrt=None, maxiter=None,
                      xtype=None, M=None, callback=None, residuals=None):
    """Householder-orthogonalization GMRES (reference _gmres_householder.py:24
    + amg_core krylov.h:35,98).  Host implementation: the reflector chain is
    sequential by construction."""
    mv = make_matvec(A)
    pre = identity_M(M)

    def amv(v):
        return np.array(mv(jnp.asarray(v)))    # writable host copy

    def mop(v):
        return np.array(pre(jnp.asarray(v)))

    b = np.asarray(b).ravel()
    n = b.shape[0]
    x = np.zeros_like(b) if x0 is None else np.asarray(x0).ravel().copy()
    if maxiter is None:
        maxiter = n
    if restrt is None:
        restrt = min(n, 30, maxiter)
    restrt = int(min(restrt, n))
    normb = np.linalg.norm(b)
    if normb == 0:
        normb = 1.0
    tol_t = tol * normb

    all_res = [float(np.linalg.norm(b - amv(x)))]
    max_outer = max(1, -(-int(maxiter) // restrt))

    for _ in range(max_outer):
        r = mop(b - amv(x))
        beta = np.linalg.norm(r)
        if beta <= tol_t:
            break
        m = restrt
        W = np.zeros((m + 1, n), dtype=r.dtype)      # Householder vectors
        H = np.zeros((m + 1, m), dtype=r.dtype)
        g = np.zeros(m + 1, dtype=r.dtype)
        cs = np.zeros(m + 1, dtype=r.dtype)
        sn = np.zeros(m + 1, dtype=r.dtype)

        # first reflector maps r to ||r|| e_0
        w = r.copy()
        alpha = -np.sign(w[0].real if w[0] != 0 else 1.0) * beta
        w[0] -= alpha
        nw = np.linalg.norm(w)
        if nw > 0:
            w /= nw
        W[0] = w
        g[0] = alpha

        k_done = 0
        for j in range(m):
            # v = P_0 ... P_j e_j
            v = np.zeros(n, dtype=r.dtype)
            v[j] = 1.0
            for i in range(j, -1, -1):
                v -= 2.0 * W[i] * np.vdot(W[i], v)
            v = mop(amv(v))
            # apply P_j ... P_0
            for i in range(j + 1):
                v -= 2.0 * W[i] * np.vdot(W[i], v)
            # new reflector to zero v below entry j+1
            if j + 1 < n:
                w = np.zeros(n, dtype=r.dtype)
                w[j + 1:] = v[j + 1:]
                nv = np.linalg.norm(v[j + 1:])
                if nv > 0:
                    alpha = -np.sign(v[j + 1].real if v[j + 1] != 0
                                     else 1.0) * nv
                    w[j + 1] -= alpha
                    nw = np.linalg.norm(w)
                    if nw > 0:
                        w /= nw
                    W[j + 1] = w
                    v -= 2.0 * w * np.vdot(w, v)
            H[:, j] = v[:m + 1]
            # apply stored Givens
            for i in range(j):
                hi, hi1 = H[i, j], H[i + 1, j]
                H[i, j] = np.conj(cs[i]) * hi + np.conj(sn[i]) * hi1
                H[i + 1, j] = -sn[i] * hi + cs[i] * hi1
            # new Givens
            denom = np.sqrt(np.abs(H[j, j]) ** 2 + np.abs(H[j + 1, j]) ** 2)
            if denom != 0:
                cs[j] = H[j, j] / denom
                sn[j] = H[j + 1, j] / denom
                H[j, j] = denom
                H[j + 1, j] = 0.0
                gj = g[j]
                g[j] = np.conj(cs[j]) * gj
                g[j + 1] = -sn[j] * gj
            k_done = j + 1
            all_res.append(float(np.abs(g[j + 1])))
            if np.abs(g[j + 1]) <= tol_t:
                break

        k = k_done
        y = np.linalg.solve(H[:k, :k], g[:k]) if k else np.zeros(0)
        # x update: sum_j y_j (P_0...P_j e_j)
        dx = np.zeros(n, dtype=r.dtype)
        for j in range(k - 1, -1, -1):
            dx[j] += y[j]
            dx -= 2.0 * W[j] * np.vdot(W[j], dx)
        x = x + dx
        if all_res[-1] <= tol_t:
            break

    if residuals is not None:
        residuals.extend(all_res)
    if callback is not None:
        callback(x)
    info = 0 if all_res[-1] <= tol_t else len(all_res) - 1
    return x, info
