"""Adaptive SA rewrite with Ritz-based target filtering (fork feature).

Reference parity: pyamg/aggregation/new_adaptive.py (``asa_solver`` :343,
recursive ``try_solve`` :523, ``global_ritz_process`` :179,
``local_ritz_process`` :254, ``test_level_conv`` :520).

The driver is *recursive per level*: each level bootstraps its own targets
by relaxation on the homogeneous system, Ritz-filters them globally (WAP in
the A² inner product) and locally (per-aggregate minimal basis, which IS the
tentative prolongator), builds the coarse operator, recurses, and keeps
adding targets until the sub-hierarchy's measured convergence factor clears
``conv_tol`` or the iteration caps hit.

Device notes: the per-aggregate Ritz decompositions run as ONE batched
``eigh`` over zero-padded aggregate blocks (the same batching pattern as
``fit_candidates``); trial convergence tests run host V-cycles so no device
programs are compiled for throwaway hierarchies — only the final accepted
hierarchy is finalized into compiled device form.

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu.aggregation.new_adaptive import A_norm
>>> float(A_norm(np.ones(4), np.eye(4)))       # sqrt(x^T A x)
2.0
>>> from pyamg_tpu.gallery import poisson
>>> from pyamg_tpu.aggregation.new_adaptive import asa_solver
>>> ml = asa_solver(poisson((64,), format='csr'), max_targets=1)
>>> b = np.ones(64)
>>> x = ml.solve(b, tol=1e-8, maxiter=100, accel='cg')
>>> bool(np.linalg.norm(b - poisson((64,), format='csr') @
...      np.asarray(x, dtype=float)) < 1e-6 * np.linalg.norm(b))
True
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.utils import to_csr
from ..util.linalg import approximate_spectral_radius
from .aggregation import _strength, _aggregate, _smooth_P

__all__ = ["asa_solver", "tl_sa_solver", "global_ritz_process",
           "local_ritz_process", "A_norm", "my_rand"]


def A_norm(x, A):
    """Energy norm ``sqrt(x^H A x)`` (reference new_adaptive.py:46)."""
    x = np.ravel(np.asarray(x))
    return np.sqrt(np.real(np.vdot(x, A @ x)))


def my_rand(d1, d2, zero_crossings=True):
    """Uniform random ``(d1, d2)`` array in [-1, 1] (or [0, 1] when
    ``zero_crossings`` is False) — reference new_adaptive.py:53."""
    x = np.random.default_rng().random((d1, d2))
    return (x - 0.5) * 2.0 if zero_crossings else x


def global_ritz_process(A, B1, B2=None, weak_tol=15.0, verbose=False):
    """Compress [B1, B2] into an energy-orthonormal target set, dropping
    targets that trivially satisfy the weak approximation property
    (reference new_adaptive.py:179).

    Ritz-decomposes A² restricted to span([B1, B2]); targets are kept in
    ascending-eigenvalue order while ``1/E_j > weak_tol / rho(A)``; at least
    one survives.  Returned columns are scaled to unit A-norm.
    """
    A = to_csr(A)
    B = np.asarray(B1)
    if B.ndim == 1:
        B = B[:, None]
    if B2 is not None:
        B2 = np.asarray(B2)
        B = np.column_stack([B, B2.reshape(B.shape[0], -1)])

    Q, _ = np.linalg.qr(B)
    AQ = A @ Q
    G = AQ.conj().T @ AQ                       # WAP in the A^2 inner product
    G = 0.5 * (G + G.conj().T)
    evals, evecs = np.linalg.eigh(G)
    evals = np.maximum(evals.real, 1e-300)
    V = Q @ evecs

    cutoff = weak_tol / approximate_spectral_radius(A)
    keep = V.shape[1]
    for j in range(V.shape[1]):
        if 1.0 / evals[j] <= cutoff:
            keep = j
            break
    keep = max(keep, 1)
    V = V[:, :keep] / np.sqrt(evals[None, :keep])
    if verbose:
        print(f"global Ritz: kept {keep}/{B.shape[1]} targets")
    return V


def local_ritz_process(A, AggOp, B, weak_tol=15.0, verbose=False):
    """Per-aggregate minimal local basis of the targets — the result IS the
    tentative prolongator (reference new_adaptive.py:254).

    In each aggregate, eigh of the local Gram ``Ba^H Ba`` keeps the
    directions whose energy exceeds ``card(agg) * (weak_tol/rho(A)) / nnz``
    (at least one per aggregate), scaled by ``1/sqrt(E)``.  All aggregates
    are processed in ONE zero-padded batched ``eigh``.

    Returns ``(T, per_agg)``: the tentative prolongator and the number of
    basis vectors kept per aggregate.
    """
    A = to_csr(A)
    AggOp = sp.csr_matrix(AggOp)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    n, K = B.shape
    n_nodes, n_agg = AggOp.shape
    npdes = n // n_nodes

    tol = weak_tol / approximate_spectral_radius(A)
    total_nnz = max(AggOp.getnnz(), 1)

    # batched aggregate gather (zero-padded), as in fit_candidates
    Acsc = AggOp.tocsc()
    sizes = np.diff(Acsc.indptr)
    max_nodes = int(sizes.max()) if n_agg else 0
    node_idx = np.full((n_agg, max_nodes), -1, dtype=np.int64)
    agg_of = np.repeat(np.arange(n_agg), sizes)
    pos = np.arange(Acsc.indices.size) - np.repeat(Acsc.indptr[:-1], sizes)
    node_idx[agg_of, pos] = Acsc.indices
    valid = node_idx >= 0
    safe = np.where(valid, node_idx, 0)
    L = max_nodes * npdes
    dof_idx = (safe[:, :, None] * npdes
               + np.arange(npdes)[None, None, :]).reshape(n_agg, L)
    dvalid = np.repeat(valid, npdes, axis=1)
    Ba = B[dof_idx] * dvalid[:, :, None]       # (n_agg, L, K)

    G = np.einsum("alk,alm->akm", Ba.conj(), Ba)        # batched Gram
    evals, evecs = np.linalg.eigh(G)                    # ascending
    evals = evals[:, ::-1].real                          # descending
    evecs = evecs[:, :, ::-1]

    # per-aggregate retention: E_j > card(agg)*tol/total_nnz, at least 1
    local_const = (sizes * npdes)[:, None] * tol / total_nnz
    keep = evals > local_const                           # (n_agg, K)
    counts = np.maximum(keep.sum(axis=1), 1)

    # local bases Ba @ V_j / sqrt(E_j) for kept j
    scale = 1.0 / np.sqrt(np.maximum(evals, 1e-300))
    basis = np.einsum("alk,akm->alm", Ba, evecs) * scale[:, None, :]

    # assemble T in COO: aggregate a contributes counts[a] columns over its
    # dof rows
    col_of_agg = np.concatenate([[0], np.cumsum(counts)])
    n_cols = int(col_of_agg[-1])
    rows_per_agg = sizes * npdes
    nnz_per_agg = rows_per_agg * counts
    total = int(nnz_per_agg.sum())
    rows = np.empty(total, dtype=np.int64)
    cols = np.empty(total, dtype=np.int64)
    vals = np.empty(total, dtype=B.dtype)
    ptr = 0
    for a in range(n_agg):                 # light loop: O(n_agg) bookkeeping
        r = dof_idx[a][dvalid[a]]
        c = counts[a]
        blk = basis[a][dvalid[a], :c]      # (rows_a, c)
        m = r.size * c
        rows[ptr:ptr + m] = np.repeat(r, c)
        cols[ptr:ptr + m] = np.tile(np.arange(col_of_agg[a],
                                              col_of_agg[a] + c), r.size)
        vals[ptr:ptr + m] = blk.reshape(-1)
        ptr += m
    T = sp.csr_matrix((vals[:ptr], (rows[:ptr], cols[:ptr])),
                      shape=(n, n_cols))
    if verbose:
        print(f"local Ritz: {n_cols} columns from {K}x{n_agg} potential")
    return T, counts


def _relax_targets(A, num, iters, prepostsmoother, seed, work):
    """Initial targets: random vectors relaxed on A x = 0
    (reference tl_initial_target :471)."""
    from .adaptive import _relax_zero

    rng = np.random.default_rng(seed)
    ts = []
    for _ in range(max(num, 1)):
        x = rng.random(A.shape[0]).astype(A.dtype) - 0.5
        if np.iscomplexobj(np.zeros(1, dtype=A.dtype)):
            x = x + 1j * (rng.random(A.shape[0]) - 0.5)
        x = _relax_zero(A, x, prepostsmoother, iters)
        work[0] += 2 * A.nnz * iters
        ts.append(x)
    return np.column_stack(ts)


def _a_norm(x, A):
    return float(np.sqrt(abs(np.vdot(x, A @ x))))


def _test_level_conv(levels, level, iters, prepostsmoother, work, seed):
    """Measured convergence factor of host V-cycles on levels[level:]
    applied to the homogeneous system (reference test_level_conv :520).
    Returns (slow_error_vector, factor)."""
    from .adaptive import _host_vcycle

    As = [lvl.A for lvl in levels[level:]]
    Ps = [getattr(lvl, "P", None) for lvl in levels[level:]]
    rng = np.random.default_rng(seed)
    A = As[0]
    x = rng.random(A.shape[0]).astype(A.dtype) - 0.5
    if np.iscomplexobj(np.zeros(1, dtype=A.dtype)):
        x = x + 1j * (rng.random(A.shape[0]) - 0.5)
    prev = _a_norm(x, A)
    factor = 1.0
    b = np.zeros_like(x)
    for _ in range(max(iters, 2)):
        x = _host_vcycle(As, Ps, 0, x, b, prepostsmoother, 1)
        cur = _a_norm(x, A)
        factor = cur / max(prev, 1e-300)
        prev = cur
        work[0] += 2 * sum(a.nnz for a in As)
    return x, factor


class _HostLevel:
    pass


def _try_solve(A_l, levels, level, *, max_targets, min_targets,
               num_initial_targets, targets_iters, conv_tol, weak_tol,
               local_weak_tol, coarse_size, smooth, strength, aggregate,
               max_levels, max_level_iterations, prepostsmoother, work,
               verbose, seed, initial_B=None):
    """Recursive per-level adaptive construction (reference try_solve :523)."""
    if level >= len(levels):
        levels.append(_HostLevel())
    else:
        levels[level] = _HostLevel()
        del levels[level + 1:]
    cur = levels[level]
    cur.A = A_l

    if A_l.shape[0] <= coarse_size or level >= max_levels - 1:
        return

    if initial_B is not None:
        B = np.asarray(initial_B, dtype=A_l.dtype)
        if B.ndim == 1:
            B = B[:, None]
    else:
        B = _relax_targets(A_l, num_initial_targets, targets_iters,
                           prepostsmoother, seed + level, work)
    C = _strength(A_l, B, strength)
    AggOp, _ = _aggregate(C, A_l, B, aggregate)

    B = global_ritz_process(A_l, B, weak_tol=weak_tol, verbose=verbose)
    T, _per_agg = local_ritz_process(A_l, AggOp, B,
                                     weak_tol=local_weak_tol,
                                     verbose=verbose)
    cur.B, cur.T, cur.AggOp, cur.C = B, T, AggOp, C

    factor = np.inf
    count = 0
    while count < max_level_iterations:
        P = to_csr(_smooth_P(cur.T, A_l, cur.C, cur.B, smooth))
        cur.P = P
        cur.R = P.conjugate().T.tocsr()
        Ac = (cur.R @ A_l @ P).tocsr()

        _try_solve(Ac, levels, level + 1, max_targets=max_targets,
                   min_targets=min_targets,
                   num_initial_targets=num_initial_targets,
                   targets_iters=targets_iters, conv_tol=conv_tol,
                   weak_tol=weak_tol, local_weak_tol=local_weak_tol,
                   coarse_size=coarse_size, smooth=smooth,
                   strength=strength, aggregate=aggregate,
                   max_levels=max_levels,
                   max_level_iterations=max_level_iterations,
                   prepostsmoother=prepostsmoother, work=work,
                   verbose=verbose, seed=seed + 7)

        t, factor = _test_level_conv(levels, level, targets_iters,
                                     prepostsmoother, work,
                                     seed + 13 * count)
        if verbose:
            print("  " * level + f"level {level}: conv factor {factor:.3f} "
                  f"with {cur.B.shape[1]} target(s)")
        if factor <= conv_tol and cur.B.shape[1] >= min_targets:
            return
        if cur.B.shape[1] >= max_targets:
            return
        count += 1
        if count >= max_level_iterations:
            # iteration cap: exit WITHOUT touching B/T so the stored level
            # metadata stays consistent with the P/R actually built
            return
        # the slow error is the next target
        B = global_ritz_process(A_l, cur.B, t, weak_tol=weak_tol,
                                verbose=verbose)
        T, _per_agg = local_ritz_process(A_l, cur.AggOp, B,
                                         weak_tol=local_weak_tol,
                                         verbose=verbose)
        cur.B, cur.T = B, T


def tl_sa_solver(A, B=None, max_targets=4, min_targets=0,
                 num_initial_targets=1, targets_iters=10, conv_tol=0.5,
                 weak_tol=15.0, local_weak_tol=15.0, max_coarse=100,
                 coarse_size=None, max_levels=20, max_level_iterations=4,
                 prepostsmoother=("gauss_seidel", {"sweep": "symmetric"}),
                 smooth=("richardson", {"omega": 1.0}),
                 strength="symmetric", aggregate="standard",
                 coarse_solver="pinv", verbose=False, seed=0, **kwargs):
    """Recursive adaptive SA (reference tl_sa_solver/asa_solver :343).

    Builds the hierarchy depth-first: each level adaptively discovers its
    own Ritz-filtered target set until the measured convergence factor of
    the sub-hierarchy clears ``conv_tol``.  Returns a MultilevelSolver whose
    cycle is the usual compiled device program.
    """
    # accept legacy aliases used by earlier revisions/tests
    if "max_candidates" in kwargs:
        max_targets = kwargs.pop("max_candidates")
    if "improvement_iters" in kwargs:
        max_level_iterations = max(kwargs.pop("improvement_iters") // 2, 1)
    kwargs.pop("target_convergence", None)
    if kwargs:
        import warnings

        warnings.warn("tl_sa_solver ignoring unsupported options: "
                      f"{sorted(kwargs)}")

    from ..multilevel import MultilevelSolver, Level
    from ..relaxation.smoothing import change_smoothers
    from .aggregation import _finalize_device_operators

    A = to_csr(A)
    if coarse_size is None:
        coarse_size = max_coarse
    work = [0.0]
    host_levels = []
    B0 = None
    if B is not None:
        # a supplied initial target set seeds the finest level's bootstrap
        B0 = np.asarray(B, dtype=A.dtype)
        if B0.ndim == 1:
            B0 = B0[:, None]
    _try_solve(A, host_levels, 0, initial_B=B0, max_targets=max_targets,
               min_targets=min_targets,
               num_initial_targets=num_initial_targets,
               targets_iters=targets_iters, conv_tol=conv_tol,
               weak_tol=weak_tol, local_weak_tol=local_weak_tol,
               coarse_size=coarse_size, smooth=smooth, strength=strength,
               aggregate=aggregate, max_levels=max_levels,
               max_level_iterations=max_level_iterations,
               prepostsmoother=prepostsmoother, work=work, verbose=verbose,
               seed=seed)

    levels = []
    for hl in host_levels:
        lvl = Level()
        lvl.A_csr = hl.A
        if hasattr(hl, "P"):
            lvl.P_csr = hl.P
            lvl.R_csr = hl.R
            lvl.B = hl.B
            lvl.AggOp = hl.AggOp
            lvl.T = hl.T
            lvl.C = hl.C
        lvl.blocksize = 1
        levels.append(lvl)
    _finalize_device_operators(levels)
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver)
    change_smoothers(ml, prepostsmoother, prepostsmoother)
    ml._asa_work = work[0] / max(A.nnz, 1)
    return ml


def asa_solver(A, B=None, **kwargs):
    """Adaptive SA solver (fork rewrite; reference new_adaptive.py:343).
    Returns a MultilevelSolver (setup work estimate on ``ml._asa_work``)."""
    return tl_sa_solver(A, B=B, **kwargs)
