"""Adaptive smoothed aggregation (αSA) — full multi-level bootstrap.

Reference parity: pyamg/aggregation/adaptive.py (``adaptive_sa_solver``
:113, ``initial_setup_stage`` :363, ``general_setup_stage`` :575,
``eliminate_local_candidates`` :31), implementing Brezina, Falgout,
MacLachlan, Manteuffel, McCormick, Ruge — "Adaptive Smoothed Aggregation
(αSA) Multigrid", SIAM Review 47(2), 2005.

Structure (host-staged setup, like the rest of the setup phase; the final
hierarchy's solve is the compiled device program):

* **initial stage** (Algorithm 3): a random vector is relaxed on ``A x = 0``
  and then *carried down the hierarchy as it is being built* — each level's
  restriction of the candidate is relaxed on that level's homogeneous
  system, and the coarsest representative is prolongated back up with
  relaxation at every level.  The aggregates and strength graphs found on
  the way down are frozen ('predefined') for all later stages.
* **general stage** (Algorithm 4): each additional candidate starts as a
  random vector run through the *current* solver on ``A x = 0`` (whatever
  error the solver cannot remove is exactly what the new candidate must
  represent), is refined level-by-level down the frozen hierarchy with
  sub-hierarchy cycles, and climbs back with per-level relaxation.
* **local elimination**: per-aggregate energy tests zero the candidate on
  aggregates where it is already small or well represented by the current
  tentative prolongator.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.utils import to_csr, unpack_arg
from ..util.linalg import approximate_spectral_radius, norm
from .aggregation import (smoothed_aggregation_solver, _strength, _aggregate,
                          _smooth_P)
from .tentative import fit_candidates

__all__ = ["adaptive_sa_solver", "eliminate_local_candidates",
           "initial_setup_stage"]

# host smoothers that take a `sweep` argument (jacobi/polynomial/schwarz
# and the Kaczmarz variants do not — passing sweep to them is a TypeError)
_SWEEP_SMOOTHERS = frozenset(["gauss_seidel", "sor", "block_gauss_seidel",
                              "gauss_seidel_indexed", "gauss_seidel_ne",
                              "gauss_seidel_nr"])


def _relax_zero(A, x, method, iterations):
    """Relax on A x = 0 in place (host); returns x."""
    from ..relaxation import relaxation as rel

    fn, kwargs = unpack_arg(method)
    if not hasattr(rel, fn):
        # device-only smoother names (zebra, chebyshev, ...) fall back to
        # Gauss-Seidel for the host-side candidate relaxation
        fn, kwargs = "gauss_seidel", {"sweep": "symmetric"}
    b = np.zeros(A.shape[0], dtype=A.dtype)
    kwargs = dict(kwargs)
    kwargs.pop("iterations", None)
    if fn in _SWEEP_SMOOTHERS:
        kwargs.setdefault("sweep", "symmetric")
    getattr(rel, fn)(A, x, b, iterations=iterations, **kwargs)
    # re-normalize: the candidate pipeline is scale-invariant (per-aggregate
    # QR fits, final inf-norm scaling), but repeated strong relaxation on
    # A x = 0 shrinks ||x|| geometrically — 15 zebra sweeps per level over
    # a deep hierarchy underflowed x to exactly 0 before this
    nrm = norm(x, "inf")
    if nrm > 0 and np.isfinite(nrm):
        x /= nrm
    return x


def eliminate_local_candidates(x, AggOp, A, T, Ca=1.0):
    """Zero the new candidate on aggregates where it is locally unneeded
    (reference adaptive.py:31).  ``x`` is modified in place.

    Two per-aggregate tests against the weight
    ``Ca * card(agg) * <Ax, x> / (n * rho(A))``:

    1. the candidate's local mass ``<x, x>_agg`` is already small, or
    2. the residual after projecting onto range(T) is small — the current
       tentative prolongator already represents it there.
    """
    AggOp = to_csr(AggOp)
    x = np.ravel(x) if x.ndim == 1 else x
    xv = np.ravel(x)
    ndof = xv.shape[0]
    n_nodes = AggOp.shape[0]
    npdes = ndof // n_nodes

    def agg_ip(z):
        """<z, z> restricted to each aggregate: (n_agg,) vector."""
        z2 = (np.abs(z) ** 2).reshape(n_nodes, npdes).sum(axis=1)
        return AggOp.T @ z2

    rho = approximate_spectral_radius(A)
    xAx = float(np.real(np.vdot(xv, A @ xv)))
    card = npdes * np.asarray(AggOp.sum(axis=0)).ravel()
    weights = Ca * card * xAx / (A.shape[0] * max(rho, 1e-300))

    mask = agg_ip(xv) <= weights                                  # test 1
    proj = xv - T @ (T.conjugate().T @ xv)
    mask |= agg_ip(proj) <= weights                               # test 2

    drop_aggs = np.nonzero(mask)[0]
    if drop_aggs.size:
        drop_nodes = AggOp[:, drop_aggs].tocsc().indices
        dofs = (npdes * drop_nodes[:, None]
                + np.arange(npdes)[None, :]).ravel()
        xv[dofs] = 0.0
    if x.ndim > 1:
        x[:] = xv.reshape(x.shape)
    return x


def initial_setup_stage(A, symmetry, pdef, candidate_iters, epsilon,
                        max_levels, max_coarse, aggregate, prepostsmoother,
                        smooth, strength, initial_candidate=None, seed=0,
                        structured_ok=False):
    """Algorithm 3 of Brezina et al.: build a trial hierarchy while carrying
    a relaxed candidate down every level, then bring the coarsest
    representative back up with per-level relaxation
    (reference adaptive.py:363).

    Returns ``(x, aggregate, strength, work)`` where aggregate/strength are
    'predefined' per-level option lists freezing the discovered aggregates.
    """
    from ..util.utils import (levelize_strength_or_aggregation,
                              levelize_smooth_or_improve_candidates)

    A = to_csr(A)
    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)
    max_levels, max_coarse, aggregate = levelize_strength_or_aggregation(
        aggregate, max_levels, max_coarse)
    smooth = levelize_smooth_or_improve_candidates(smooth, max_levels)

    rng = np.random.default_rng(seed)
    work = 0.0

    if initial_candidate is None:
        x = rng.random(A.shape[0]).astype(A.dtype)
        if np.iscomplexobj(np.zeros(1, dtype=A.dtype)):
            x = x + 1j * rng.random(A.shape[0])
    else:
        x = np.ravel(np.asarray(initial_candidate, dtype=A.dtype)).copy()

    x = _relax_zero(A, x, prepostsmoother, candidate_iters)
    work += 2 * A.nnz * candidate_iters

    # descend: build levels, restricting + relaxing the candidate.
    # On structured grids the trial hierarchy rides the SAME structured
    # machinery the final build uses (_extend_sa_hierarchy's grid fast
    # path): grid metadata propagates to every coarse operator, so the
    # candidate is relaxed with the actual cycle smoother (zebra needs
    # A.grid; the generic descent's coarse operators had none and silently
    # fell back to GS), and the banded stencil RAP replaces the scipy
    # SpGEMM chain (~3 s of the 1024^2 aSA setup).  Opt-in
    # (``structured_ok``): the structured descent does not produce frozen
    # 'predefined' aggregate/strength lists, so only callers that discard
    # them on grid problems (adaptive_sa_solver) enable it.
    grid0 = getattr(A, "grid", None)
    structured = (structured_ok and grid0 is not None
                  and int(np.prod(grid0)) == A.shape[0]
                  and symmetry in ("hermitian", "symmetric"))
    A_l = A
    As, Ps, aggs, strgs, xs = [A], [], [], [], [x]
    if structured:
        from ..multilevel import Level
        from .aggregation import _extend_sa_hierarchy

        lvl0 = Level()
        lvl0.A_csr = A
        lvl0.A_bsr = None
        lvl0.B = x[:, None]
        lvl0.blocksize = 1
        lvl0.symmetry = symmetry
        lvl0.grid = tuple(int(g) for g in grid0)
        fn0 = unpack_arg(prepostsmoother)[0]
        lvl0._line_smoother = fn0 in ("zebra", "line_jacobi",
                                      "line_gauss_seidel")
        slevels = [lvl0]
        none_improve = [None] * max_levels
        while A_l.shape[0] > max_coarse and len(As) < max_levels:
            slevels[-1].B = x[:, None]     # relaxed candidate drives T
            n_prev = slevels[-1].A_csr.shape[0]
            _extend_sa_hierarchy(slevels, strength, aggregate, smooth,
                                 none_improve, False, False, symmetry)
            if slevels[-1].A_csr.shape[0] == n_prev:
                break
            A_l = slevels[-1].A_csr
            Ps.append(to_csr(slevels[-2].P_csr))
            As.append(A_l)
            x = np.ravel(np.asarray(slevels[-1].B))
            if A_l.shape[0] > max_coarse and len(As) < max_levels:
                x = _relax_zero(A_l, x, prepostsmoother, candidate_iters)
                work += 2 * A_l.nnz * candidate_iters
            xs.append(x)
    while not structured and A_l.shape[0] > max_coarse \
            and len(As) < max_levels:
        i = len(As) - 1
        C = _strength(A_l, x[:, None], strength[i])
        AggOp, _ = _aggregate(C, A_l, x[:, None], aggregate[i])
        if AggOp.shape[1] == 0 or AggOp.shape[1] == AggOp.shape[0]:
            break
        T, x_c = fit_candidates(AggOp, x[:, None])
        P = _smooth_P(T, A_l, C, x_c, smooth[i],
                      sym_hint=symmetry != "nonsymmetric")
        R = P.conjugate().T.tocsr() if symmetry == "hermitian" \
            else P.T.tocsr()
        A_l = (R @ A_l @ P).tocsr()

        strgs.append(C)
        aggs.append(AggOp)
        Ps.append(to_csr(P))
        As.append(A_l)

        x = np.ravel(x_c)
        if A_l.shape[0] > max_coarse and len(As) < max_levels:
            # relax the restricted candidate on this level's homogeneous
            # system (step 4h) — the loop exit keeps the coarsest x as the
            # *relaxed* second-coarsest restriction
            x = _relax_zero(A_l, x, prepostsmoother, candidate_iters)
            work += 2 * A_l.nnz * candidate_iters
        xs.append(x)

    # climb: prolongate the coarsest candidate to the finest level,
    # relaxing on each level's homogeneous system along the way (step 5)
    x = xs[-1]
    for lev in range(len(Ps) - 1, -1, -1):
        x = Ps[lev] @ x
        x = _relax_zero(As[lev], x, prepostsmoother, candidate_iters)
        work += 2 * As[lev].nnz * candidate_iters

    aggregate = [("predefined", {"AggOp": aggs[i]})
                 for i in range(len(aggs))] if aggs else aggregate
    strength = [("predefined", {"C": strgs[i]})
                for i in range(len(strgs))] if strgs else strength
    return x, aggregate, strength, work


def _host_vcycle(As, Ps, i, x, b, prepostsmoother, candidate_iters=1,
                 Rs=None):
    """One host V-cycle on the (A, P) lists starting at level ``i`` (used to
    refine candidates on partially-updated sub-hierarchies without compiling
    device programs for every temporary solver).

    ``Rs``: optional precomputed restrictions (P^H per level) — forming
    P.conjugate().T on the fly copies P's data at every level of every
    cycle."""
    A = As[i]
    if i >= len(Ps) or Ps[i] is None or A.shape[0] <= 1:
        try:
            return np.linalg.lstsq(A.toarray(), b, rcond=None)[0]
        except np.linalg.LinAlgError:
            return x
    x = x.copy()
    _relax_rhs(A, x, b, prepostsmoother, candidate_iters)
    r = b - A @ x
    P = Ps[i]
    if Rs is not None and i < len(Rs) and Rs[i] is not None:
        bc = Rs[i] @ r
    else:
        bc = P.conjugate().T @ r
    xc = _host_vcycle(As, Ps, i + 1, np.zeros_like(bc), bc,
                      prepostsmoother, candidate_iters, Rs=Rs)
    x = x + P @ xc
    _relax_rhs(A, x, b, prepostsmoother, candidate_iters)
    return x


def _relax_rhs(A, x, b, method, iterations):
    from ..relaxation import relaxation as rel

    fn, kwargs = unpack_arg(method)
    if not hasattr(rel, fn):
        fn, kwargs = "gauss_seidel", {"sweep": "symmetric"}
    kwargs = dict(kwargs)
    kwargs.pop("iterations", None)
    if fn in _SWEEP_SMOOTHERS:
        kwargs.setdefault("sweep", "symmetric")
    getattr(rel, fn)(A, x, b, iterations=iterations, **kwargs)


def _bridge_rows(T, k):
    """Re-index a tentative prolongator whose rows live on a level with
    ``k`` dofs per node so they address the same node's dofs in an enlarged
    level with ``k+1`` dofs per node (the new dof rows are structurally
    empty) — the role of the reference's ``make_bridge``
    (adaptive.py:596-606)."""
    T = to_csr(T)
    m = T.shape[0] // k
    counts = np.diff(T.indptr).reshape(m, k)
    new_counts = np.hstack(
        [counts, np.zeros((m, 1), dtype=counts.dtype)]).ravel()
    new_indptr = np.concatenate(
        [np.zeros(1, dtype=T.indptr.dtype), np.cumsum(new_counts)])
    return sp.csr_matrix((T.data, T.indices, new_indptr),
                         shape=(m * (k + 1), T.shape[1]))


def _general_setup_stage(ml, A, symmetry, candidate_iters, prepostsmoother,
                         smooth, eliminate_local, seed):
    """Algorithm 4 of Brezina et al. (reference adaptive.py:575): generate
    one additional candidate from the current solver's slow-to-converge
    error, refine it level by level while rebuilding the hierarchy top-down
    in the *enlarged* candidate space (bridging the not-yet-updated coarse
    tentative prolongators), then relax it back up to the finest level.

    Returns (x, work).
    """
    rng = np.random.default_rng(seed)
    levels = ml.levels
    nl = len(levels)
    n = A.shape[0]
    work = 0.0

    x = rng.random(n).astype(A.dtype)
    if np.iscomplexobj(np.zeros(1, dtype=A.dtype)):
        x = x + 1j * rng.random(n)
    # run the current solver on A x = 0 with HOST V-cycles: this hierarchy
    # is applied candidate_iters times and then rebuilt, so compiling a
    # device program for it (seconds to minutes of XLA compile) can never
    # pay for itself
    As_full = [l.A_csr for l in levels]
    Ps_full = [getattr(l, "P_csr", None) for l in levels[:-1]]
    Rs_full = [getattr(l, "R_csr", None) for l in levels[:-1]]
    b0 = np.zeros(n, dtype=A.dtype)
    for _ in range(candidate_iters):
        x = _host_vcycle(As_full, Ps_full, 0, x, b0, prepostsmoother, 1,
                         Rs=Rs_full)
    work += 2 * ml.operator_complexity() * A.nnz * candidate_iters

    T0 = levels[0].T if hasattr(levels[0], "T") else None

    # host mirrors of the hierarchy, updated top-down during the descent
    As = [l.A_csr for l in levels]
    Ps = [getattr(l, "P_csr", None) for l in levels[:-1]]
    Ts = [getattr(l, "T", None) for l in levels[:-1]]
    Bs = [getattr(l, "B", None) for l in levels]
    Cs = [getattr(l, "C", None) for l in levels[:-1]]
    Aggs = [getattr(l, "AggOp", None) for l in levels[:-1]]
    metas = [getattr(l, "struct_meta", None) for l in levels[:-1]]

    def _resmooth_T(T_new, i, Bc_coarse):
        """Smooth a refit tentative prolongator the way the FINAL build
        will.  Structured levels reuse the structured smoother recipe
        (``jacobi_weak`` keeps strong-axis width 1, so the enlarged-space
        RAP chain stays banded-narrow — with the full generic Jacobi S the
        scipy SpGEMMs here dominate the whole αSA setup) and polish the
        candidate against the same coarse operators it will live in.
        Generic levels keep the reference's ``_smooth_P`` path."""
        from .aggregation import structured_smoother_S

        meta = metas[i]
        if meta is not None:
            A_i = As[i]
            if A_i is levels[i].A_csr:
                S, degree = meta["S_csr"], meta["degree"]
            else:
                # the descent replaced this level's operator with its
                # enlarged-candidate-space version: rebuild S on it (the
                # dofs-per-node count q comes off the operator itself)
                q_i = A_i.shape[0] // int(np.prod(meta["grid"]))
                S, degree = structured_smoother_S(
                    A_i, meta["grid"], meta["block"], q_i,
                    meta["sfn"], meta["skw"], symmetry)
            P = to_csr(T_new)
            for _ in range(degree):
                P = (S @ P).tocsr()
            return P
        return to_csr(_smooth_P(to_csr(T_new), As[i], Cs[i], Bc_coarse,
                                smooth[i],
                                sym_hint=symmetry != "nonsymmetric"))

    xs = [x]
    for i in range(nl - 2):
        if Aggs[i] is None or Bs[i] is None:
            break
        # refit level i's tentative prolongator with the candidate appended
        B_aug = np.column_stack([Bs[i], xs[-1]])
        T_new, Bc = fit_candidates(Aggs[i], B_aug)
        P_new = _resmooth_T(T_new, i, Bc)
        As[i + 1] = (P_new.conjugate().T @ As[i] @ P_new).tocsr()
        Ps[i] = P_new
        x_c = np.ravel(np.asarray(Bc)[:, -1]).copy()

        # bridge level i+1's tentative prolongator into the enlarged space
        # and re-smooth it on the new coarse operator, so the old
        # sub-hierarchy below can polish the restricted candidate
        if i + 1 < nl - 1 and Ts[i + 1] is not None:
            k_old = Bs[i + 1].shape[1]
            T_b = _bridge_rows(Ts[i + 1], k_old)
            P_b = _resmooth_T(T_b, i + 1, Bs[i + 2])
            Ps[i + 1] = P_b
            Ts[i + 1] = T_b
            As[i + 2] = (P_b.conjugate().T @ As[i + 1] @ P_b).tocsr()
            # old candidates re-expressed in the enlarged space
            Bs[i + 1] = np.asarray(Bc)[:, :-1]
            # polish the restricted candidate with sub-hierarchy cycles
            for _ in range(max(candidate_iters // 2, 1)):
                x_c = _host_vcycle(As, Ps, i + 1, x_c,
                                   np.zeros_like(x_c), prepostsmoother, 1)
            work += 2 * sum(a.nnz for a in As[i + 1:]) * candidate_iters
        else:
            x_c = _relax_zero(As[i + 1], x_c, prepostsmoother,
                              candidate_iters)
            work += 2 * As[i + 1].nnz * candidate_iters
        xs.append(x_c)

    # climb back, relaxing the prolongated candidate at every level; use
    # indexed relaxation at the candidate's support so locally-eliminated
    # regions stay zero (reference adaptive.py:713-717)
    from ..relaxation.relaxation import gauss_seidel_indexed

    x = xs[-1]
    for i in range(len(xs) - 2, -1, -1):
        x = Ps[i] @ x
        fn, _kw = unpack_arg(prepostsmoother)
        if fn == "gauss_seidel":
            idx = np.nonzero(np.ravel(x))[0]
            gauss_seidel_indexed(As[i], x, np.zeros_like(x), idx,
                                 iterations=candidate_iters,
                                 sweep="symmetric")
        else:
            x = _relax_zero(As[i], x, prepostsmoother, candidate_iters)
        work += 2 * As[i].nnz * candidate_iters

    elim, elim_kwargs = unpack_arg(eliminate_local)
    if elim is True and T0 is not None and Aggs[0] is not None:
        nrm = norm(x, "inf")
        if nrm > 0:
            x = x / nrm
        eliminate_local_candidates(x, Aggs[0], A, to_csr(T0), **elim_kwargs)

    return x, work


def adaptive_sa_solver(A, initial_candidates=None, symmetry="hermitian",
                       pdef=True, num_candidates=1, candidate_iters=5,
                       improvement_iters=0, epsilon=0.1,
                       max_levels=10, max_coarse=100,
                       aggregate="standard",
                       prepostsmoother=("gauss_seidel",
                                        {"sweep": "symmetric"}),
                       smooth=("jacobi", {}), strength="symmetric",
                       coarse_solver="pinv",
                       eliminate_local=(False, {"Ca": 1.0}),
                       keep=False, seed=0, **kwargs):
    """Create an adaptive SA solver; returns ``(ml, work)``
    (reference adaptive.py:113).

    ``num_candidates`` is the *total* number of near-nullspace candidates
    (the initial stage provides the first; the general stage adds the rest).
    ``work`` is the setup work estimate in units of fine-level nnz.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu.gallery import poisson
    >>> from pyamg_tpu.aggregation import adaptive_sa_solver
    >>> A = poisson((16, 16), format='csr')
    >>> ml, work = adaptive_sa_solver(A, num_candidates=1, max_coarse=20)
    >>> b = np.ones(A.shape[0])
    >>> res = []
    >>> x = ml.solve(b, tol=1e-8, residuals=res)
    >>> res[-1] < 1e-8 * res[0] and work > 0
    True
    """
    A = to_csr(A)
    work = 0.0

    def build(B, agg, strg, keep_flag=True, device=False):
        # intermediate hierarchies are host-only (device=False): they exist
        # to produce candidates / frozen aggregates, never to run compiled
        # device cycles, so the H2D uploads + smoother-state builds of a
        # full finalize would be pure setup overhead
        return smoothed_aggregation_solver(
            A, B=B, symmetry=symmetry, strength=strg,
            aggregate=agg, smooth=smooth,
            presmoother=prepostsmoother, postsmoother=prepostsmoother,
            improve_candidates=None,
            max_levels=max_levels, max_coarse=max_coarse,
            coarse_solver=coarse_solver, keep=keep_flag,
            finalize_device=device, **kwargs)

    # ---- initial stage: first candidate + frozen aggregates --------------
    if initial_candidates is None:
        x, aggregate_f, strength_f, w = initial_setup_stage(
            A, symmetry, pdef, candidate_iters, epsilon, max_levels,
            max_coarse, aggregate, prepostsmoother, smooth, strength,
            seed=seed, structured_ok=True)
        work += w
        if getattr(A, "grid", None) is None:
            aggregate, strength = aggregate_f, strength_f
        # else: keep the caller's aggregation — on a structured grid the
        # builds take the grid-block fast path (deterministic aggregates,
        # DIA/BDIA device operators), which 'predefined' lists would defeat
        nrm = norm(x, "inf")
        B = (x / (nrm if nrm else 1.0))[:, None].astype(A.dtype)
    else:
        B = np.asarray(initial_candidates, dtype=A.dtype)
        if B.ndim == 1:
            B = B[:, None]
        # freeze aggregates from a trial hierarchy built on the given B
        sa = build(B, aggregate, strength, keep_flag=True)
        if len(sa.levels) > 1 \
                and all(getattr(l, "AggOp", None) is not None
                        for l in sa.levels[:-1]):
            aggregate = [("predefined",
                          {"AggOp": to_csr(sa.levels[i].AggOp)})
                         for i in range(len(sa.levels) - 1)]
            if all(getattr(l, "C", None) is not None
                   for l in sa.levels[:-1]):
                strength = [("predefined", {"C": to_csr(sa.levels[i].C)})
                            for i in range(len(sa.levels) - 1)]

    ml = build(B, aggregate, strength, keep_flag=True)

    from ..util.utils import levelize_smooth_or_improve_candidates

    smooth_lv = levelize_smooth_or_improve_candidates(smooth, max_levels)

    # ---- general stage: additional candidates ----------------------------
    while B.shape[1] < num_candidates:
        x, w = _general_setup_stage(ml, A, symmetry, candidate_iters,
                                    prepostsmoother, smooth_lv,
                                    eliminate_local, seed + B.shape[1])
        work += w
        nrm = norm(x, "inf")
        if nrm == 0 or not np.isfinite(nrm):
            break
        B = np.column_stack([B, x / nrm])
        if B.shape[1] < num_candidates:
            # only the NEXT general stage consumes this intermediate
            # hierarchy; when the candidate set is complete, skip straight
            # to the final (device-finalized) build below
            ml = build(B, aggregate, strength, keep_flag=True)

    # ---- improvement iterations (reference adaptive.py:301-340) ----------
    if B.shape[1] > 1 and improvement_iters > 0:
        b0 = np.zeros(A.shape[0], dtype=A.dtype)
        for _ in range(improvement_iters):
            for _j in range(B.shape[1]):
                # rebuild on everything except the oldest candidate; run the
                # solver on A x = 0 from it; re-append the improved version
                x0 = B[:, 0].copy()
                B = B[:, 1:]
                sa_tmp = build(B, aggregate, strength, keep_flag=True)
                # host V-cycles: the temporary solver is applied only
                # candidate_iters times (see _general_setup_stage)
                As_t = [l.A_csr for l in sa_tmp.levels]
                Ps_t = [getattr(l, "P_csr", None)
                        for l in sa_tmp.levels[:-1]]
                Rs_t = [getattr(l, "R_csr", None)
                        for l in sa_tmp.levels[:-1]]
                x = x0
                for _ in range(candidate_iters):
                    x = _host_vcycle(As_t, Ps_t, 0, x, b0,
                                     prepostsmoother, 1, Rs=Rs_t)
                work += (2 * sa_tmp.operator_complexity() * A.nnz
                         * candidate_iters)
                elim, elim_kwargs = unpack_arg(eliminate_local)
                if elim is True and hasattr(sa_tmp.levels[0], "AggOp"):
                    x = x / max(norm(x, "inf"), 1e-300)
                    eliminate_local_candidates(
                        x, sa_tmp.levels[0].AggOp, A, sa_tmp.levels[0].T,
                        **elim_kwargs)
                nrm = norm(x, "inf")
                B = np.column_stack([B, x / (nrm if nrm else 1.0)])
        ml = build(B, aggregate, strength, keep_flag=keep, device=True)
    elif improvement_iters > 0:
        # single candidate: repeat the initial descent from the current B
        for _ in range(improvement_iters):
            x, aggregate_f2, strength_f2, w = initial_setup_stage(
                A, symmetry, pdef, candidate_iters, epsilon,
                len(aggregate) + 1 if isinstance(aggregate, list)
                else max_levels,
                max_coarse, aggregate, prepostsmoother, smooth, strength,
                initial_candidate=B[:, 0], seed=seed, structured_ok=True)
            work += w
            if getattr(A, "grid", None) is None:
                aggregate, strength = aggregate_f2, strength_f2
            B = (x / max(norm(x, "inf"), 1e-300))[:, None].astype(A.dtype)
        ml = build(B, aggregate, strength, keep_flag=keep, device=True)
    else:
        # final (device-finalized) hierarchy
        ml = build(B, aggregate, strength, keep_flag=keep, device=True)

    return ml, float(work) / max(A.nnz, 1)
