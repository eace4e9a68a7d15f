"""Aggregation methods for smoothed aggregation AMG.

Reference parity: pyamg/aggregation/aggregate.py (``standard_aggregation``
:20, ``naive_aggregation`` :106, ``lloyd_aggregation`` :189,
``pairwise_aggregation`` :285) and amg_core kernels
(smoothed_aggregation.h:122,245).

Returns (AggOp, Cpts): AggOp is the (n_nodes, n_aggregates) CSR indicator
matrix; Cpts are root/seed nodes where defined.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.utils import to_csr

__all__ = ["standard_aggregation", "naive_aggregation", "lloyd_aggregation",
           "pairwise_aggregation", "parallel_aggregation", "grid_aggregation",
           "fit_aggop"]


def grid_aggregation(grid, block=None):
    """Block aggregation on a structured grid: aggregate (i1//b1, ..., id//bd).

    The gather-free structured coarsening: the coarse grid is again a
    row-major grid, so every Galerkin coarse operator stays a fixed-offset
    stencil matrix (DIA format) and transfers are reshape/repeat ops — no
    gathers anywhere in the cycle.  Semantically a 'predefined' aggregation
    in the reference's terms (aggregation.py:355-371 option handling).

    Returns (AggOp, roots, coarse_grid).
    """
    grid = tuple(int(g) for g in grid)
    d = len(grid)
    if block is None:
        block = (3,) * d
    block = tuple(int(b) for b in block)
    cgrid = tuple(-(-g // b) for g, b in zip(grid, block))
    N = int(np.prod(grid))
    coords = np.unravel_index(np.arange(N), grid)
    labels = np.ravel_multi_index(
        tuple(c // b for c, b in zip(coords, block)), cgrid)
    AggOp = fit_aggop(labels, int(np.prod(cgrid)))
    # root of each aggregate: the member nearest the block center
    ccoords = np.unravel_index(np.arange(int(np.prod(cgrid))), cgrid)
    root_coords = tuple(
        np.minimum(cc * b + b // 2, g - 1)
        for cc, b, g in zip(ccoords, block, grid))
    roots = np.ravel_multi_index(root_coords, grid)
    return AggOp, roots, cgrid


def fit_aggop(labels, n_agg=None):
    """Build the CSR aggregate-indicator operator from a label vector
    (-1 = unaggregated)."""
    labels = np.asarray(labels, dtype=np.int64)
    n = labels.shape[0]
    if n_agg is None:
        n_agg = int(labels.max()) + 1 if (labels >= 0).any() else 0
    rows = np.flatnonzero(labels >= 0)
    A = sp.coo_matrix((np.ones(rows.size), (rows, labels[rows])),
                      shape=(n, n_agg)).tocsr()
    return A


def standard_aggregation(C):
    """Three-pass greedy aggregation over the strength graph
    (≙ smoothed_aggregation.h:122-221).

    Pass 1: node with all-unaggregated neighborhood seeds a new aggregate.
    Pass 2: unaggregated nodes join a neighboring aggregate.
    Pass 3: leftovers seed aggregates with their unaggregated neighbors.

    Uses the native C++ kernel (amg_core/core.cpp) when available.
    """
    C = to_csr(C)
    from ..amg_core import standard_aggregation_native

    native = standard_aggregation_native(C)
    if native is not None:
        labels, roots = native
        n_agg = int(labels.max()) + 1 if (labels >= 0).any() else 0
        return fit_aggop(labels, n_agg), roots
    n = C.shape[0]
    indptr, indices = C.indptr, C.indices

    labels = np.full(n, -1, dtype=np.int64)
    roots = []
    next_agg = 0

    # pass 1
    for i in range(n):
        if labels[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        nbrs = nbrs[nbrs != i]
        if nbrs.size == 0:
            # isolated: skip (no aggregate, zero row in AggOp)
            labels[i] = -n - 1   # mark as permanently isolated
            continue
        if (labels[nbrs] == -1).all():
            labels[i] = next_agg
            labels[nbrs] = next_agg
            roots.append(i)
            next_agg += 1

    # pass 2: attach to a neighboring aggregate (first found)
    pass2_join = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        if labels[i] != -1:
            continue
        for j in indices[indptr[i]:indptr[i + 1]]:
            if labels[j] >= 0:
                pass2_join[i] = labels[j]
                break
    newly = pass2_join >= 0
    labels[newly] = pass2_join[newly]

    # pass 3
    for i in range(n):
        if labels[i] != -1:
            continue
        labels[i] = next_agg
        roots.append(i)
        for j in indices[indptr[i]:indptr[i + 1]]:
            if labels[j] == -1 and j != i:
                labels[j] = next_agg
        next_agg += 1

    labels[labels < -1] = -1
    AggOp = fit_aggop(labels, next_agg)
    return AggOp, np.array(roots, dtype=np.int64)


def naive_aggregation(C):
    """Single-pass greedy aggregation (≙ smoothed_aggregation.h:245)."""
    C = to_csr(C)
    from ..amg_core import naive_aggregation_native

    native = naive_aggregation_native(C)
    if native is not None:
        labels, roots = native
        return fit_aggop(labels, len(roots)), roots
    n = C.shape[0]
    indptr, indices = C.indptr, C.indices

    labels = np.full(n, -1, dtype=np.int64)
    roots = []
    next_agg = 0
    for i in range(n):
        if labels[i] >= 0:
            continue
        labels[i] = next_agg
        roots.append(i)
        for j in indices[indptr[i]:indptr[i + 1]]:
            if labels[j] == -1:
                labels[j] = next_agg
        next_agg += 1
    AggOp = fit_aggop(labels, next_agg)
    return AggOp, np.array(roots, dtype=np.int64)


def lloyd_aggregation(C, ratio=0.03, distance="unit", maxiter=10, seed=0):
    """Lloyd-clustering aggregation (reference aggregate.py:274 →
    graph.h:389)."""
    from ..graph import lloyd_cluster

    C = to_csr(C)
    n = C.shape[0]
    if ratio <= 0 or ratio > 1:
        raise ValueError("ratio must be > 0.0 and <= 1.0")

    G = C.copy()
    if distance == "unit":
        G.data = np.ones_like(G.data, dtype=np.float64)
    elif distance == "abs":
        G.data = np.abs(G.data)
    elif distance == "inv":
        with np.errstate(divide="ignore"):
            G.data = 1.0 / np.abs(G.data)
    elif distance == "same":
        G = C
    elif distance == "sub":
        G.data = G.data - np.abs(G.data).min()
    else:
        raise ValueError(f"unrecognized distance metric {distance!r}")

    num_seeds = max(1, int(min(n, np.ceil(ratio * n))))
    rng = np.random.default_rng(seed)
    seeds = rng.choice(n, size=num_seeds, replace=False)
    _, clusters, seeds = lloyd_cluster(G, seeds, maxiter=maxiter)
    AggOp = fit_aggop(clusters, num_seeds)
    return AggOp, np.asarray(seeds)


def parallel_aggregation(C, seed=0):
    """Fully vectorized round-based aggregation (device-friendly formulation
    of ``standard_aggregation``): distance-2 MIS roots via weighted-Luby
    rounds, then two sweeps attaching nodes to the nearest root's aggregate.

    Same aggregate semantics as the reference's 3-pass greedy
    (smoothed_aggregation.h:122) — roots are mutually non-adjacent, every
    node lies within distance 2 of its root — but built from O(rounds)
    whole-graph vectorized passes instead of a sequential node loop.
    """
    C = to_csr(C)
    n = C.shape[0]
    G = C.copy()
    G.data = np.ones_like(G.data, dtype=np.float64)
    G.setdiag(0)
    G.eliminate_zeros()
    rows = np.repeat(np.arange(n), np.diff(G.indptr))
    cols = G.indices

    iso = np.diff(G.indptr) == 0

    # --- pass 1: distance-2 MIS on the strength graph (Luby rounds) ------
    rng = np.random.default_rng(seed)
    weight = rng.random(n)
    # state: 0 undecided, 1 root, -1 covered
    state = np.zeros(n, dtype=np.int8)
    state[iso] = -1
    labels = np.full(n, -1, dtype=np.int64)

    while (state == 0).any():
        active = state == 0
        w = np.where(active, weight + np.arange(n) * 1e-12, -np.inf)
        # winner iff w_i is the strict max over its distance-1 neighborhood
        # and the (weak) max over every neighbor's neighborhood — with the
        # unique tie-broken weights this is exactly a distance-2 MIS
        nbr1 = np.full(n, -np.inf)
        m = active[rows] & active[cols]
        np.maximum.at(nbr1, rows[m], w[cols[m]])
        nbr2 = np.full(n, -np.inf)
        np.maximum.at(nbr2, rows[m], nbr1[cols[m]])
        winners = active & (w > nbr1) & (w >= nbr2)
        if not winners.any():
            cand = np.where(active, w, -np.inf)
            winners = np.zeros(n, dtype=bool)
            winners[int(np.argmax(cand))] = True
        state[winners] = 1
        # cover the distance-2 neighborhood of each winner: standard
        # aggregation's pass-1 roots end up pairwise distance >= 3
        # (a new root requires its whole neighborhood unaggregated)
        cov1 = np.zeros(n, dtype=bool)
        cov1[cols[winners[rows]]] = True
        cov2 = np.zeros(n, dtype=bool)
        cov2[cols[cov1[rows]]] = True
        state[(cov1 | cov2) & (state == 0)] = -1

    roots = np.flatnonzero(state == 1)
    labels[roots] = np.arange(roots.size)

    # --- pass 2: attach unassigned nodes to the max-weight neighboring
    # aggregate (two sweeps cover distance 2) ------------------------------
    tie = weight + np.arange(n) * 1e-12
    for _ in range(2):
        unass = labels < 0
        m = unass[cols] & (labels[rows] >= 0)
        if not m.any():
            break
        er, ec = rows[m], cols[m]
        best_w = np.full(n, -np.inf)
        np.maximum.at(best_w, ec, tie[er])
        win = tie[er] == best_w[ec]
        pick = np.full(n, -1, dtype=np.int64)
        pick[ec[win]] = labels[er[win]]
        newly = unass & (pick >= 0)
        labels[newly] = pick[newly]

    # --- pass 3: leftovers become their own aggregates -------------------
    left = np.flatnonzero((labels < 0) & ~iso)
    if left.size:
        extra = np.arange(left.size) + roots.size
        labels[left] = extra
        roots = np.concatenate([roots, left])

    AggOp = fit_aggop(labels, roots.size)
    return AggOp, roots


def pairwise_aggregation(A, matchings=2, algorithm="drake",
                         get_weights=None, **kwargs):
    """Pairwise (matching-based) aggregation, fork feature
    (reference aggregate.py:285).  ``matchings`` rounds of maximum weighted
    matching are composed for a coarsening factor of ~2^matchings.
    """
    from .matching import drake_matching, preis_matching, notay_matching

    A = to_csr(A)
    n = A.shape[0]
    AggTotal = None
    Ak = A
    for _ in range(int(matchings)):
        if algorithm == "drake":
            pairs = drake_matching(Ak, **kwargs)
        elif algorithm == "preis":
            pairs = preis_matching(Ak, **kwargs)
        elif algorithm == "notay":
            pairs = notay_matching(Ak, **kwargs)
        else:
            raise ValueError(f"unknown matching algorithm {algorithm!r}")
        labels = _pairs_to_labels(pairs, Ak.shape[0])
        Agg = fit_aggop(labels)
        AggTotal = Agg if AggTotal is None else (AggTotal @ Agg).tocsr()
        Ak = (Agg.T @ Ak @ Agg).tocsr()
    return AggTotal.tocsr(), None


def _pairs_to_labels(pairs, n):
    """pairs: (n,) partner index or -1.  Each matched pair and each singleton
    becomes one aggregate."""
    labels = np.full(n, -1, dtype=np.int64)
    next_agg = 0
    for i in range(n):
        if labels[i] >= 0:
            continue
        j = pairs[i]
        labels[i] = next_agg
        if j >= 0 and labels[j] < 0:
            labels[j] = next_agg
        next_agg += 1
    return labels
