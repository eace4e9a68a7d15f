"""Tentative prolongator: per-aggregate QR of the near-nullspace.

Reference parity: pyamg/aggregation/tentative.py (``fit_candidates`` :19 →
amg_core fit_candidates, smoothed_aggregation.h:323,475,488).

Device design: instead of the reference's serial per-aggregate modified
Gram-Schmidt, aggregates are padded to a common size and factored with ONE
batched ``jnp.linalg.qr`` — one batched dense op (SURVEY.md §7.3).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["fit_candidates", "ben_ideal_interpolation"]


def ben_ideal_interpolation(*args, **kwargs):
    """Re-export: the implementation lives with the new-ideal solver
    (reference exports it from tentative.py; ours from rootnode_nii)."""
    from .rootnode_nii import ben_ideal_interpolation as impl
    return impl(*args, **kwargs)


def fit_candidates(AggOp, B, tol=1e-10):
    """Fit near-nullspace candidates B into the aggregate structure.

    Returns (T, coarse_B) with T (n_dof, n_agg * K) such that T @ coarse_B
    reproduces B on aggregated rows and T has orthonormal columns per
    aggregate.

    Examples
    --------
    >>> import numpy as np
    >>> import scipy.sparse as sp
    >>> AggOp = sp.csr_matrix(np.array([[1., 0], [1, 0], [0, 1], [0, 1]]))
    >>> B = np.ones((4, 1))
    >>> T, Bc = fit_candidates(AggOp, B)
    >>> np.allclose((T @ Bc), B)
    True
    """
    AggOp = sp.csr_matrix(AggOp)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    n_dof = B.shape[0]
    K = B.shape[1]
    n_nodes, n_agg = AggOp.shape
    if n_dof % n_nodes:
        raise ValueError("B rows must be a multiple of AggOp rows")
    bs = n_dof // n_nodes

    if K == 1 and bs == 1:
        nnz_row = np.diff(AggOp.indptr)
        if nnz_row.max(initial=0) <= 1:
            # scalar single candidate: per-aggregate normalization is a
            # bincount — no per-aggregate index tables at all
            agg_of = AggOp.indices
            vals = np.ravel(B)[nnz_row.astype(bool)]
            nrm = np.sqrt(np.bincount(agg_of,
                                      weights=np.abs(vals) ** 2,
                                      minlength=n_agg))
            keep = nrm > tol * max(nrm.max(initial=0.0), 1e-300)
            safe = np.where(keep, nrm, 1.0)
            data = vals / safe[agg_of] * keep[agg_of]
            T = sp.csr_matrix((data.astype(B.dtype), AggOp.indices,
                               AggOp.indptr), shape=(n_nodes, n_agg))
            Bc = (nrm * keep).astype(B.dtype)[:, None]
            return T, Bc

    # rows of B per aggregate: nodes sorted by aggregate label
    Acsc = AggOp.tocsc()
    agg_sizes = np.diff(Acsc.indptr)           # nodes per aggregate
    max_nodes = int(agg_sizes.max()) if n_agg else 0
    L = max_nodes * bs                          # padded dof rows per agg

    # gather indices (n_agg, max_nodes) padded with -1 (vectorized scatter)
    node_idx = np.full((n_agg, max_nodes), -1, dtype=np.int64)
    agg_of_entry = np.repeat(np.arange(n_agg), agg_sizes)
    pos_in_agg = np.arange(Acsc.indices.size) - \
        np.repeat(Acsc.indptr[:-1], agg_sizes)
    node_idx[agg_of_entry, pos_in_agg] = Acsc.indices
    valid_nodes = node_idx >= 0
    safe_nodes = np.where(valid_nodes, node_idx, 0)

    # dof rows (n_agg, L)
    dof_idx = (safe_nodes[:, :, None] * bs +
               np.arange(bs)[None, None, :]).reshape(n_agg, L)
    valid = np.repeat(valid_nodes, bs, axis=1)

    blocks = B[dof_idx] * valid[:, :, None]     # (n_agg, L, K)

    if K == 1:
        # single candidate: thin QR is plain column normalization — the
        # stacked-QR gufunc is ~50x slower on millions of tiny blocks
        nrm = np.sqrt((np.abs(blocks[:, :, 0]) ** 2).sum(axis=1))
        safe = np.where(nrm > 0, nrm, 1.0)
        Q = (blocks / safe[:, None, None]).astype(blocks.dtype, copy=False)
        R = nrm.astype(blocks.dtype)[:, None, None]
    else:
        # batched thin QR over all aggregates at once.  numpy's stacked QR
        # on host during staged setup; the identical batched formulation
        # runs as jnp.linalg.qr on device in the on-device setup path.
        Q, R = np.linalg.qr(blocks, mode="reduced")
        Q = np.ascontiguousarray(Q)
        R = np.ascontiguousarray(R)

    # sign-fix: make R diagonals real non-negative (deterministic like the
    # reference's Gram-Schmidt with positive norms)
    for k in range(min(K, R.shape[1])):
        dk = R[:, k, k]
        if np.iscomplexobj(R):
            phase = np.where(np.abs(dk) > 0, dk / np.abs(np.where(
                np.abs(dk) > 0, dk, 1)), 1.0)
            R[:, k, :] = R[:, k, :] * np.conj(phase)[:, None]
            Q[:, :, k] = Q[:, :, k] * phase[:, None]
        else:
            sgn = np.where(dk < 0, -1.0, 1.0)
            R[:, k, :] = R[:, k, :] * sgn[:, None]
            Q[:, :, k] = Q[:, :, k] * sgn[:, None]

    # drop numerically-dependent candidates per aggregate (rank via R diag)
    diagR = np.abs(np.diagonal(R, axis1=1, axis2=2))      # (n_agg, K)
    scale = diagR.max(initial=0.0)
    rank_mask = diagR > tol * max(scale, 1e-300)
    Q = Q * rank_mask[:, None, :]
    R = R * rank_mask[:, :, None]

    # assemble T: for each aggregate a, rows dof_idx[a], cols a*K..a*K+K
    rows = dof_idx.reshape(-1).repeat(K)
    cols = (np.arange(n_agg)[:, None, None] * K +
            np.arange(K)[None, None, :])
    cols = np.broadcast_to(cols, (n_agg, L, K)).reshape(-1)
    vals = (Q * valid[:, :, None]).reshape(-1)
    keep = np.abs(vals) > 0
    T = sp.coo_matrix((vals[keep], (rows.reshape(-1)[keep], cols[keep])),
                      shape=(n_dof, n_agg * K)).tocsr()
    # ensure aggregated rows with zero Q entry still counted: fine (zero)

    coarse_B = R.reshape(n_agg * K, K)
    return T, coarse_B
