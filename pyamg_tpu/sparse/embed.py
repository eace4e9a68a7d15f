"""Fine-embedded DIA transfer operators.

A transfer pair (P: n_f x n_c, R: n_c x n_f) whose coarse dofs can each be
identified with a DISTINCT fine dof — classical AMG's C-points
(reference classical/classical.py:179 builds P over the splitting), SA's
aggregate roots (reference aggregation/aggregate.py returns Cpts), and
rootnode's injected root dofs (reference util/utils.py:1469
``get_Cpt_params``) — can be re-indexed into (n x n) stencil operators:
re-map P's coarse COLUMN j to the fine position of coarse dof j.  On
grid-ordered problems the embedded pattern is banded (the offsets are the
fine-grid distances to nearby roots/C-points), so applying P/R costs one
DIA matvec plus an n_c-sized scatter/gather instead of a gather per stored
entry.

Shared by ``classical/classical.py`` (C-point embedding) and
``aggregation/{aggregation,rootnode}.py`` (root embedding); falls back to
``None`` (caller uses the ELL ``device_operator``) whenever the embedded
pattern is not banded enough or would blow the DIA memory budget.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["embedded_dia_transfers"]


def embedded_dia_transfers(P_csr, cpt_dofs, dtype=None, max_offsets=96,
                           restrict="transpose", R_csr=None):
    """Build (CptProlongOp, CptRestrictOp) for a transfer pair, or None.

    Parameters
    ----------
    P_csr : (n_f, n_c) scipy CSR prolongation.
    cpt_dofs : (n_c,) int array — the fine dof embedding position of each
        coarse dof (distinct values required).
    dtype : numpy/jax dtype for the staged device arrays (host-side cast).
    max_offsets : bandedness cap for the embedded pattern.
    restrict : 'transpose' (R = P.T — classical, symmetric SA),
        'conj_transpose' (R = P^H — hermitian SA), or 'explicit'
        (nonsymmetric: ``R_csr`` is an independent (n_c, n_f) matrix whose
        rows are embedded at the same positions).
    """
    import jax.numpy as jnp
    from ..util.staging import stage_array
    from .dia import SparseDIA
    from .linop import CptProlongOp, CptRestrictOp

    n, nc = P_csr.shape
    cpts = np.asarray(cpt_dofs).astype(np.int64, copy=False).ravel()
    if cpts.size != nc or nc == 0:
        return None

    npdt = None if dtype is None else np.dtype(str(jnp.dtype(dtype)))
    Pf = sp.csr_matrix((P_csr.data, cpts[P_csr.indices], P_csr.indptr),
                       shape=(n, n))
    try:
        pf_diags, pf_offs = SparseDIA.host_diags(Pf, dtype=npdt,
                                                 max_offsets=max_offsets)
    except ValueError:
        return None
    # same fill-ratio rule as the DIA operator chooser: never store >10x the
    # nnz (dense bands on a sparse embedded pattern), with a small-problem
    # floor where the bands are cheap regardless
    mem_cap = max(10 * max(Pf.nnz, 1), 64_000_000)
    if len(pf_offs) * n > mem_cap:
        return None

    if restrict == "explicit":
        if R_csr is None:
            return None
        Rc = R_csr.tocoo()
        RfT = sp.csr_matrix((Rc.data, (cpts[Rc.row], Rc.col)), shape=(n, n))
        try:
            rt_diags, rt_offs = SparseDIA.host_diags(
                RfT, dtype=npdt, max_offsets=max_offsets)
        except ValueError:
            return None
        if len(rt_offs) * n > mem_cap:
            return None
    else:
        rt_diags, rt_offs = SparseDIA.host_transpose(pf_diags, pf_offs,
                                                     (n, n))
        if restrict == "conj_transpose" and np.iscomplexobj(rt_diags):
            rt_diags = rt_diags.conj()
        elif restrict != "transpose" and restrict != "conj_transpose":
            raise ValueError(f"unknown restrict mode {restrict!r}")

    cpts_dev = stage_array(cpts.astype(np.int32))
    Pdia = SparseDIA(diags=stage_array(pf_diags), offsets=pf_offs,
                     shape=(n, n))
    Rdia = SparseDIA(diags=stage_array(rt_diags), offsets=rt_offs,
                     shape=(n, n))
    return (CptProlongOp(dia=Pdia, cpts=cpts_dev, shape=(n, nc)),
            CptRestrictOp(dia=Rdia, cpts=cpts_dev, shape=(nc, n)))


def root_embedded_transfers(lvl, dtype=None, max_offsets=None):
    """Aggregate-root embedding for an SA/rootnode level, or None.

    Uses ``lvl.root_dofs`` (the fine dof position of every coarse dof,
    recorded at hierarchy-extension time from the aggregation roots /
    rootnode injection) and the level's symmetry to pick the restriction
    mode.  The embedded restriction must match the host ``R_csr`` exactly:
    hermitian hierarchies build R = P^H, symmetric build R = P.T, and
    nonsymmetric levels carry an independently smoothed R.
    """
    root_dofs = getattr(lvl, "root_dofs", None)
    if root_dofs is None:
        return None
    P = lvl.P_csr
    if P.shape[1] != np.asarray(root_dofs).size:
        return None
    from .device_op import DENSE_MAX

    if P.shape[0] <= DENSE_MAX and P.shape[1] <= DENSE_MAX:
        return None       # tiny level: device_operator's DenseOp (one
        #                   matmul) beats the DIA scatter/shift form
    if max_offsets is None:
        # small levels tolerate wide bands (the DIA arrays stay tiny while
        # the ELL alternative pays a gather per stored entry);
        # large levels keep the tight cap so the bands stay HBM-friendly
        n = P.shape[0]
        max_offsets = 96 if n > 1 << 18 else (256 if n > 1 << 14 else 1024)
    sym = getattr(lvl, "symmetry", "hermitian")
    if sym == "hermitian":
        mode, R = "conj_transpose", None
    elif sym == "symmetric":
        mode, R = "transpose", None
    else:
        mode, R = "explicit", lvl.R_csr
    return embedded_dia_transfers(P, root_dofs, dtype=dtype,
                                  max_offsets=max_offsets,
                                  restrict=mode, R_csr=R)
