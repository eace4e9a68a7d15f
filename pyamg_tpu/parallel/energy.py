"""SPMD energy-minimization prolongation smoothing over a device mesh.

Role of the reference's serial energy loop (smooth.py:904 — pattern-
restricted ``incomplete_mat_mult_bsr``/``_csr`` per CG iteration +
``satisfy_constraints_helper``, smoothed_aggregation.h:556,797): the host
keeps the INTEGER stages — pattern growth ``|C|^degree @ |T|``, the per-row
constraint Gram pseudo-inverses, T's slot embedding — and the mesh runs the
whole fixed-pattern CG as ONE jitted SPMD program over row-sharded
padded-ELL slabs:

* the flop carrier ``A @ D`` (D = search direction on the pattern) is a
  pattern-masked device SpGEMM (``masked_spgemm_ell``),
* the constraint projection's per-entry B gather is STRUCTURE-static, so
  ``B[pattern.cols]`` is gathered once on the host and shipped as K
  component slabs (never a device gather, never a trailing tiny axis —
  component layout per the block-PCR lessons),
* the CG dots are masked reductions XLA turns into psums on the mesh.

Early stopping is replicated with `where` masks inside a ``lax.fori_loop``
so the iterate sequence matches the host flat path (_cg_prolongation_flat)
exactly up to summation order.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .sharding import pad_to, _pad_ell, _place_ell
from ..sparse import SparseELL
from ..sparse.spgemm_device import masked_spgemm_ell, sentinel_cols

__all__ = ["energy_smooth_sharded"]


@partial(jax.jit, static_argnames=("maxiter",))
def _energy_cg(Ad, Ac, A_nnz, tvals, pat_cols, pat_nnz, shape_r, Bg, G,
               dinv, fmask, tol, *, maxiter):
    """Whole fixed-pattern energy CG as one program.

    Bg: (K, n_pad, w) per-slot coarse-candidate components;
    G: (K, K, n_pad) per-row Gram pinv components; shapes static."""
    K = Bg.shape[0]
    A_ell = SparseELL(data=Ad, cols=Ac, row_nnz=A_nnz,
                      shape=(Ad.shape[0], Ad.shape[0]))
    pat_ell = SparseELL(data=jnp.zeros_like(tvals), cols=pat_cols,
                        row_nnz=pat_nnz, shape=shape_r)
    out_cols = sentinel_cols(pat_ell)

    def product(vals):
        D = SparseELL(data=vals, cols=pat_cols, row_nnz=pat_nnz,
                      shape=shape_r)
        return masked_spgemm_ell(A_ell, D, pat_ell, out_cols).data

    def project(vals):
        if fmask is not None:
            vals = vals * fmask[:, None]
        UB = [jnp.sum(vals * Bg[k], axis=1) for k in range(K)]   # K×(n,)
        coef = [sum(UB[l] * G[l, k] for l in range(K))
                for k in range(K)]
        return vals - sum(coef[k][:, None] * Bg[k] for k in range(K))

    rvals = project(-product(tvals))
    normr0 = jnp.maximum(jnp.abs(rvals).max(), 1e-30)

    def body(_, carry):
        pvals, rvals, ptvals, oldsum, live = carry
        live = live & (jnp.abs(rvals).max() >= tol * normr0)
        zvals = rvals * dinv[:, None]
        newsum = jnp.vdot(rvals, zvals)
        live = live & (newsum != 0)
        ptvals = jnp.where(
            oldsum == 0, zvals,
            zvals + (newsum / jnp.where(oldsum == 0, 1, oldsum)) * ptvals)
        ap = project(product(ptvals))
        d = jnp.vdot(ptvals, ap)
        live = live & (d != 0)
        alpha = jnp.where(live, newsum / jnp.where(d == 0, 1, d), 0.0)
        pvals = pvals + alpha * ptvals
        rvals = rvals - alpha * ap
        return (pvals, rvals, ptvals, jnp.where(live, newsum, oldsum), live)

    carry = (tvals, rvals, jnp.zeros_like(tvals),
             jnp.zeros((), tvals.dtype), jnp.asarray(True))
    pvals, *_ = jax.lax.fori_loop(0, maxiter, body, carry)
    return pvals


def energy_smooth_sharded(A_ell, T_host, C_host, B_coarse, mesh, axis_name,
                          degree=1, maxiter=4,
                          tol=1e-8, weighting="local", fmask_host=None,
                          PI_host=None, dt=np.float32):
    """Energy-minimized P on the mesh; returns (P_ell, pattern_csr).

    ``fmask_host``/``PI_host`` carry the root-node contract
    (reference ``Cpt_params``): F-row mask + the C-point identity block
    added outside the minimization.
    """
    import scipy.sparse as sp
    from ..aggregation.smooth import _grow_pattern
    from ..util.utils import compute_BtBinv

    nd = mesh.devices.size
    n, nc = T_host.shape
    n_pad, nc_pad = pad_to(n, nd), pad_to(max(nc, 1), nd)

    # ---- host: integer / symbolic stage --------------------------------
    T = sp.csr_matrix(T_host).astype(dt)
    T.sort_indices()
    pattern = _grow_pattern(C_host, T, degree)
    if PI_host is not None:
        IF = sp.diags(np.asarray(fmask_host, dtype=np.float64))
        pattern = (IF @ pattern).tocsr()
        PIpat = sp.csr_matrix(PI_host).copy()
        PIpat.data = np.ones_like(PIpat.data)
        pattern = (pattern + PIpat).tocsr()
        pattern.data = np.ones_like(pattern.data)
    pattern.sort_indices()
    B = np.asarray(B_coarse)
    K = B.shape[1]
    BtBinv = compute_BtBinv(B, pattern)                 # (n, K, K) f64

    pat_ell = _place_ell(_pad_ell(SparseELL.from_scipy(pattern, dtype=dt),
                                  n_pad, nc_pad), mesh, axis_name)
    w = pat_ell.width

    # T embedded into pattern slots (both sorted CSR: searchsorted keys)
    key_pat = pattern.indices.astype(np.int64) + np.int64(nc) * np.repeat(
        np.arange(n, dtype=np.int64), np.diff(pattern.indptr))
    key_T = T.indices.astype(np.int64) + np.int64(nc) * np.repeat(
        np.arange(n, dtype=np.int64), np.diff(T.indptr))
    pos = np.searchsorted(key_pat, key_T)
    if pos.max(initial=-1) >= pattern.nnz \
            or not (key_pat[pos] == key_T).all():
        raise ValueError("T's pattern escapes the energy pattern")
    rows = np.repeat(np.arange(n), np.diff(pattern.indptr))
    offs = np.arange(pattern.nnz) - np.repeat(pattern.indptr[:-1],
                                              np.diff(pattern.indptr))
    tslab = np.zeros((n_pad, w), dtype=dt)
    tslab[rows[pos], offs[pos]] = T.data

    # per-slot coarse-candidate components (host gather, structure-static)
    Bg = np.zeros((K, n_pad, w), dtype=dt)
    Bg[:, rows, offs] = B[pattern.indices].T.astype(dt)
    G = np.zeros((K, K, n_pad), dtype=dt)
    G[:, :, :n] = np.moveaxis(BtBinv.astype(dt), 0, -1)

    sh2 = NamedSharding(mesh, P(axis_name, None))
    sh1 = NamedSharding(mesh, P(axis_name))
    shB = NamedSharding(mesh, P(None, axis_name, None))
    shG = NamedSharding(mesh, P(None, None, axis_name))
    tvals = jax.device_put(jnp.asarray(tslab), sh2)
    Bg_d = jax.device_put(jnp.asarray(Bg), shB)
    G_d = jax.device_put(jnp.asarray(G), shG)
    fmask_d = None
    if fmask_host is not None:
        fm = np.zeros(n_pad, dtype=dt)
        fm[:n] = np.asarray(fmask_host, dtype=dt)
        fmask_d = jax.device_put(jnp.asarray(fm), sh1)

    # ---- device: weighting + the whole CG as one SPMD program ----------
    valid = A_ell.valid_mask()
    if weighting == "local":
        Dv = jnp.sum(jnp.where(valid, jnp.abs(A_ell.data), 0), axis=1)
    elif weighting == "diagonal":
        Dv = A_ell.diagonal()
    else:
        raise ValueError("distributed energy smoothing supports weighting "
                         "in ('local', 'diagonal'); got " + repr(weighting))
    dinv = jnp.where(Dv != 0, 1.0 / jnp.where(Dv != 0, Dv, 1), 0.0)

    pvals = _energy_cg(A_ell.data, A_ell.cols, A_ell.row_nnz, tvals,
                       pat_ell.cols, pat_ell.row_nnz,
                       (n_pad, nc_pad), Bg_d, G_d, dinv, fmask_d,
                       jnp.asarray(tol, dtype=tvals.dtype),
                       maxiter=int(maxiter))
    if PI_host is not None:
        # Tout = I_F Tout + P_I  (P_I's slots live inside the pattern)
        PI = sp.csr_matrix(PI_host).astype(dt)
        PI.sort_indices()
        key_PI = PI.indices.astype(np.int64) + np.int64(nc) * np.repeat(
            np.arange(n, dtype=np.int64), np.diff(PI.indptr))
        ppos = np.searchsorted(key_pat, key_PI)
        pislab = np.zeros((n_pad, w), dtype=dt)
        pislab[rows[ppos], offs[ppos]] = PI.data
        pvals = pvals * (fmask_d[:, None] if fmask_d is not None else 1.0) \
            + jax.device_put(jnp.asarray(pislab), sh2)
    P_ell = SparseELL(data=pvals, cols=pat_ell.cols,
                      row_nnz=pat_ell.row_nnz, shape=pat_ell.shape)
    return P_ell, pattern
