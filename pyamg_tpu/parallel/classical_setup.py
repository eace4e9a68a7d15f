"""Distributed CLASSICAL (Ruge-Stuben) hierarchy construction over a mesh.

The same host-integer / SPMD-numeric split that
``general_sa_setup_sharded`` gives the SA family, applied to the classical
constructor (role of the reference's serial pipeline,
pyamg/classical/classical.py:120-187):

* host (integer graph stages): strength-of-connection thresholding, the
  C/F splitting (RS/PMIS/...), the interpolation PATTERN and its
  slot-mapping onto A's ELL layout, and every symbolic product pattern;
* mesh (SPMD numeric stages, row-sharded padded-ELL slabs): the
  evolution-SOC masked-SpGEMM chain (≙ incomplete_mat_mult_csr,
  evolution_strength.h:676), the direct / standard interpolation VALUES
  (≙ rs_direct_interpolation_pass2, ruge_stuben.h:520 and the unexported
  rs_standard_interpolation, ruge_stuben.h:601), R = P^T onto the
  host-symbolic transpose pattern, and the Galerkin triple product
  A_c = R·(A·P) as pattern-masked device SpGEMMs
  (≙ classical/classical.py:187).

Per level the host receives back ONE numeric array — the coarse operator's
values — which the next level's strength thresholding and splitting need.
Coarse operators exit the jit sharded; the fine-level Galerkin product (the
dominant setup flops) never exists on a single device.

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu.gallery import poisson
>>> from pyamg_tpu.parallel import make_mesh, classical_setup_sharded
>>> A = poisson((12, 12), format='csr')
>>> sol = classical_setup_sharded(A, mesh=make_mesh(1), max_coarse=20)
>>> b = np.ones(A.shape[0])
>>> x = sol.solve(b, tol=1e-8, maxiter=100, accel='cg')
>>> r = np.linalg.norm(b - A @ np.asarray(x, dtype=float))
>>> bool(r < 1e-4 * np.linalg.norm(b))    # f32-staged operators
True
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .sharding import make_mesh, pad_to, _pad_ell, _place_ell, ShardedSolver
from .setup import _pattern_csr, _ell_smoother
from ..sparse import SparseELL
from ..sparse.spgemm_device import masked_spgemm_ell, ell_transpose_onto
from ..multilevel import Level
from ..relaxation.device import SmootherData

__all__ = ["classical_setup_sharded"]


# ---------------------------------------------------------------------------
# device kernels (jitted once; SPMD over the caller's mesh placements)
# ---------------------------------------------------------------------------

@jax.jit
def _direct_interp_slab(Ad, Ac, valid, strongC):
    """Direct-interpolation weight slab on A's own ELL layout.

    Per row i (vector form of rs_direct_interpolation_pass2,
    ruge_stuben.h:520): alpha = (sum all negative offdiag)/(sum strong
    negative), beta likewise for positives (lumped into the diagonal when
    there are no strong positives); slot value = -(alpha|beta)/a_ii * a_ij
    at strong-C slots, 0 elsewhere.
    """
    n = Ad.shape[0]
    isdiag = valid & (Ac == jnp.arange(n, dtype=Ac.dtype)[:, None])
    offd = valid & ~isdiag
    neg = Ad.real < 0
    san = jnp.sum(jnp.where(neg & offd, Ad, 0), axis=1)
    sap = jnp.sum(jnp.where(~neg & offd, Ad, 0), axis=1)
    diag = jnp.sum(jnp.where(isdiag, Ad, 0), axis=1)
    ssn = jnp.sum(jnp.where(strongC & neg, Ad, 0), axis=1)
    ssp = jnp.sum(jnp.where(strongC & ~neg, Ad, 0), axis=1)
    no_pos = ssp == 0
    diag = diag + jnp.where(no_pos, sap, 0)
    alpha = jnp.where(ssn != 0, san / jnp.where(ssn != 0, ssn, 1), 0)
    beta = jnp.where(no_pos, 0, sap / jnp.where(ssp != 0, ssp, 1))
    dsafe = jnp.where(diag != 0, diag, 1)
    negc, posc = -alpha / dsafe, -beta / dsafe
    return jnp.where(strongC,
                     jnp.where(neg, negc[:, None], posc[:, None]) * Ad, 0)


@jax.jit
def _gather_interp_slots(W, amap):
    """P-value slab from a weight slab via a host-built slot map.

    amap >= 0: gather W[row, amap]; -1: identity (C-point row); -2: pad."""
    g = jnp.take_along_axis(W, jnp.maximum(amap, 0), axis=1)
    return jnp.where(amap >= 0, g,
                     jnp.where(amap == -1, jnp.ones((), W.dtype), 0))


@jax.jit
def _gather_vals(Ad, amap):
    """Value slab gathered from A's slots (amap < 0 -> 0)."""
    g = jnp.take_along_axis(Ad, jnp.maximum(amap, 0), axis=1)
    return jnp.where(amap >= 0, g, 0)


@jax.jit
def _std_distribute(SFd, denomd, validSF):
    """B = a_ij / denom(i,j) on the strong-F pattern; zero-denominator
    strong-F mass is lumped (returned per row)."""
    nz = denomd != 0
    B = jnp.where(nz, SFd / jnp.where(nz, denomd, 1), 0)
    lump = jnp.sum(jnp.where(validSF & ~nz, SFd, 0), axis=1)
    return B, lump


@jax.jit
def _std_diag(Ad, Ac, validA, SCd, SFd, lump):
    """d_i = a_ii + weak off-diagonal mass + zero-denominator lumping."""
    n = Ad.shape[0]
    isdiag = validA & (Ac == jnp.arange(n, dtype=Ac.dtype)[:, None])
    offd = validA & ~isdiag
    offsum_A = jnp.sum(jnp.where(offd, Ad, 0), axis=1)
    offsum_S = jnp.sum(SCd, axis=1) + jnp.sum(SFd, axis=1)
    adiag = jnp.sum(jnp.where(isdiag, Ad, 0), axis=1)
    return adiag + (offsum_A - offsum_S) + lump


@jax.jit
def _std_final_P(w, diag, amap):
    """P-value slab: -w/diag gathered onto P's slots (diag==0 rows -> 0;
    -1 slots are C-point identities)."""
    nz = diag != 0
    vals = jnp.where(nz[:, None], -w / jnp.where(nz, diag, 1)[:, None], 0)
    g = jnp.take_along_axis(vals, jnp.maximum(amap, 0), axis=1)
    return jnp.where(amap >= 0, g,
                     jnp.where(amap == -1, jnp.ones((), w.dtype), 0))


# ---------------------------------------------------------------------------
# host integer helpers (pattern membership, slot maps, slabs)
# ---------------------------------------------------------------------------

def _csr_keys(M):
    rows = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                     np.diff(M.indptr))
    return rows, rows * M.shape[1] + M.indices.astype(np.int64)


def _in_sorted(kS, kQ):
    if kS.size == 0:
        return np.zeros(kQ.shape, dtype=bool)
    pos = np.minimum(np.searchsorted(kS, kQ), kS.size - 1)
    return kS[pos] == kQ


def _slab_from_csr(Q, vals, n_pad, width, fill, dtype=np.int32):
    """Scatter per-CSR-entry values of Q into an (n_pad, width) slab."""
    nnz_r = np.diff(Q.indptr)
    slab = np.full((n_pad, width), fill, dtype=dtype)
    rows = np.repeat(np.arange(Q.shape[0]), nnz_r)
    offs = np.arange(Q.nnz) - np.repeat(Q.indptr[:-1], nnz_r)
    slab[rows, offs] = vals
    return slab


def _slot_positions(M):
    """Per-entry slot index (position within its row) of a sorted CSR."""
    return (np.arange(M.nnz)
            - np.repeat(M.indptr[:-1], np.diff(M.indptr))).astype(np.int64)


def _enc_csr(rows, cols, slots, shape):
    """CSR whose DATA carries slot indices (+2, so -1/-2 sentinels
    survive): sort_indices permutes data with indices, keeping the map
    aligned with the canonical pattern order."""
    import scipy.sparse as sp

    M = sp.csr_matrix((slots.astype(np.float64) + 2.0,
                       (rows, cols)), shape=shape)
    M.sort_indices()
    return M


def _mesh_masked_power(mesh, axis_name, nd):
    """Mesh replacement for strength._masked_power: every squaring of
    (I - cD^{-1}A)^T runs as a pattern-masked device SpGEMM over the mesh
    (host keeps only the symbolic patterns); one D2H per squaring."""
    import scipy.sparse as sp

    def impl(Atilde_T, nsquare, mask):
        M = sp.csr_matrix(Atilde_T)
        M.sort_indices()
        n = M.shape[0]
        n_pad = pad_to(n, nd)
        for step in range(nsquare):
            if step == nsquare - 1:
                pat = _pattern_csr(mask, (n_pad, n_pad))
            else:
                pm = _pattern_csr(M)
                pat = _pattern_csr(pm @ pm, (n_pad, n_pad))
            M_ell = _place_ell(_pad_ell(SparseELL.from_scipy(M), n_pad,
                                        n_pad), mesh, axis_name)
            pat_ell = _place_ell(SparseELL.from_scipy(pat, dtype=np.float32),
                                 mesh, axis_name)
            out = masked_spgemm_ell(M_ell, M_ell, pat_ell)
            M = out.to_scipy()[:n, :n].tocsr()
            M.sort_indices()
        if nsquare == 0:
            pat = _pattern_csr(mask)
            ones = sp.csr_matrix((np.ones(pat.nnz), pat.indices, pat.indptr),
                                 shape=pat.shape)
            M = M.multiply(ones).tocsr()
        M.eliminate_zeros()
        M.sort_indices()
        return M

    return impl


# ---------------------------------------------------------------------------
# the constructor
# ---------------------------------------------------------------------------

def classical_setup_sharded(A, mesh=None, n_devices=None,
                            axis_name: str = "rows",
                            strength=("classical", {"theta": 0.25}),
                            CF="RS", interpolation="direct",
                            smoother=("multicolor_gauss_seidel",
                                      {"iterations": 1,
                                       "sweep": "symmetric"}),
                            dtype=None, max_levels=10, max_coarse=500):
    """Ruge-Stuben setup with the numeric phase distributed over a mesh.

    Host keeps the integer graph stages (strength thresholding, the C/F
    splitting, interpolation patterns + slot maps, symbolic product
    patterns); the mesh runs every O(nnz) floating-point stage SPMD —
    evolution-SOC masked SpGEMMs, interpolation values, P^T, and the
    Galerkin RAP (see module docstring for the reference roles).  Returns
    a :class:`~pyamg_tpu.parallel.sharding.ShardedSolver`.
    """
    import scipy.sparse as sp
    from ..strength import (classical_strength_of_connection,
                            symmetric_strength_of_connection,
                            evolution_strength_of_connection)
    from ..classical import split as split_mod
    from ..util.utils import unpack_arg

    if mesh is None:
        mesh = make_mesh(n_devices, axis_name=axis_name)
    elif axis_name not in mesh.axis_names and len(mesh.axis_names) == 1:
        # adopt the caller's single mesh axis whatever they named it
        axis_name = mesh.axis_names[0]
    nd = mesh.devices.size
    dt = np.dtype(dtype or np.float32)

    s_name, s_kw = unpack_arg(strength)
    cf_name, cf_kw = unpack_arg(CF)
    i_name, i_kw = unpack_arg(interpolation)
    sm_name, sm_kw = unpack_arg(smoother)
    if i_name not in ("direct", "standard"):
        raise ValueError("distributed classical setup supports "
                         "interpolation in ('direct', 'standard'); got "
                         + repr(i_name))
    if sm_name not in ("jacobi", "multicolor_gauss_seidel"):
        raise ValueError("distributed classical setup supports smoother in "
                         "('jacobi', 'multicolor_gauss_seidel'); got "
                         + repr(sm_name))

    def strength_matrix(A_h):
        if s_name == "classical":
            return classical_strength_of_connection(A_h, **s_kw)
        if s_name == "symmetric":
            return symmetric_strength_of_connection(A_h, **s_kw)
        if s_name in ("evolution", "ode"):
            return evolution_strength_of_connection(
                A_h, _masked_power_impl=_mesh_masked_power(
                    mesh, axis_name, nd), **s_kw)
        if s_name is None:
            return A_h.copy()
        raise ValueError("distributed classical setup supports strength in "
                         "('classical', 'symmetric', 'evolution', None); "
                         "got " + repr(s_name))

    def cf_split(C):
        fns = {"RS": split_mod.RS, "PMIS": split_mod.PMIS,
               "PMISc": split_mod.PMISc, "CLJP": split_mod.CLJP,
               "CLJPc": split_mod.CLJPc, "MIS": split_mod.MIS}
        if cf_name not in fns:
            raise ValueError(f"unknown C/F splitting method {CF!r}")
        return np.asarray(fns[cf_name](C, **cf_kw))

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n_orig = A_host.shape[0]
    sh2 = NamedSharding(mesh, P(axis_name, None))

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        n_pad = pad_to(n, nd)

        # ---- host: integer graph stage ---------------------------------
        C = strength_matrix(A_host)
        C = sp.csr_matrix(C)
        C.sort_indices()
        splitting = cf_split(C)
        ncp = int(splitting.sum())
        if ncp == 0 or ncp == n:
            break                                  # degenerate split
        cpts = np.flatnonzero(splitting)
        cmap = np.cumsum(splitting) - splitting

        rowsA, kA = _csr_keys(A_host)
        _, kC = _csr_keys(C)
        member = _in_sorted(kC, kA)                # A slots present in C
        offd_e = member & (rowsA != A_host.indices)
        strongC_e = offd_e & (splitting[A_host.indices] == 1)

        # ---- device: sharded numeric stage ------------------------------
        A_ell = _place_ell(_pad_ell(SparseELL.from_scipy(A_host, dtype=dt),
                                    n_pad, n_pad), mesh, axis_name)
        valid = A_ell.valid_mask()
        wA = A_ell.width
        nc_pad = pad_to(ncp, nd)

        if i_name == "direct":
            strong_slab = jax.device_put(jnp.asarray(_slab_from_csr(
                A_host, strongC_e, n_pad, wA, False, dtype=bool)), sh2)
            W = _direct_interp_slab(A_ell.data, A_ell.cols, valid,
                                    strong_slab)

            selF = strongC_e & (splitting[rowsA] == 0)
            slotsA = _slot_positions(A_host)
            rowsP = np.concatenate([rowsA[selF], cpts])
            colsP = np.concatenate([cmap[A_host.indices[selF]], cmap[cpts]])
            encP = np.concatenate([slotsA[selF],
                                   np.full(cpts.size, -1, np.int64)])
            P_enc = _enc_csr(rowsP, colsP, encP, (n, ncp))
            patP = _pattern_csr(P_enc, (n_pad, nc_pad))
            patP_ell = _place_ell(SparseELL.from_scipy(patP, dtype=dt),
                                  mesh, axis_name)
            amapP = jax.device_put(jnp.asarray(_slab_from_csr(
                P_enc, P_enc.data.astype(np.int64) - 2, n_pad,
                patP_ell.width, -2)), sh2)
            P_data = _gather_interp_slots(W, amapP)
        else:
            # standard (distance-2) interpolation, SPMD
            # (vector form of interpolate.standard_interpolation)
            valnz = A_host.data != 0
            sC_e = strongC_e & valnz
            sF_e = offd_e & (splitting[A_host.indices] == 0) & valnz
            slotsA = _slot_positions(A_host)

            SC_enc = _enc_csr(rowsA[sC_e], A_host.indices[sC_e],
                              slotsA[sC_e], (n, n))
            SF_enc = _enc_csr(rowsA[sF_e], A_host.indices[sF_e],
                              slotsA[sF_e], (n, n))
            patSC = _pattern_csr(SC_enc, (n_pad, n_pad))
            patSF = _pattern_csr(SF_enc, (n_pad, n_pad))
            patSCT = _pattern_csr(patSC.T, (n_pad, n_pad))
            patSC_ell = _place_ell(SparseELL.from_scipy(patSC, dtype=dt),
                                   mesh, axis_name)
            patSF_ell = _place_ell(SparseELL.from_scipy(patSF, dtype=dt),
                                   mesh, axis_name)
            patSCT_ell = _place_ell(SparseELL.from_scipy(patSCT, dtype=dt),
                                    mesh, axis_name)

            amapSC = jax.device_put(jnp.asarray(_slab_from_csr(
                SC_enc, SC_enc.data.astype(np.int64) - 2, n_pad,
                patSC_ell.width, -2)), sh2)
            amapSF = jax.device_put(jnp.asarray(_slab_from_csr(
                SF_enc, SF_enc.data.astype(np.int64) - 2, n_pad,
                patSF_ell.width, -2)), sh2)

            SCd = _gather_vals(A_ell.data, amapSC)
            SFd = _gather_vals(A_ell.data, amapSF)
            SC_ell = SparseELL(data=SCd, cols=patSC_ell.cols,
                               row_nnz=patSC_ell.row_nnz,
                               shape=patSC_ell.shape)
            SCT_ell = ell_transpose_onto(SC_ell, patSCT_ell)
            Pind = SparseELL(data=patSC_ell.valid_mask().astype(dt),
                             cols=patSC_ell.cols,
                             row_nnz=patSC_ell.row_nnz,
                             shape=patSC_ell.shape)
            denom = masked_spgemm_ell(Pind, SCT_ell, patSF_ell)
            Bd, lump = _std_distribute(SFd, denom.data,
                                       patSF_ell.valid_mask())
            B_ell = SparseELL(data=Bd, cols=patSF_ell.cols,
                              row_nnz=patSF_ell.row_nnz,
                              shape=patSF_ell.shape)
            contrib = masked_spgemm_ell(B_ell, SC_ell, patSC_ell)
            w = SCd + contrib.data
            diag = _std_diag(A_ell.data, A_ell.cols, valid, SCd, SFd, lump)

            slotsSC = _slot_positions(SC_enc)
            # SC_enc rows are already sorted CSR order == (rowsA, cols)
            keepP = splitting[np.repeat(
                np.arange(n), np.diff(SC_enc.indptr))] == 0
            rowsP = np.concatenate([np.repeat(
                np.arange(n), np.diff(SC_enc.indptr))[keepP], cpts])
            colsP = np.concatenate([cmap[SC_enc.indices[keepP]],
                                    cmap[cpts]])
            encP = np.concatenate([slotsSC[keepP],
                                   np.full(cpts.size, -1, np.int64)])
            P_enc = _enc_csr(rowsP, colsP, encP, (n, ncp))
            patP = _pattern_csr(P_enc, (n_pad, nc_pad))
            patP_ell = _place_ell(SparseELL.from_scipy(patP, dtype=dt),
                                  mesh, axis_name)
            amapP = jax.device_put(jnp.asarray(_slab_from_csr(
                P_enc, P_enc.data.astype(np.int64) - 2, n_pad,
                patP_ell.width, -2)), sh2)
            P_data = _std_final_P(w, diag, amapP)

        P_ell = SparseELL(data=P_data, cols=patP_ell.cols,
                          row_nnz=patP_ell.row_nnz, shape=patP_ell.shape)

        # ---- Galerkin triple product, SPMD -------------------------------
        patA = _pattern_csr(A_host, (n_pad, n_pad))
        patR = _pattern_csr(patP.T)
        patAP = _pattern_csr(patA @ patP)
        patAc = _pattern_csr(patR @ patAP)
        patR_ell = _place_ell(SparseELL.from_scipy(patR, dtype=dt),
                              mesh, axis_name)
        patAP_ell = _place_ell(SparseELL.from_scipy(patAP, dtype=dt),
                               mesh, axis_name)
        patAc_ell = _place_ell(SparseELL.from_scipy(patAc, dtype=dt),
                               mesh, axis_name)
        R_ell = ell_transpose_onto(P_ell, patR_ell)
        AP = masked_spgemm_ell(A_ell, P_ell, patAP_ell)
        Ac_ell = masked_spgemm_ell(R_ell, AP, patAc_ell)

        # ---- the one numeric D2H: coarse values for the next level ------
        Ac_host = Ac_ell.to_scipy()[:ncp, :ncp].tocsr()
        Ac_host.eliminate_zeros()
        Ac_host.sort_indices()

        d = A_ell.diagonal()
        dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0.0)
        lvl = Level()
        lvl.A_csr = A_host
        lvl.A = A_ell
        lvl.P = P_ell
        lvl.R = R_ell
        lvl.splitting = splitting
        sm = _ell_smoother(sm_name, sm_kw, patA[:n, :n].tocsr(), dinv,
                           n_pad, mesh, axis_name, dt)
        lvl.presmoother = sm
        lvl.postsmoother = sm
        levels.append(lvl)
        sizes.append(n_pad)

        if Ac_host.shape[0] == n:
            break                                  # coarsening stalled
        A_host = Ac_host

    # coarsest level (replicated dense solve via ShardedSolver._finalize)
    last = Level()
    last.A_csr = A_host
    n_pad = pad_to(A_host.shape[0], nd)
    last.A = _place_ell(_pad_ell(SparseELL.from_scipy(A_host, dtype=dt),
                                 n_pad, n_pad), mesh, axis_name)
    last.presmoother = last.postsmoother = SmootherData(kind="none")
    levels.append(last)
    sizes.append(n_pad)

    return ShardedSolver.from_sharded_levels(levels, sizes, mesh, axis_name,
                                             n_orig)
