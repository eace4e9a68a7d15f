"""Distributed hierarchy CONSTRUCTION (the setup phase) over a device mesh.

SURVEY §7 step 8 ("shard levels, distributed RAP and setup"): the solve
phase has been sharded since round 1 (sharding.py), but a hierarchy that is
*built* serially on one host bottlenecks an N-chip deployment on setup.
For grid-structured problems every numeric setup step is already a pure
jax program (aggregation/device_setup.py): power-iteration spectral radius,
DIA smoothing factor, tentative pooling, and the comb-probe Galerkin RAP
(role of the reference's serial ``A_c = R * A * P``, aggregation.py:429).
Row-sharding the fine operator's diagonals and the candidate over a 1-D
mesh turns each level build into one SPMD program: XLA inserts the halo
permutes for the DIA shifts and psums for the norms, and each coarse
operator comes out of the jit already sharded — construction itself is
distributed, and the coarse levels never exist unsharded anywhere.

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu.gallery import poisson
>>> from pyamg_tpu.parallel import make_mesh, general_sa_setup_sharded
>>> A = poisson((12, 12), format='csr')
>>> sol = general_sa_setup_sharded(A, mesh=make_mesh(1), max_coarse=20)
>>> b = np.ones(A.shape[0])
>>> x = sol.solve(b, tol=1e-8, maxiter=100, accel='cg')
>>> r = np.linalg.norm(b - A @ np.asarray(x, dtype=float))
>>> bool(r < 1e-4 * np.linalg.norm(b))    # f32-staged operators
True
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .sharding import make_mesh, pad_to, _pad_ell, _place_ell, ShardedSolver
from ..sparse import SparseELL
from ..sparse.ell import ell_matvec
from ..sparse.spgemm_device import masked_spgemm_ell, ell_transpose_onto
from ..multilevel import Level
from ..relaxation.device import SmootherData

__all__ = ["structured_sa_setup_sharded", "general_sa_setup_sharded",
           "rootnode_setup_sharded", "adaptive_sa_setup_sharded"]


def structured_sa_setup_sharded(A, grid, mesh=None, n_devices=None,
                                axis_name: str = "rows", **kw):
    """Build a structured SA hierarchy with the SETUP distributed over a
    mesh (row-sharded diagonals, SPMD level builds, sharded coarse
    operators).  ``A`` may be scipy CSR or a SparseDIA; remaining keyword
    arguments match :func:`~pyamg_tpu.aggregation.device_setup.
    structured_sa_setup`.

    The resulting hierarchy's operators live sharded on the mesh; its
    compiled cycles execute SPMD.  Numerically identical to the
    single-device build up to reduction reassociation in the power
    iteration's norms.
    """
    from ..aggregation.device_setup import structured_sa_setup

    if mesh is None:
        mesh = make_mesh(n_devices, axis_name=axis_name)
    return structured_sa_setup(A, grid, mesh=mesh, **kw)


# ---------------------------------------------------------------------------
# general (unstructured) path: distributed numeric setup
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_iter",))
def _ell_power_rho(data, cols, dinv, v0, n_iter=30):
    """rho(D^{-1} A) by power iteration on the sharded ELL operator
    (role of approximate_spectral_radius, util/linalg.py:282, for the
    jacobi smoothing weight)."""
    def body(_, carry):
        v, lam = carry
        w = dinv * ell_matvec(data, cols, v)
        lam = jnp.linalg.norm(w)
        return (w / jnp.maximum(lam, 1e-30), lam)

    _, lam = jax.lax.fori_loop(
        0, n_iter, body, (v0, jnp.asarray(1.0, dtype=v0.dtype)))
    return lam


@jax.jit
def _jacobi_smoothing_vals(Ad, Ac, valid, c):
    """Value slab of S = I - c D^{-1} A on A's own ELL structure."""
    n = Ad.shape[0]
    diag = jnp.sum(jnp.where(
        valid & (Ac == jnp.arange(n, dtype=Ac.dtype)[:, None]), Ad, 0),
        axis=1)
    dinv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1), 0.0)
    S = (-c) * dinv[:, None] * Ad
    isdiag = valid & (Ac == jnp.arange(n, dtype=Ac.dtype)[:, None])
    return jnp.where(isdiag, S + 1.0, S), dinv


def _pattern_csr(X, shape=None):
    import scipy.sparse as sp

    Xp = sp.csr_matrix(X).copy()
    Xp.data = np.ones_like(Xp.data, dtype=np.float64)
    if shape is not None and shape != Xp.shape:
        Xp.resize(shape)
    Xp.sort_indices()
    return Xp


def _ell_smoother(sm_name, sm_kw, A_pat_csr, dinv_sh, n_pad, mesh,
                  axis_name, dt):
    """SmootherData for a mesh-built padded-ELL level (jacobi or
    multicolor GS; the color masks are a host integer stage)."""
    from ..relaxation.smoothing import _color_masks

    if sm_name == "jacobi":
        return SmootherData(kind="jacobi", dinv=dinv_sh,
                            omega=float(sm_kw.get("omega", 1.0)),
                            iterations=int(sm_kw.get("iterations", 1)))
    shm = NamedSharding(mesh, P(None, axis_name))
    masks = np.asarray(_color_masks(A_pat_csr, dtype=dt))
    m = np.zeros((masks.shape[0], n_pad), dtype=masks.dtype)
    m[:, :masks.shape[1]] = masks
    return SmootherData(
        kind="multicolor_gauss_seidel", dinv=dinv_sh,
        color_masks=jax.device_put(jnp.asarray(m), shm),
        iterations=int(sm_kw.get("iterations", 1)),
        sweep=sm_kw.get("sweep", "symmetric"))


def general_sa_setup_sharded(A, B=None, mesh=None, n_devices=None,
                             axis_name: str = "rows",
                             strength=("symmetric", {"theta": 0.0}),
                             aggregate="standard", omega=4.0 / 3.0,
                             smooth=("jacobi", {}),
                             max_levels=10, max_coarse=100,
                             smoother=("multicolor_gauss_seidel",
                                       {"iterations": 1,
                                        "sweep": "symmetric"}),
                             dtype=None, rho_iters=30):
    """Smoothed-aggregation setup with the NUMERIC phase distributed.

    Host/device split of the reference's serial setup pipeline
    (aggregation/aggregation.py:293-430): the host keeps only the
    integer-graph decisions — strength-of-connection thresholding,
    greedy aggregation, tentative-pattern fitting, graph coloring, and
    the symbolic product patterns — while every O(nnz) floating-point
    stage runs SPMD on the mesh as a jitted program over row-sharded
    padded-ELL slabs:

    * rho(D^{-1}A) power iteration (`_ell_power_rho`),
    * the Jacobi prolongation smoother values S = I − (ω/ρ)D^{-1}A,
    * P = S·T, A·P and R·(A·P) as pattern-masked device SpGEMMs
      (sparse/spgemm_device.py), and R = P^T onto the host-symbolic
      transpose pattern.

    Per level the host receives back exactly one numeric array: the
    coarse operator's values (an ~nnz/ccr-sized D2H) which the next
    level's strength thresholding needs.  Coarse operators therefore
    come out of the jit already sharded, and the fine-level Galerkin
    product — the dominant setup flops — never exists on a single
    device.  Returns a :class:`~pyamg_tpu.parallel.sharding.
    ShardedSolver` ready to solve on the same mesh.
    """
    import scipy.sparse as sp
    from ..strength import (symmetric_strength_of_connection,
                            classical_strength_of_connection)
    from ..aggregation.aggregate import (standard_aggregation,
                                         naive_aggregation)
    from ..aggregation.tentative import fit_candidates

    if mesh is None:
        mesh = make_mesh(n_devices, axis_name=axis_name)
    elif axis_name not in mesh.axis_names and len(mesh.axis_names) == 1:
        # adopt the caller's single mesh axis whatever they named it
        axis_name = mesh.axis_names[0]
    nd = mesh.devices.size
    dt = np.dtype(dtype or np.float32)

    def unpack(arg):
        if isinstance(arg, tuple):
            return arg[0], dict(arg[1])
        return arg, {}

    s_name, s_kw = unpack(strength)
    agg_name, agg_kw = unpack(aggregate)
    p_name, p_kw = unpack(smooth)
    if p_name not in ("jacobi", "energy"):
        raise ValueError("distributed setup supports smooth in "
                         "('jacobi', 'energy'); got " + repr(p_name))
    sm_name, sm_kw = unpack(smoother)
    if sm_name not in ("jacobi", "multicolor_gauss_seidel"):
        raise ValueError(
            "distributed setup supports smoother in "
            "('jacobi', 'multicolor_gauss_seidel'); got " + repr(sm_name))
    if agg_name not in ("standard", "naive"):
        raise ValueError("distributed setup supports aggregate in "
                         "('standard', 'naive'); got " + repr(agg_name))

    A_host = sp.csr_matrix(A).astype(dt)
    # every row must STORE its diagonal: the device smoothing-value kernel
    # places the identity of S = I - c D^{-1} A at stored-diagonal slots
    # only (a missing slot would zero that prolongator row, silently
    # diverging from the serial build which preserves P = T there).
    # Adding an explicit zero diagonal makes dinv = 0 -> S row = e_i,
    # matching the serial fallback semantics exactly.
    def _ensure_stored_diagonal(M):
        rows_m = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
        has = np.zeros(M.shape[0], dtype=bool)
        has[rows_m[M.indices == rows_m]] = True
        if has.all():
            return M
        miss = np.flatnonzero(~has)
        coo = M.tocoo()
        return sp.coo_matrix(
            (np.concatenate([coo.data, np.zeros(miss.size, dtype=dt)]),
             (np.concatenate([coo.row, miss]),
              np.concatenate([coo.col, miss]))),
            shape=M.shape).tocsr()        # coo->csr keeps explicit zeros

    A_host = _ensure_stored_diagonal(A_host)
    A_host.sort_indices()
    n_orig = A_host.shape[0]
    Bcur = (np.ones((n_orig, 1), dtype=dt) if B is None
            else np.asarray(B, dtype=dt).reshape(n_orig, -1))

    sh1 = NamedSharding(mesh, P(axis_name))

    def make_smoother(A_pat_csr, dinv_sh, n_pad):
        return _ell_smoother(sm_name, sm_kw, A_pat_csr, dinv_sh, n_pad,
                             mesh, axis_name, dt)

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        n_pad = pad_to(n, nd)

        # ---- host: integer graph stage ---------------------------------
        if s_name in ("symmetric", None):
            C = (symmetric_strength_of_connection(A_host, **s_kw)
                 if s_name else A_host)
        elif s_name == "classical":
            C = classical_strength_of_connection(A_host, **s_kw)
        else:
            raise ValueError(f"unsupported strength {s_name!r} "
                             "for the distributed setup")
        agg_fn = (standard_aggregation if agg_name == "standard"
                  else naive_aggregation)
        AggOp, _roots = agg_fn(C, **agg_kw)
        if AggOp.shape[1] == 0:
            break
        T, Bc = fit_candidates(AggOp, Bcur)
        T = sp.csr_matrix(T).astype(dt)
        nc = T.shape[1]
        nc_pad = pad_to(max(nc, 1), nd)

        patA = _pattern_csr(A_host, (n_pad, n_pad))

        # ---- device: sharded numeric stage ------------------------------
        A_ell = _place_ell(_pad_ell(SparseELL.from_scipy(A_host, dtype=dt),
                                    n_pad, n_pad), mesh, axis_name)
        valid = A_ell.valid_mask()
        ddt = A_ell.dtype             # actual staged dtype (f32 w/o x64)
        d = A_ell.diagonal()          # padded rows: 0 -> dinv 0 -> inert
        dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0.0)

        if p_name == "energy":
            from .energy import energy_smooth_sharded

            P_ell, patP = energy_smooth_sharded(
                A_ell, T, C, Bc, mesh, axis_name, dt=dt,
                degree=int(p_kw.get("degree", 1)),
                maxiter=int(p_kw.get("maxiter", 4)),
                tol=float(p_kw.get("tol", 1e-8)),
                weighting=p_kw.get("weighting", "local"))
            patP = _pattern_csr(patP, (n_pad, nc_pad))
        else:
            v0 = jax.device_put(
                jnp.asarray(np.sin(np.arange(1, n_pad + 1)), dtype=ddt),
                sh1)
            rho = float(_ell_power_rho(A_ell.data, A_ell.cols, dinv, v0,
                                       n_iter=rho_iters))
            S_data, dinv = _jacobi_smoothing_vals(
                A_ell.data, A_ell.cols, valid,
                jnp.asarray(omega / max(rho, 1e-30), dtype=ddt))
            S_ell = SparseELL(data=S_data, cols=A_ell.cols,
                              row_nnz=A_ell.row_nnz, shape=A_ell.shape)
            patT = _pattern_csr(T, (n_pad, nc_pad))
            patP = _pattern_csr(patA @ patT)
        patR = _pattern_csr(patP.T)
        patAP = _pattern_csr(patA @ patP)
        patAc = _pattern_csr(patR @ patAP)

        patP_ell = _place_ell(SparseELL.from_scipy(patP, dtype=dt),
                              mesh, axis_name)
        patR_ell = _place_ell(SparseELL.from_scipy(patR, dtype=dt),
                              mesh, axis_name)
        patAP_ell = _place_ell(SparseELL.from_scipy(patAP, dtype=dt),
                               mesh, axis_name)
        patAc_ell = _place_ell(SparseELL.from_scipy(patAc, dtype=dt),
                               mesh, axis_name)

        if p_name == "energy":
            pass          # energy P comes back padded + mesh-placed
        else:
            T_ell = _place_ell(_pad_ell(SparseELL.from_scipy(T, dtype=dt),
                                        n_pad, nc_pad), mesh, axis_name)
            P_ell = masked_spgemm_ell(S_ell, T_ell, patP_ell)
        R_ell = ell_transpose_onto(P_ell, patR_ell)
        AP = masked_spgemm_ell(A_ell, P_ell, patAP_ell)
        Ac_ell = masked_spgemm_ell(R_ell, AP, patAc_ell)

        # ---- the one numeric D2H: coarse values for the next level ------
        Ac_host = Ac_ell.to_scipy()[:nc, :nc].tocsr()
        Ac_host.eliminate_zeros()
        Ac_host.sort_indices()

        lvl = Level()
        lvl.A_csr = A_host
        lvl.A = A_ell
        lvl.P = P_ell
        lvl.R = R_ell
        sm = make_smoother(patA[:n, :n].tocsr(), dinv, n_pad)
        lvl.presmoother = sm
        lvl.postsmoother = sm
        levels.append(lvl)
        sizes.append(n_pad)

        # eliminate_zeros above can drop an exactly-zero coarse diagonal;
        # the next level's smoothing kernel needs the slot stored
        Ac_host = _ensure_stored_diagonal(Ac_host)
        Ac_host.sort_indices()
        A_host, Bcur = Ac_host, Bc

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


def rootnode_setup_sharded(A, B=None, mesh=None, n_devices=None,
                           axis_name: str = "rows",
                           strength=("symmetric", {"theta": 0.0}),
                           aggregate="standard",
                           smooth=("energy", {}),
                           max_levels=10, max_coarse=100,
                           smoother=("multicolor_gauss_seidel",
                                     {"iterations": 1,
                                      "sweep": "symmetric"}),
                           dtype=None):
    """Root-node SA setup with the numeric phase distributed over a mesh.

    The same host-integer / SPMD-numeric split as
    :func:`general_sa_setup_sharded`, applied to the root-node constructor
    (reference rootnode.py:316): host keeps strength, aggregation + root
    selection, the tentative fit, ``get_Cpt_params`` / ``scale_T`` and the
    injected coarse candidates; the mesh runs the Cpt-constrained energy
    CG (parallel/energy.py — F-row masks + the P_I identity block ride the
    reference's ``Cpt_params`` contract) and the Galerkin RAP.  Scalar
    (blocksize-1) operators; requires ``smooth=('energy', ...)`` like the
    reference.
    """
    import scipy.sparse as sp
    from ..strength import (symmetric_strength_of_connection,
                            classical_strength_of_connection)
    from ..aggregation.aggregate import (standard_aggregation,
                                         naive_aggregation)
    from ..aggregation.tentative import fit_candidates
    from ..util.utils import get_Cpt_params, scale_T
    from .energy import energy_smooth_sharded

    if mesh is None:
        mesh = make_mesh(n_devices, axis_name=axis_name)
    elif axis_name not in mesh.axis_names and len(mesh.axis_names) == 1:
        axis_name = mesh.axis_names[0]
    nd = mesh.devices.size
    dt = np.dtype(dtype or np.float32)

    def unpack(arg):
        if isinstance(arg, tuple):
            return arg[0], dict(arg[1])
        return arg, {}

    s_name, s_kw = unpack(strength)
    agg_name, agg_kw = unpack(aggregate)
    p_name, p_kw = unpack(smooth)
    if p_name != "energy":
        raise ValueError("rootnode requires the 'energy' prolongation "
                         f"smoother (got {p_name!r})")
    sm_name, sm_kw = unpack(smoother)

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n_orig = A_host.shape[0]
    Bcur = (np.ones((n_orig, 1), dtype=dt) if B is None
            else np.asarray(B, dtype=dt).reshape(n_orig, -1))

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        n_pad = pad_to(n, nd)

        # ---- host: integer graph stage ---------------------------------
        if s_name in ("symmetric", None):
            C = (symmetric_strength_of_connection(A_host, **s_kw)
                 if s_name else A_host)
        elif s_name == "classical":
            C = classical_strength_of_connection(A_host, **s_kw)
        else:
            raise ValueError(f"unsupported strength {s_name!r}")
        agg_fn = (standard_aggregation if agg_name == "standard"
                  else naive_aggregation)
        AggOp, Cnodes = agg_fn(sp.csr_matrix(C), **agg_kw)
        if AggOp.shape[1] == 0 or Cnodes is None:
            break
        T, _dummy = fit_candidates(AggOp, Bcur[:, :1])
        Cpt_params = get_Cpt_params(A_host, np.asarray(Cnodes), AggOp,
                                    sp.csr_matrix(T))
        T = scale_T(sp.csr_matrix(T), Cpt_params["P_I"], Cpt_params["I_F"])
        B_coarse = np.asarray(Cpt_params["P_I"].T @ Bcur)
        fmask = np.asarray(
            sp.csr_matrix(Cpt_params["I_F"]).diagonal()).real != 0
        nc = T.shape[1]
        nc_pad = pad_to(max(nc, 1), nd)

        # ---- device: sharded numeric stage ------------------------------
        A_ell = _place_ell(_pad_ell(SparseELL.from_scipy(A_host, dtype=dt),
                                    n_pad, n_pad), mesh, axis_name)
        d = A_ell.diagonal()
        dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0.0)

        P_ell, patP = energy_smooth_sharded(
            A_ell, sp.csr_matrix(T), sp.csr_matrix(C), B_coarse, mesh,
            axis_name, dt=dt,
            degree=int(p_kw.get("degree", 1)),
            maxiter=int(p_kw.get("maxiter", 4)),
            tol=float(p_kw.get("tol", 1e-8)),
            weighting=p_kw.get("weighting", "local"),
            fmask_host=fmask, PI_host=Cpt_params["P_I"])

        patA = _pattern_csr(A_host, (n_pad, n_pad))
        patP = _pattern_csr(patP, (n_pad, nc_pad))
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

        Ac_host = Ac_ell.to_scipy()[:nc, :nc].tocsr()
        Ac_host.eliminate_zeros()
        Ac_host.sort_indices()

        lvl = Level()
        lvl.A_csr = A_host
        lvl.A = A_ell
        lvl.P = P_ell
        lvl.R = R_ell
        lvl.Cpts = Cpt_params["Cpts"]
        sm = _ell_smoother(sm_name, sm_kw, patA[:n, :n].tocsr(), dinv,
                           n_pad, mesh, axis_name, dt)
        lvl.presmoother = sm
        lvl.postsmoother = sm
        levels.append(lvl)
        sizes.append(n_pad)

        if Ac_host.shape[0] == n:
            break
        has = Ac_host.diagonal() != 0
        if not has.all():
            Ac_host = Ac_host + sp.diags((~has).astype(dt) * 0.0)
            Ac_host = Ac_host.tocsr()
        A_host, Bcur = Ac_host, B_coarse

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


@partial(jax.jit, static_argnames=("sweeps",))
def _mesh_candidate_relax(Ad, Ac, dinv, x, omega, sweeps=8):
    """Weighted-Jacobi candidate relaxation on A x = 0 (SPMD): the mesh
    form of the reference's initial-stage relaxation (adaptive.py:363) —
    each sweep renormalizes so strong sweeps cannot underflow x to 0."""
    def body(_, x):
        x = x - omega * dinv * ell_matvec(Ad, Ac, x)
        nrm = jnp.linalg.norm(x)
        return x / jnp.maximum(nrm, 1e-30)

    return jax.lax.fori_loop(0, sweeps, body, x)


def adaptive_sa_setup_sharded(A, mesh=None, n_devices=None,
                              axis_name: str = "rows",
                              num_candidates=1, candidate_iters=8,
                              omega=2.0 / 3.0, max_levels=10,
                              max_coarse=100, dtype=None, seed=0, **kw):
    """Adaptive-SA setup with the numeric phase distributed over a mesh.

    The mesh leg of the reference's αSA bootstrap (adaptive.py:363): the
    INITIAL-stage candidate relaxation (ν weighted-Jacobi sweeps on
    A x = 0 from a deterministic pseudo-random start, renormalized per
    sweep) runs SPMD on row-sharded slabs, then the hierarchy itself is
    mesh-constructed by :func:`general_sa_setup_sharded` on the relaxed
    candidates.  Additional candidates relax against the current solver's
    error propagation the same way (one mesh program per sweep chain).
    Remaining keyword arguments pass through to the general setup.
    """
    import scipy.sparse as sp

    if mesh is None:
        mesh = make_mesh(n_devices, axis_name=axis_name)
    elif axis_name not in mesh.axis_names and len(mesh.axis_names) == 1:
        axis_name = mesh.axis_names[0]
    nd = mesh.devices.size
    dt = np.dtype(dtype or np.float32)

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n = A_host.shape[0]
    n_pad = pad_to(n, nd)
    A_ell = _place_ell(_pad_ell(SparseELL.from_scipy(A_host, dtype=dt),
                                n_pad, n_pad), mesh, axis_name)
    d = A_ell.diagonal()
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0.0)
    sh1 = NamedSharding(mesh, P(axis_name))

    rng = np.random.default_rng(seed)
    cands = []
    rho = None
    for _k in range(max(1, int(num_candidates))):
        x0 = np.zeros(n_pad, dtype=dt)
        x0[:n] = rng.random(n).astype(dt) - 0.5
        x = jax.device_put(jnp.asarray(x0), sh1)
        if rho is None:
            rho = float(_ell_power_rho(A_ell.data, A_ell.cols, dinv, x,
                                       n_iter=20))
        x = _mesh_candidate_relax(A_ell.data, A_ell.cols, dinv, x,
                                  jnp.asarray(omega / max(rho, 1e-30),
                                              dtype=A_ell.dtype),
                                  sweeps=int(candidate_iters))
        cands.append(np.asarray(x)[:n])
    Bcur = np.column_stack(cands).astype(dt)

    return general_sa_setup_sharded(A_host, B=Bcur, mesh=mesh,
                                    axis_name=axis_name,
                                    max_levels=max_levels,
                                    max_coarse=max_coarse, dtype=dt, **kw)
