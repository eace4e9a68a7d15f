"""Smoothed aggregation (SA) solver constructor.

Reference parity: pyamg/aggregation/aggregation.py
(``smoothed_aggregation_solver`` :30, ``extend_hierarchy`` :293): per-level
improve-candidates relaxation → strength → (optional diagonal-dominance
filter) → aggregation → tentative prolongator (batched-QR fit_candidates) →
prolongation smoothing → R by symmetry → Galerkin RAP.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from ..multilevel import MultilevelSolver, Level
from ..relaxation.smoothing import change_smoothers
from ..strength import (classical_strength_of_connection,
                        symmetric_strength_of_connection,
                        evolution_strength_of_connection,
                        energy_based_strength_of_connection,
                        distance_strength_of_connection,
                        algebraic_distance, affinity_distance)
from ..util.utils import (unpack_arg, to_csr, levelize_strength_or_aggregation,
                          levelize_smooth_or_improve_candidates,
                          relaxation_as_linear_operator,
                          eliminate_diag_dom_nodes)
from .aggregate import (standard_aggregation, naive_aggregation,
                        lloyd_aggregation, pairwise_aggregation,
                        parallel_aggregation, grid_aggregation)
from .tentative import fit_candidates
from .smooth import (jacobi_prolongation_smoother,
                     richardson_prolongation_smoother,
                     energy_prolongation_smoother)

__all__ = ["smoothed_aggregation_solver"]


def _strength(A, B, flag):
    fn, kwargs = unpack_arg(flag)
    if fn == "symmetric":
        return symmetric_strength_of_connection(A, **kwargs)
    if fn == "classical":
        return classical_strength_of_connection(A, **kwargs)
    if fn == "distance":
        return distance_strength_of_connection(A, **kwargs)
    if fn in ("ode", "evolution"):
        if "B" in kwargs:
            return evolution_strength_of_connection(A, **kwargs)
        return evolution_strength_of_connection(A, B, **kwargs)
    if fn == "energy_based":
        return energy_based_strength_of_connection(A, **kwargs)
    if fn == "algebraic_distance":
        return algebraic_distance(A, **kwargs)
    if fn == "affinity":
        return affinity_distance(A, **kwargs)
    if fn == "predefined":
        return to_csr(kwargs["C"])
    if fn is None:
        C = to_csr(A).copy()
        C.data = np.ones_like(C.data)
        return C
    raise ValueError(f"unrecognized strength of connection method {fn!r}")


def _aggregate(C, A, B, flag):
    fn, kwargs = unpack_arg(flag)
    if fn == "standard":
        # the sequential 3-pass greedy is exact (reference-parity aggregate
        # order, banded coarse patterns on grid-ordered nodes); with the
        # native C++ kernel it is O(nnz) at any scale.  Without it, the
        # vectorized round-based formulation takes over for large problems
        # (same aggregate semantics, parallel execution).
        lim = kwargs.pop("sequential_limit", None)
        if lim is None:
            from ..amg_core import have_native

            lim = 50_000_000 if have_native() else 50_000
        if C.shape[0] > lim:
            return parallel_aggregation(C, **kwargs)
        return standard_aggregation(C, **kwargs)
    if fn in ("parallel", "mis"):
        return parallel_aggregation(C, **kwargs)
    if fn == "naive":
        return naive_aggregation(C, **kwargs)
    if fn == "lloyd":
        return lloyd_aggregation(C, **kwargs)
    if fn == "pairwise":
        return pairwise_aggregation(A, **kwargs)
    if fn == "predefined":
        return to_csr(kwargs["AggOp"]), None
    raise ValueError(f"unrecognized aggregation method {fn!r}")


def _smooth_P(T, A, C, B, flag, sym_hint=None):
    fn, kwargs = unpack_arg(flag)
    if fn == "jacobi":
        return jacobi_prolongation_smoother(A, T, C, B, sym_hint=sym_hint,
                                            **kwargs)
    if fn == "richardson":
        return richardson_prolongation_smoother(A, T, sym_hint=sym_hint,
                                                **kwargs)
    if fn == "energy":
        return energy_prolongation_smoother(A, T, C, B, None, (False, {}),
                                            **kwargs)
    if fn is None:
        return to_csr(T)
    raise ValueError(f"unrecognized prolongation smoother {fn!r}")


def smoothed_aggregation_solver(A, B=None, BH=None, symmetry="hermitian",
                                strength="symmetric",
                                aggregate="standard",
                                smooth=("jacobi",
                                        {"omega": 4.0 / 3.0}),
                                presmoother=("block_gauss_seidel",
                                             {"sweep": "symmetric"}),
                                postsmoother=("block_gauss_seidel",
                                              {"sweep": "symmetric"}),
                                improve_candidates=(("block_gauss_seidel",
                                                     {"sweep": "symmetric",
                                                      "iterations": 4}),
                                                    None),
                                max_levels=10, max_coarse=500,
                                diagonal_dominance=False, keep=False,
                                coarse_solver="pinv", coarse_filter=None,
                                op_dtype=None, finalize_device=True,
                                **kwargs):
    """Create a smoothed-aggregation AMG solver
    (reference aggregation.py:30).

    Parameters follow the reference: ``B`` near-nullspace candidates (default
    constant vector / kron with identity for BSR), ``symmetry`` in
    {'hermitian', 'symmetric', 'nonsymmetric'}, per-level option lists
    supported for strength/aggregate/smooth/improve_candidates.

    Device addition: ``op_dtype`` builds every device operator and smoother
    directly in that dtype (e.g. ``jnp.float32`` for an f32 preconditioner
    from an f64 host setup) — host-side casts before the H2D transfers,
    instead of transferring f64 and casting on device.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu.gallery import poisson
    >>> from pyamg_tpu.aggregation import smoothed_aggregation_solver
    >>> A = poisson((32, 32), format='csr')
    >>> ml = smoothed_aggregation_solver(A, max_coarse=50)
    >>> b = np.ones(A.shape[0])
    >>> res = []
    >>> x = ml.solve(b, tol=1e-8, residuals=res)
    >>> res[-1] < 1e-8 * res[0]
    True
    """
    if symmetry not in ("hermitian", "symmetric", "nonsymmetric"):
        raise ValueError("expected 'symmetric', 'nonsymmetric' or "
                         "'hermitian' for the symmetry parameter")

    A_in = A
    blocksize = 1
    if sp.issparse(A_in) and A_in.format == "bsr":
        blocksize = A_in.blocksize[0]
    A = to_csr(A_in)
    n = A.shape[0]

    if B is None:
        B = np.kron(np.ones((n // blocksize, 1), dtype=A.dtype),
                    np.eye(blocksize, dtype=A.dtype))
    else:
        B = np.asarray(B, dtype=A.dtype)
        if B.ndim == 1:
            B = B[:, None]
        if B.shape[0] != n:
            raise ValueError("near nullspace has incorrect dimensions")
        if B.shape[1] > 5:
            warnings.warn("Having more than 5 candidates per level is costly")

    if symmetry == "nonsymmetric":
        BH_arr = B.copy() if BH is None else np.asarray(BH, dtype=A.dtype)
        if BH_arr.ndim == 1:
            BH_arr = BH_arr[:, None]
    else:
        BH_arr = None

    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)
    max_levels, max_coarse, aggregate = levelize_strength_or_aggregation(
        aggregate, max_levels, max_coarse)
    improve_candidates = levelize_smooth_or_improve_candidates(
        improve_candidates, max_levels)
    smooth = levelize_smooth_or_improve_candidates(smooth, max_levels)

    levels = [Level()]
    levels[0].A_csr = A
    levels[0].A_bsr = sp.bsr_matrix(A_in) if blocksize > 1 else None
    levels[0].B = B
    levels[0].blocksize = blocksize
    if symmetry == "nonsymmetric":
        levels[0].BH = BH_arr
    levels[0].symmetry = symmetry
    # structured-grid metadata (set by the gallery, or passed via
    # aggregate=('grid', {'grid': ..., 'block': ...})) enables the
    # gather-free DIA/grid-op device fast path
    levels[0].grid = getattr(A_in, "grid", None)
    # anisotropy-aware semicoarsening (weak-axis-only grid blocks) is only
    # contractive together with line relaxation along the strong axis
    _pre_name = unpack_arg(presmoother)[0]
    levels[0]._line_smoother = _pre_name in ("zebra", "line_jacobi",
                                             "line_gauss_seidel")
    agg0 = aggregate[0] if isinstance(aggregate, list) else aggregate
    fn0, kw0 = unpack_arg(agg0)
    if fn0 == "grid" and "grid" in kw0:
        levels[0].grid = tuple(kw0["grid"])

    while (len(levels) < max_levels
           and levels[-1].A_csr.shape[0] // max(levels[-1].blocksize, 1)
           > max_coarse):
        n_prev = levels[-1].A_csr.shape[0]
        _extend_sa_hierarchy(levels, strength, aggregate, smooth,
                             improve_candidates, diagonal_dominance, keep,
                             symmetry, coarse_filter)
        if levels[-1].A_csr.shape[0] == n_prev:
            break

    if finalize_device:
        _finalize_device_operators(levels, op_dtype=op_dtype)
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver)
    if op_dtype is not None:
        ml._op_dtype = op_dtype
    if finalize_device:
        change_smoothers(ml, presmoother, postsmoother)
    return ml


def _finalize_device_operators(levels, op_dtype=None):
    """Build the device representation of every level: DIA/dense/ELL for A,
    composed gather-free grid operators for structured P/R.

    ``op_dtype``: target device dtype (host-side casts before transfer).

    Arrays are host-STAGED (numpy pytree leaves): every individual upload
    pays a fixed transfer cost, so the whole hierarchy ships in one batched
    ``device_put`` at ``MultilevelSolver._dev()`` instead."""
    from ..util.staging import staging

    with staging():
        _finalize_device_operators_impl(levels, op_dtype=op_dtype)


def _finalize_device_operators_impl(levels, op_dtype=None):
    import numpy as np_
    import jax.numpy as jnp
    from ..sparse import (device_operator, ComposedOp, GridRepeatOp,
                          GridPoolOp, SparseDIA, SparseBDIA)
    from ..util.staging import stage_array

    npdt = None if op_dtype is None else np_.dtype(str(jnp.dtype(op_dtype)))

    def _banded_device_op(A_csr, q, A_bsr=None):
        """Structured level with q dofs/node: block-banded → SparseBDIA
        (shifted batched block products, no gathers); None when the block
        pattern is not banded enough or the dense bands would blow the
        memory budget (same fill-ratio rule as the scalar DIA chooser)."""
        from ..sparse.device_op import DIA_MEM_BUDGET, DIA_MEM_FLOOR

        if A_bsr is None or A_bsr.blocksize != (q, q):
            A_bsr = A_csr.tobsr(blocksize=(q, q))
        nb = A_bsr.shape[0] // q
        brows = np_.repeat(np_.arange(nb), np_.diff(A_bsr.indptr))
        n_off = np_.unique(A_bsr.indices - brows).size
        stored = n_off * nb * q * q
        if stored > max(DIA_MEM_BUDGET * max(A_bsr.nnz, 1), DIA_MEM_FLOOR):
            return None
        try:
            blocks, offs = SparseBDIA.host_blocks(
                A_bsr, max_offsets=64, dtype=npdt)
        except ValueError:
            return None
        return SparseBDIA(blocks=stage_array(blocks), offsets=offs,
                          shape=A_csr.shape)

    for lvl in levels:
        q_lvl = max(getattr(lvl, "blocksize", 1), 1)
        lvl.A = None
        if q_lvl > 1 and getattr(lvl, "grid", None) is not None:
            # Scalar-DIA first even for blocked levels: a uniform-block
            # banded operator IS a scalar DIA with <= n_off*(2q-1)
            # diagonals (block row i, intra offset d=j-i land on scalar
            # diagonal o*q+d), and the flattened form is a streamed
            # shift-multiply-add with no gather, where the BDIA einsum
            # gathers block rows of x.  BDIA remains the
            # fallback when the scalar chooser declines (too many
            # offsets / memory budget).
            op = device_operator(lvl.A_csr, dtype=npdt)
            if isinstance(op, SparseDIA) or type(op).__name__ == "DenseOp":
                lvl.A = op
            else:
                lvl.A = _banded_device_op(lvl.A_csr, q_lvl,
                                          A_bsr=getattr(lvl, "A_bsr", None))
        if lvl.A is None:
            lvl.A = device_operator(lvl.A_csr, dtype=npdt)
        if not hasattr(lvl, "P_csr"):
            continue
        meta = getattr(lvl, "struct_meta", None)
        if meta is None:
            # general (unstructured) path: try the aggregate-root DIA
            # embedding first — gather-free transfers whenever the embedded
            # pattern is banded (grid-ordered aggregates)
            from ..sparse.embed import root_embedded_transfers

            emb = root_embedded_transfers(lvl, dtype=npdt)
            if emb is not None:
                lvl.P, lvl.R = emb
            else:
                lvl.P = device_operator(lvl.P_csr, dtype=npdt)
                lvl.R = device_operator(lvl.R_csr, dtype=npdt)
            continue
        n_f, n_c = lvl.P_csr.shape
        q = meta.get("q", 1)
        wmap = meta["wmap"]
        if npdt is not None:
            wmap = wmap.astype(npdt, copy=False)
        wmap = stage_array(wmap)
        Tdev = GridRepeatOp(wmap=wmap, fine_grid=meta["grid"],
                            block=meta["block"], shape=(n_f, n_c),
                            node_dofs=q)
        # For symmetry='symmetric' the host builds R_csr = P.T (no
        # conjugation) — the device restriction must match it, else the
        # compiled cycle uses an R inconsistent with the Galerkin coarse
        # operators (real wmap: conj is a no-op either way).
        pool_conj = (np_.iscomplexobj(meta["wmap"])
                     and getattr(lvl, "symmetry", "hermitian") == "hermitian")
        Ttdev = GridPoolOp(wmap=wmap, fine_grid=meta["grid"],
                           block=meta["block"], shape=(n_c, n_f),
                           node_dofs=q, conj=pool_conj)
        if meta["degree"] == 0 or meta["S_csr"] is None:
            lvl.P = Tdev
            lvl.R = Ttdev
            continue
        # S = I - c D^{-1} A shares A's banded structure.  Both S and S^H
        # are staged entirely on the host (numpy diagonal/block shifts) so
        # each costs one H2D upload and zero device compiles/dispatches —
        # setup-time eager device ops pay a per-shape XLA compile at every
        # level.
        s_shape = meta["S_csr"].shape
        if q > 1:
            s_blocks, s_boffs = SparseBDIA.host_blocks(
                meta["S_csr"].tobsr(blocksize=(q, q)), dtype=npdt)
            S = SparseBDIA(blocks=stage_array(s_blocks), offsets=s_boffs,
                           shape=s_shape)
            sh_blocks, sh_boffs = SparseBDIA.host_transpose(
                s_blocks, s_boffs,
                conj=(np_.iscomplexobj(meta["S_csr"].data)
                      and getattr(lvl, "symmetry", "hermitian")
                      == "hermitian"))
            SH = SparseBDIA(blocks=stage_array(sh_blocks),
                            offsets=sh_boffs, shape=s_shape)
        else:
            # native two-pass staging discovers S's offsets itself (they
            # coincide with A's plus the diagonal)
            s_diags, s_uniq = SparseDIA.host_diags(meta["S_csr"], dtype=npdt,
                                                   max_offsets=1024)
            S = SparseDIA(diags=stage_array(s_diags), offsets=s_uniq,
                          shape=s_shape)
            sh_diags, sh_offs = SparseDIA.host_transpose(s_diags, s_uniq,
                                                         s_shape)
            if np_.iscomplexobj(meta["S_csr"].data) \
                    and getattr(lvl, "symmetry", "hermitian") == "hermitian":
                sh_diags = sh_diags.conj()
            SH = SparseDIA(diags=stage_array(sh_diags), offsets=sh_offs,
                           shape=s_shape[::-1])
        chain_P = tuple([S] * meta["degree"] + [Tdev])
        chain_R = tuple([Ttdev] + [SH] * meta["degree"])
        lvl.P = ComposedOp(ops=chain_P, shape=(n_f, n_c))
        lvl.R = ComposedOp(ops=chain_R, shape=(n_c, n_f))


def _add_identity_inplace(S_data, A, n):
    """I + (matrix with A's sparsity and data S_data), without an SpADD —
    valid when A stores its full diagonal (falls back to eye-plus if not)."""
    diag_mask = A.indices == np.repeat(np.arange(n), np.diff(A.indptr))
    if int(diag_mask.sum()) == n:
        S_data[diag_mask] += 1.0
        return sp.csr_matrix((S_data, A.indices, A.indptr), shape=A.shape)
    S = sp.csr_matrix((S_data, A.indices, A.indptr), shape=A.shape)
    return (sp.eye(n, format="csr") + S).tocsr()


def structured_smoother_S(A, grid, block, q_lvl, sfn, skw, symmetry):
    """Prolongation-smoother matrix for the structured path: ``P = S^degree
    @ T``.  Returns ``(S_csr_or_None, degree)``.

    Shared by :func:`_extend_structured` and the adaptive general setup
    stage (which must rebuild enlarged-candidate-space levels with the SAME
    smoother the final structured build will use — re-smoothing with the
    full generic Jacobi S there both fattens the coarse stencils, making
    the scipy RAP chain the dominant αSA setup cost, and polishes the
    candidate against a hierarchy that differs from the one it ends up in).
    """
    from ..util.utils import get_diagonal
    from ..util.linalg import approximate_spectral_radius
    from ..relaxation.smoothing import rho_D_inv_A

    n = A.shape[0]
    degree = int(skw.get("degree", 1)) if sfn else 0
    sym_hint = (symmetry in ("hermitian", "symmetric")
                and not np.iscomplexobj(A.data))
    if degree == 0 or sfn is None:
        return None, degree
    # S depends only on (A, block, q, smoother) — not on the candidates —
    # and adaptive SA recomputes it for the SAME fine operator across the
    # initial-stage descent, every full rebuild, and the general stage
    # (its rho estimate is a Lanczos run over all of A).  Cache it on the
    # matrix with a value probe, like the zebra line-setup cache.
    key = (tuple(int(b) for b in block), int(q_lvl), sfn,
           tuple(sorted(skw.items())), bool(sym_hint))
    stride = max(1, A.data.shape[0] // 64)
    probe = A.data[::stride]
    cache = getattr(A, "_struct_S", None)
    if (cache is not None and cache[0] == key
            and np.array_equal(cache[1], probe)):
        return cache[2], degree
    from ..amg_core import identity_minus_rowscaled_native

    S_csr = None
    if sfn == "jacobi":
        omega = float(skw.get("omega", 4.0 / 3.0))
        c = omega / rho_D_inv_A(A, symmetric=sym_hint)
        Dinv = get_diagonal(A, inv=True)
        # S = I - c D^{-1} A built in place on A's sparsity (A from a PDE
        # stencil holds its full diagonal), avoiding the eye-minus SpADD;
        # the native one-pass kernel matches the numpy expression
        # ((-c) * Dinv_i) * A_ij bit-for-bit
        Sx = identity_minus_rowscaled_native(A, Dinv, c)
        if Sx is not None:
            S_csr = sp.csr_matrix((Sx, A.indices, A.indptr), shape=A.shape)
        else:
            S_data = (-c) * np.repeat(Dinv, np.diff(A.indptr)) * A.data
            S_csr = _add_identity_inplace(S_data, A, n)
    elif sfn == "richardson":
        omega = float(skw.get("omega", 4.0 / 3.0))
        c = omega / approximate_spectral_radius(
            A, symmetric=sym_hint or None)
        S_data = (-c) * A.data.copy()
        S_csr = _add_identity_inplace(S_data, A, n)
    elif sfn == "jacobi_weak":
        # Jacobi prolongation smoothing restricted to the COARSENED axes:
        # stencil couplings with a nonzero delta along an uncoarsened
        # (strong) axis are dropped before building S = I - c D^{-1} A_w,
        # so S's support lies along the weak axes (plus intra-node dofs)
        # and S P keeps strong-axis width 1.
        omega = float(skw.get("omega", 4.0 / 3.0))
        # intra-node dof offsets overlap the smallest grid stride when
        # q_lvl > 1 (|intra| reaches q-1, >= stride/2 for q >= 2), so strip
        # them exactly first and decompose the NODE offset over node
        # strides — the dof-stride rint decomposition misclassified e.g.
        # the dof0<->dof2 coupling at q=3 as a +-1 step on the last axis
        strides_w = [int(np.prod(grid[kk + 1:])) for kk in range(len(grid))]
        from ..amg_core import weak_axis_filter_native

        Aw = weak_axis_filter_native(A, q_lvl, strides_w, block)
        if Aw is not None:
            # match the numpy path's eliminate_zeros (drops stored zeros)
            if Aw.nnz and not Aw.data.all():
                Aw.eliminate_zeros()
        else:
            rows_w = np.repeat(np.arange(n, dtype=np.int64),
                               np.diff(A.indptr))
            rem = A.indices.astype(np.int64) // q_lvl - rows_w // q_lvl
            keep_w = np.ones(A.nnz, dtype=bool)
            for k in np.argsort(strides_w)[::-1]:
                s = strides_w[k]
                dk = np.rint(rem / s).astype(np.int64)
                rem = rem - dk * s
                if block[k] == 1:
                    keep_w &= dk == 0
            # fresh index arrays: eliminate_zeros compacts them IN PLACE
            # before pruning, which would corrupt A's shared arrays
            Aw = sp.csr_matrix((np.where(keep_w, A.data, 0),
                                A.indices.copy(), A.indptr.copy()),
                               shape=A.shape)
            Aw.eliminate_zeros()
        c = omega / rho_D_inv_A(Aw, symmetric=sym_hint)
        Dinv = get_diagonal(A, inv=True)
        Sx = identity_minus_rowscaled_native(Aw, Dinv, c)
        if Sx is not None:
            S_csr = sp.csr_matrix((Sx, Aw.indices, Aw.indptr),
                                  shape=Aw.shape)
        else:
            S_data = (-c) * np.repeat(Dinv, np.diff(Aw.indptr)) * Aw.data
            S_csr = _add_identity_inplace(S_data, Aw, n)
    try:
        A._struct_S = (key, probe.copy(), S_csr)
    except AttributeError:           # exotic matrix types: skip the cache
        pass
    return S_csr, degree


def _extend_structured(levels, lvl, A, B, grid, sfn, skw, akw, keep,
                       symmetry):
    """One structured coarsening step: grid-block aggregation + (optional)
    Jacobi/Richardson prolongation smoothing, recorded with the metadata the
    finalize step needs to build gather-free device operators.

    Supports K near-nullspace candidates: coarse levels then carry K dofs
    per grid node (node-major), the tentative transfers become K-channel
    grid ops, and the coarse operators are block-banded (SparseBDIA)."""
    from .tentative import fit_candidates

    block = akw.get("block")
    if block is None:
        # per-level anisotropy-aware blocks: under strong grid-aligned
        # anisotropy, line relaxation (zebra) solves along the strong axis
        # and the remaining error is smooth along the WEAK axes only —
        # coarsen those, keep the strong axis fine (semicoarsening).
        # Prolongation smoothing is disabled for such levels: smoothing P
        # along an uncoarsened axis widens the coarse stencil without bound.
        strides = [int(np.prod(grid[kk + 1:])) * max(
            getattr(lvl, "blocksize", 1), 1) for kk in range(len(grid))]
        coup = np.array([np.abs(A.diagonal(s)).sum() + 1e-300
                         for s in strides])
        line_smoothing = getattr(lvl, "_line_smoother", False)
        # Width of the weak-axis aggregates: ALWAYS 3 grid nodes.  Two-grid
        # convergence under semicoarsening is bounded by the GRID coarsening
        # rate along the weak axis, not the DOF count: w = 3K (which keeps
        # the DOF ratio at 3 for K candidates) coarsens the weak axis 3K-x
        # per level and measurably loses mesh independence — K=2 aniso-512
        # needs 18 iterations even with ideal analytic candidates, vs 8
        # with w = 3 (and 13 for K=1).  The price is a one-time DOF ratio
        # of 3/K at level 0 only (coarse levels carry q=K dofs/node, so
        # w = 3 there already gives ratio 3).
        K_cand = B.shape[1]
        q_node = max(getattr(lvl, "blocksize", 1), 1)
        if (line_smoothing and K_cand % max(q_node, 1) == 0
                and q_node in (1, K_cand) and len(grid) >= 2
                and coup.max() > 25.0 * coup.min()):
            geo = float(np.sqrt(coup.max() * coup.min()))
            w = 3
            block = tuple(1 if c > geo else w for c in coup)
            # Smoothing P with the full S = I - c D^{-1} A would widen the
            # stencil along the UNCOARSENED strong axis without bound (that
            # axis never coarsens, so RAP accumulates bands every level).
            # Restricted to the coarsened weak axes, S's support lies inside
            # the aggregates' axes: P keeps strong-axis width 1 and the
            # coarse stencil stays bounded — while the weak-axis
            # interpolation regains the accuracy tentative-only P lacks.
            sfn, skw = "jacobi_weak", {}
        else:
            block = (3,) * len(grid)
    block = tuple(block)
    if all(b == 1 for b in block):
        block = (3,) * len(grid)
    AggOp, roots, cgrid = grid_aggregation(grid, block)
    T, B_coarse = fit_candidates(AggOp, B)
    T = T.tocsr()
    T.sort_indices()

    n = A.shape[0]
    K = B.shape[1]
    q_lvl = max(getattr(lvl, "blocksize", 1), 1)
    if K == 1 and q_lvl == 1:
        wmap = np.zeros(n, dtype=A.dtype)
        rows_w = np.repeat(np.arange(n), np.diff(T.indptr))
        wmap[rows_w] = T.data
    else:
        # 2-D wmap (n_dofs, K): required whenever the fine level is
        # node-blocked (q_lvl > 1), even for K == 1 — the 1-D grid-op form
        # assumes one dof per grid node
        wmap = np.zeros((n, K), dtype=A.dtype)
        rows_w = np.repeat(np.arange(n), np.diff(T.indptr))
        wmap[rows_w, T.indices % K] = T.data

    S_csr, degree = structured_smoother_S(A, grid, block, q_lvl, sfn, skw,
                                          symmetry)

    P = T
    for _ in range(degree):
        P = (S_csr @ P).tocsr()

    R = P.conjugate().T.tocsr() if symmetry == "hermitian" else P.T.tocsr()

    lvl.struct_meta = {"grid": tuple(grid), "block": block,
                       "wmap": wmap, "S_csr": S_csr, "degree": degree,
                       "sfn": sfn, "skw": dict(skw) if skw else {},
                       "K": K, "q": max(getattr(lvl, "blocksize", 1), 1)}
    lvl.P_csr = P
    lvl.R_csr = R
    if keep:
        lvl.AggOp = AggOp
        lvl.T = T

    A_coarse = (R @ A @ P).tocsr()
    A_coarse.eliminate_zeros()

    new = Level()
    new.A_csr = A_coarse
    new.B = B_coarse
    new.blocksize = K                 # K dofs per coarse grid node
    new.symmetry = symmetry
    new.A_bsr = None
    new.grid = cgrid
    # host-side line relaxation (adaptive candidate generation) reads the
    # geometry off the matrix itself; scalar levels only — node-blocked
    # lines need the block solver, which is device-side
    if K == 1:
        A_coarse.grid = cgrid
    new._line_smoother = getattr(lvl, "_line_smoother", False)
    levels.append(new)


def galerkin_product(lvl, A, bs, K_c, symmetry):
    """Coarse operator R A P for the level's just-built transfers.

    Blocked levels run it in BSR (dense (bs, K_c) block products — ~2x
    over scalar CSR merges for elasticity-class operators); returns
    ``(A_coarse_csr, A_coarse_bsr_or_None)``.  Shared by the SA and
    rootnode builders (reference aggregation.py:428 / rootnode.py:456)."""
    A_coarse_bsr = None
    if (bs > 1 and getattr(lvl, "A_bsr", None) is not None and K_c > 1
            and lvl.P_csr.shape[0] % bs == 0
            and lvl.P_csr.shape[1] % K_c == 0):
        try:
            Pb = lvl.P_csr.tobsr(blocksize=(bs, K_c))
            if symmetry == "hermitian":
                Rb = Pb.conjugate().transpose()
            elif symmetry == "symmetric":
                Rb = Pb.transpose()
            else:
                Rb = lvl.R_csr.tobsr(blocksize=(K_c, bs))
            A_coarse_bsr = Rb @ lvl.A_bsr @ Pb
            A_coarse = A_coarse_bsr.tocsr()
        except ValueError:
            A_coarse_bsr = None
    if A_coarse_bsr is None:
        A_coarse = (lvl.R_csr @ A @ lvl.P_csr).tocsr()
    A_coarse.eliminate_zeros()
    return A_coarse, A_coarse_bsr


def coarse_bsr_twin(A_coarse, A_coarse_bsr, blocksize, filtered=False):
    """The coarse level's cached BSR twin: reuse the BSR Galerkin output
    when its blocksize matches and the CSR wasn't post-filtered."""
    if blocksize <= 1 or A_coarse.shape[0] % blocksize:
        return None
    if (A_coarse_bsr is not None and not filtered
            and A_coarse_bsr.blocksize == (blocksize, blocksize)):
        A_coarse_bsr.eliminate_zeros()
        return A_coarse_bsr
    return A_coarse.tobsr(blocksize=(blocksize, blocksize))


def _extend_sa_hierarchy(levels, strength, aggregate, smooth,
                         improve_candidates, diagonal_dominance, keep,
                         symmetry, coarse_filter=None):
    """One SA coarsening step (reference aggregation.py:293)."""
    lvl = levels[-1]
    A = lvl.A_csr
    B = lvl.B
    bs = lvl.blocksize
    i = len(levels) - 1

    A_for_strength = lvl.A_bsr if (bs > 1 and lvl.A_bsr is not None) else A

    # improve candidates by relaxing on A B = 0
    ic = improve_candidates[i]
    if ic is not None:
        b0 = np.zeros((A.shape[0], 1), dtype=A.dtype)
        op = relaxation_as_linear_operator(ic, A, b0)
        B = np.column_stack([op @ B[:, k] for k in range(B.shape[1])])
        lvl.B = B
        if symmetry == "nonsymmetric":
            AH = A.conjugate().T.tocsr()
            opH = relaxation_as_linear_operator(ic, AH, b0)
            lvl.BH = np.column_stack([opH @ lvl.BH[:, k]
                                      for k in range(lvl.BH.shape[1])])

    # --- structured-grid fast path --------------------------------------
    # grid-block aggregation keeps every level a stencil matrix: device
    # operators become DIA + reshape/repeat grid transfers (no gathers)
    grid = getattr(lvl, "grid", None)
    sfn, skw = unpack_arg(smooth[i]) if smooth[i] is not None else (None, {})
    afn, akw = unpack_arg(aggregate[i])
    # q = dofs per grid node: 1 at a scalar fine level; the BSR blocksize
    # at a blocked fine level (e.g. 2 for 2D elasticity); K at the coarse
    # levels of a K-candidate structured hierarchy (node-major ordering)
    q = max(bs, 1)
    # auto-dispatch only for 2D grids: 3^d grid-block aggregation in 3D
    # over-coarsens vs strength-based aggregation (17 vs 13 iterations on
    # 64^3 Poisson); 3D keeps reference-parity quality by default and the
    # structured path stays available via aggregate=('grid', {...})
    if (grid is not None
            and symmetry in ("hermitian", "symmetric")
            and (afn == "grid" or (afn == "standard" and len(grid) == 2))
            and sfn in (None, "jacobi", "richardson")
            and np.prod(grid) * q == A.shape[0]):
        _extend_structured(levels, lvl, A, B, grid, sfn, skw, akw, keep,
                           symmetry)
        return

    C = _strength(A_for_strength, B, strength[i])
    if diagonal_dominance:
        fn, kwargs = (diagonal_dominance, {}) \
            if not isinstance(diagonal_dominance, tuple) else \
            (True, diagonal_dominance[1])
        C = eliminate_diag_dom_nodes(A, C, **(kwargs if isinstance(kwargs,
                                                                   dict)
                                              else {}))

    AggOp, Cpts = _aggregate(C, A_for_strength, B, aggregate[i])
    if AggOp.shape[1] == 0:
        return

    T, B_coarse = fit_candidates(AggOp, B)
    if symmetry == "nonsymmetric":
        TH, BH_coarse = fit_candidates(AggOp, lvl.BH)

    P = _smooth_P(T, A_for_strength, C, B_coarse, smooth[i],
                  sym_hint=symmetry != "nonsymmetric")

    if symmetry in ("hermitian",):
        R = P.conjugate().T.tocsr()
    elif symmetry == "symmetric":
        R = P.T.tocsr()
    else:
        # nonsymmetric: smooth restriction from A^H
        AH = (lvl.A_bsr.conjugate().T.tobsr() if (bs > 1 and
                                                  lvl.A_bsr is not None)
              else A.conjugate().T.tocsr())
        CH = _strength(AH, lvl.BH, strength[i])
        RH = _smooth_P(TH, AH, CH, BH_coarse, smooth[i])
        R = RH.conjugate().T.tocsr()

    lvl.C = C if keep else None
    if keep:
        lvl.AggOp = AggOp
        lvl.T = T
    lvl.P_csr = to_csr(P)
    lvl.R_csr = to_csr(R)

    # aggregate-root embedding positions for the gather-free DIA transfer
    # form (sparse/embed.py): coarse dof agg*K+k embeds at fine dof
    # roots[agg]*q+k — injective when K matches the fine dofs/node (scalar
    # K=1 levels and the node-blocked coarse levels of any K-candidate
    # hierarchy; level 0 of a blocked problem with K != q falls back to ELL)
    if Cpts is not None:
        n_agg = AggOp.shape[1]
        nc = lvl.P_csr.shape[1]
        roots = np.asarray(Cpts, dtype=np.int64)
        if n_agg and roots.size == n_agg and nc % n_agg == 0:
            K = nc // n_agg
            q = max(bs, 1)
            if K == q or (q == 1 and K == 1):
                lvl.root_dofs = (roots[:, None] * q
                                 + np.arange(K)[None, :]).ravel()

    A_coarse, A_coarse_bsr = galerkin_product(lvl, A, bs,
                                              B_coarse.shape[1], symmetry)
    if coarse_filter:
        # drop weak Galerkin fill-in with diagonal lumping (row sums kept;
        # ≙ filter_matrix_rows util/utils.py:2009) — bounds coarse-operator
        # densification, keeping levels on the DIA fast path
        from ..util.utils import filter_matrix_rows

        theta = coarse_filter if isinstance(coarse_filter, float) else 1e-2
        A_coarse = filter_matrix_rows(A_coarse, theta, lump=True)

    new = Level()
    new.A_csr = A_coarse
    new.B = B_coarse
    new.blocksize = B.shape[1] if B.shape[1] > 1 else 1
    new.symmetry = symmetry
    if symmetry == "nonsymmetric":
        new.BH = BH_coarse
    new.A_bsr = coarse_bsr_twin(A_coarse, A_coarse_bsr, new.blocksize,
                                filtered=bool(coarse_filter))
    levels.append(new)
