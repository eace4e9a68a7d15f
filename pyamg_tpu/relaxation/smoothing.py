"""Smoother factory: bind pre/post smoothers onto hierarchy levels.

Reference parity: pyamg/relaxation/smoothing.py (``change_smoothers`` :24,
``rho_D_inv_A`` :172, the ``setup_*`` family :320-512).

Each option is precomputed into a :class:`SmootherData` pytree consumed by the
compiled device cycle.  Sequential methods are realized by their multicolor
reformulation (colors from Jones-Plassmann, graph.py) so the compiled cycle
stays SIMD-parallel; lexicographic host smoothers remain available in
:mod:`pyamg_tpu.relaxation.relaxation` for parity testing.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..util.staging import stage_array

from ..util.utils import unpack_arg, get_block_diag
from ..util.linalg import approximate_spectral_radius
from .chebyshev import chebyshev_polynomial_coefficients
from .device import SmootherData

__all__ = ["change_smoothers", "rho_D_inv_A", "rho_block_D_inv_A",
           "make_smoother_data"]

DEFAULT_SWEEP = "forward"
DEFAULT_NITER = 1


def rho_D_inv_A(A_csr, symmetric=None):
    """Spectral radius of D^{-1} A (reference smoothing.py:172).

    ``symmetric=True`` (a caller-supplied *hint*, e.g. from the hierarchy's
    symmetry tag) uses the similarity D^{-1}A ~ D^{-1/2} A D^{-1/2} and a
    Lanczos estimate — ~5x cheaper on large matrices.  Requires a positive
    diagonal; falls back to the Arnoldi path otherwise."""
    cached = getattr(A_csr, "rho_D_inv", None)
    if cached is not None:
        return cached
    d = A_csr.diagonal()
    mask = d != 0
    import scipy.sparse as sp

    if symmetric and not np.iscomplexobj(d) and (d > 0).all():
        # the 1%-accuracy Lanczos estimate doesn't need f64: f32 matvecs
        # halve the bandwidth of the dominant cost on the host
        A_rho = A_csr.astype(np.float32) if A_csr.dtype == np.float64 \
            else A_csr
        dhalf_inv = (1.0 / np.sqrt(d)).astype(A_rho.dtype, copy=False)

        class _Scaled:            # D^{-1/2} A D^{-1/2} without materializing
            shape = A_csr.shape
            dtype = A_rho.dtype

            @staticmethod
            def matvec(v):
                return dhalf_inv * (A_rho @ (dhalf_inv * v))

        rho = approximate_spectral_radius(_Scaled(), symmetric=True)
    else:
        dinv = np.zeros_like(d)
        dinv[mask] = 1.0 / d[mask]
        DinvA = sp.dia_matrix((dinv[None, :], [0]),
                              shape=A_csr.shape) @ A_csr
        rho = approximate_spectral_radius(DinvA)
    try:
        A_csr.rho_D_inv = rho
    except (AttributeError, TypeError):
        pass
    return rho


def rho_block_D_inv_A(A_csr, Dinv):
    """Spectral radius of blockdiag(D)^{-1} A (reference smoothing.py:203)."""
    import scipy.sparse as sp

    bs = Dinv.shape[-1]
    nb = Dinv.shape[0]
    Dinv_mat = sp.bsr_matrix(
        (Dinv, np.arange(nb), np.arange(nb + 1)),
        shape=A_csr.shape).tocsr()
    return approximate_spectral_radius(Dinv_mat @ A_csr)


def _dinv(A_csr, dtype=None):
    d = A_csr.diagonal()
    mask = d != 0
    out = np.zeros_like(d)
    out[mask] = 1.0 / d[mask]
    if dtype is not None:
        out = out.astype(dtype, copy=False)
    return out


def _grid_coloring(grid, offsets):
    """Exact geometric coloring for a grid stencil: checkerboard (2 colors)
    when the stencil is a cross, else 2^d block coloring (valid for any
    3^d neighborhood stencil)."""
    import itertools

    grid = tuple(grid)
    d = len(grid)
    strides = [int(np.prod(grid[k + 1:])) for k in range(d)]
    cross = {0}
    for k in range(d):
        cross.add(strides[k])
        cross.add(-strides[k])
    coords = np.unravel_index(np.arange(int(np.prod(grid))), grid)
    if set(offsets) <= cross:
        return (sum(coords) % 2).astype(np.int32)
    color = np.zeros(int(np.prod(grid)), dtype=np.int32)
    for k in range(d):
        color = 2 * color + (coords[k] % 2).astype(np.int32)
    return color


def _coloring(A_csr, blocksize=1, grid=None, offsets=None):
    """Graph coloring of A (per node): geometric (2 or 2^d colors) on
    structured grids, greedy first-fit / Jones-Plassmann otherwise.

    ``offsets``: known distinct diagonal offsets (skips the O(nnz)
    rediscovery when the level's device operator is DIA)."""
    from ..graph import vertex_coloring
    from ..util.utils import amalgamate

    G = amalgamate(A_csr, blocksize) if blocksize > 1 else A_csr
    colors = None
    if grid is not None and blocksize == 1 \
            and int(np.prod(grid)) == G.shape[0]:
        import itertools

        if offsets is None:
            coo = G.tocoo()
            offs = np.unique(coo.col.astype(np.int64)
                             - coo.row.astype(np.int64))
        else:
            offs = np.asarray(offsets, dtype=np.int64)
        strides = [int(np.prod(tuple(grid)[k + 1:]))
                   for k in range(len(grid))]
        # geometric coloring is valid when every offset is a 3^d-neighborhood
        # move: sum of delta_k * stride_k with delta in {-1, 0, 1}
        valid_offs = {sum(d * s for d, s in zip(deltas, strides))
                      for deltas in itertools.product((-1, 0, 1),
                                                      repeat=len(grid))}
        if set(int(o) for o in offs) <= valid_offs:
            colors = _grid_coloring(grid, offs.tolist())
    if colors is None:
        # native greedy first-fit: one O(nnz) pass and fewer colors than
        # Jones-Plassmann rounds (fewer colors = fewer sequential sub-sweeps
        # in the compiled multicolor smoother); JP is the pure-numpy fallback
        from ..amg_core import have_native

        colors = vertex_coloring(G, method="FF" if have_native() else "JP")
    return np.asarray(colors)


def _color_masks(A_csr, blocksize=1, dtype=None, grid=None, offsets=None,
                 colors=None):
    """(ncolors, n) float masks from a graph coloring of A."""
    if colors is None:
        colors = _coloring(A_csr, blocksize=blocksize, grid=grid,
                           offsets=offsets)
    ncolors = int(colors.max()) + 1
    nb = colors.shape[0]
    rdt = dtype or np.real(np.zeros(0, dtype=A_csr.dtype)).dtype
    masks = np.zeros((ncolors, nb), dtype=rdt)
    masks[colors, np.arange(nb)] = 1
    if blocksize > 1:
        masks = np.repeat(masks, blocksize, axis=1)
    return stage_array(masks)


def _color_gather_arrays(A_csr, colors, dtype=None):
    """Per-color padded row arrays for the gather-form multicolor GS:
    ``(color_rows (C,R) int32 -1-padded, color_cols (C,R,W) int32,
    color_data (C,R,W))``.

    The mask-form sweep costs one FULL matvec per color — ruinous on
    gather-bound (ELL) levels with dozens of colors.  The gather form
    touches every matrix row exactly once per sweep (one matvec-equivalent
    total) by updating only each color's own rows."""
    n = A_csr.shape[0]
    colors = np.asarray(colors)
    C = int(colors.max()) + 1
    counts = np.bincount(colors, minlength=C)
    R = int(counts.max())
    nnz_row = np.diff(A_csr.indptr)
    W = int(nnz_row.max()) if n else 0
    order = np.argsort(colors, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(n) - starts[colors[order]]
    color_rows = np.full((C, R), -1, dtype=np.int32)
    color_rows[colors[order], slot] = order.astype(np.int32)
    # entry scatter: (color, slot, pos-in-row)
    rows_e = np.repeat(np.arange(n), nnz_row)
    pos_e = np.arange(A_csr.nnz) - np.repeat(A_csr.indptr[:-1], nnz_row)
    slot_of_row = np.empty(n, dtype=np.int64)
    slot_of_row[order] = slot
    dt = dtype or A_csr.dtype
    color_cols = np.zeros((C, R, W), dtype=np.int32)
    color_data = np.zeros((C, R, W), dtype=dt)
    color_cols[colors[rows_e], slot_of_row[rows_e], pos_e] = \
        A_csr.indices.astype(np.int32, copy=False)
    color_data[colors[rows_e], slot_of_row[rows_e], pos_e] = \
        A_csr.data.astype(dt, copy=False)
    return (stage_array(color_rows), stage_array(color_cols),
            stage_array(color_data))


def make_smoother_data(lvl, fn_name, kwargs, dtype=None) -> SmootherData:
    """Build the precomputed SmootherData for one option on one level.

    ``dtype``: target device dtype — state arrays are cast on the host
    before the H2D transfer.  Results are cached on the level (pre/post
    smoothers are usually identical, halving the H2D traffic)."""
    try:
        cache_key = (fn_name, tuple(sorted(kwargs.items())), str(dtype))
        cache = lvl.__dict__.setdefault("_smoother_cache", {})
        if cache_key in cache:
            return cache[cache_key]
    except TypeError:
        cache_key = cache = None        # unhashable kwargs (arrays)

    sm = _make_smoother_data(lvl, fn_name, kwargs, dtype)
    if cache is not None:
        cache[cache_key] = sm
    return sm


def _make_block_line_data(lvl, A_csr, grid, q, fn_name, iterations, sweep,
                          kwargs, npdt) -> SmootherData:
    """Line-relaxation data for a node-blocked structured level: the lines
    along the strong axis are BLOCK-tridiagonal (q x q node blocks), solved
    by block parallel cyclic reduction on the device.

    line_tri: (3, q, q, nlines, L) [sub, diag, super] node-block diagonals
    in COMPONENT layout — block indices leading so any tiling of the two
    minor axes pads the large (nlines, L) plane, not the tiny q x q block.
    5-D marks the blocked form to ``line_relaxation_step``."""
    nb = int(np.prod(grid))
    A_bsr = A_csr.tobsr(blocksize=(q, q))
    A_bsr.sort_indices()
    strides = [int(np.prod(grid[k + 1:])) for k in range(len(grid))]
    axis = kwargs.get("axis")
    if axis is None:
        # strongest coupling direction, via same-dof node-neighbor coupling
        coup = [np.abs(A_csr.diagonal(s * q)).sum() for s in strides]
        axis = int(np.argmax(coup))
    axis = axis % len(grid)
    stride = strides[axis]
    L = grid[axis]

    brows = np.repeat(np.arange(nb), np.diff(A_bsr.indptr))
    delta = A_bsr.indices - brows
    blocks = A_bsr.data
    d = np.zeros((nb, q, q), dtype=A_csr.dtype)
    du = np.zeros((nb, q, q), dtype=A_csr.dtype)
    dl = np.zeros((nb, q, q), dtype=A_csr.dtype)
    for target, want in ((d, 0), (du, stride), (dl, -stride)):
        m = delta == want
        target[brows[m]] = blocks[m]
    # zero couplings across line ends (block-diagonal extraction cannot
    # wrap, but guard against degenerate grids)
    coords = np.unravel_index(np.arange(nb), grid)
    du[coords[axis] == L - 1] = 0.0
    dl[coords[axis] == 0] = 0.0
    # Zero dof rows (e.g. locally-eliminated aSA candidates produce zero
    # columns in T, hence zero rows/columns in the coarse operator) make
    # the node diagonal blocks singular; identity-ize those dofs so the
    # block solves stay nonsingular (their line residual is zero, so the
    # update for them is exactly zero).
    rowmass = (np.abs(d).sum(axis=2) + np.abs(du).sum(axis=2)
               + np.abs(dl).sum(axis=2))                       # (nb, q)
    zr = rowmass == 0
    if zr.any():
        nz_n, nz_q = np.nonzero(zr)
        d[nz_n, nz_q, nz_q] = 1.0

    def lines(blk):
        # (grid..., q, q) -> (nlines, L, q, q) with the line axis innermost
        g = blk.reshape(grid + (q, q))
        g = np.moveaxis(g, axis, len(grid) - 1)
        return g.reshape(-1, L, q, q)

    tri = np.stack([lines(dl), lines(d), lines(du)])
    tri = np.ascontiguousarray(tri.transpose(0, 3, 4, 1, 2))
    omega = float(kwargs.get("omega",
                             0.7 if fn_name == "line_jacobi" else 1.0))
    kind = "line_jacobi" if fn_name == "line_jacobi" else "zebra"
    return SmootherData(kind=kind, iterations=iterations, sweep=sweep,
                        omega=omega,
                        line_tri=stage_array(
                            tri if npdt is None
                            else tri.astype(npdt, copy=False)),
                        grid=grid, line_axis=axis)


def _make_smoother_data(lvl, fn_name, kwargs, dtype=None) -> SmootherData:
    if not hasattr(lvl, "A_csr"):
        # device-built hierarchies materialize host twins lazily
        lvl.A_csr = lvl.A.to_scipy()
    A_csr = lvl.A_csr
    npdt = None if dtype is None else np.dtype(str(jnp.dtype(dtype)))
    rdt = None if npdt is None else np.real(np.zeros(0, dtype=npdt)).dtype
    iterations = int(kwargs.get("iterations", DEFAULT_NITER))
    sweep = kwargs.get("sweep", DEFAULT_SWEEP)
    # known diagonal offsets of the level's device operator (skips O(nnz)
    # structure rediscovery in the coloring)
    A_dev = getattr(lvl, "A", None)
    from ..sparse import SparseDIA

    # scalar diagonal offsets (coloring hint); BDIA offsets are in block
    # units and must not be passed to the scalar coloring
    known_offsets = A_dev.offsets if isinstance(A_dev, SparseDIA) else None

    if fn_name is None or fn_name == "none":
        return SmootherData(kind="none")

    sym_hint = getattr(lvl, "_sym_hint", None)

    if fn_name == "jacobi":
        omega = float(kwargs.get("omega", 1.0))
        if kwargs.get("withrho", True):
            omega = omega / rho_D_inv_A(A_csr, symmetric=sym_hint)
        return SmootherData(kind="jacobi", iterations=iterations,
                            omega=omega,
                            dinv=stage_array(_dinv(A_csr, npdt)))

    if fn_name == "richardson":
        omega = float(kwargs.get("omega", 1.0))
        omega = omega / approximate_spectral_radius(A_csr)
        return SmootherData(kind="richardson", iterations=iterations,
                            omega=omega)

    grid = getattr(lvl, "grid", None)

    if fn_name in ("gauss_seidel", "multicolor_gauss_seidel"):
        from ..sparse import SparseELL as _ELL

        colors = _coloring(A_csr, grid=grid, offsets=known_offsets)
        if isinstance(A_dev, _ELL):
            # gather-form sweep: one matvec-equivalent per sweep instead of
            # ncolors full matvecs — decisive on gather-bound (ELL) levels.
            # DIA levels keep the mask form: their matvec is so cheap that
            # ncolors shift-multiply passes beat re-gathering the matrix.
            cr, cc, cd = _color_gather_arrays(A_csr, colors, dtype=npdt)
            return SmootherData(kind="gauss_seidel", iterations=iterations,
                                sweep=sweep,
                                dinv=stage_array(_dinv(A_csr, npdt)),
                                color_rows=cr, color_cols=cc, color_data=cd)
        return SmootherData(kind="gauss_seidel", iterations=iterations,
                            sweep=sweep,
                            dinv=stage_array(_dinv(A_csr, npdt)),
                            color_masks=_color_masks(
                                A_csr, dtype=rdt, grid=grid,
                                colors=colors))

    if fn_name == "sor":
        omega = float(kwargs.get("omega", 1.0))
        return SmootherData(kind="sor", iterations=iterations, sweep=sweep,
                            omega=omega,
                            dinv=stage_array(_dinv(A_csr, npdt)),
                            color_masks=_color_masks(
                                A_csr, dtype=rdt, grid=grid,
                                offsets=known_offsets))

    if fn_name in ("chebyshev", "polynomial"):
        if fn_name == "chebyshev":
            rho = approximate_spectral_radius(A_csr)
            a = rho * float(kwargs.get("lower_bound", 1.0 / 30.0))
            b = rho * float(kwargs.get("upper_bound", 1.1))
            degree = int(kwargs.get("degree", 3))
            coefficients = -chebyshev_polynomial_coefficients(a, b, degree)[:-1]
        else:
            coefficients = np.asarray(kwargs["coefficients"])
        return SmootherData(kind="polynomial", iterations=iterations,
                            coefficients=tuple(float(c) for c in coefficients))

    if fn_name in ("block_jacobi", "block_gauss_seidel"):
        bs = int(kwargs.get("blocksize", getattr(lvl, "blocksize", 1)))
        if bs == 1:
            # pointwise case: identical to the scalar smoothers, cheaper
            scalar = "jacobi" if fn_name == "block_jacobi" else "gauss_seidel"
            kwargs = {k: v for k, v in kwargs.items()
                      if k not in ("blocksize", "Dinv")}
            return make_smoother_data(lvl, scalar, kwargs, dtype=dtype)
        Dinv = kwargs.get("Dinv")
        if Dinv is None:
            A_blk = getattr(lvl, "A_bsr", None)
            if A_blk is None or A_blk.blocksize != (bs, bs):
                A_blk = A_csr
            Dinv = get_block_diag(A_blk, bs, inv_flag=True)
        Dinv = np.asarray(Dinv)
        if fn_name == "block_jacobi":
            omega = float(kwargs.get("omega", 1.0))
            if kwargs.get("withrho", True):
                omega = omega / rho_block_D_inv_A(A_csr, Dinv)
            return SmootherData(kind="block_jacobi", iterations=iterations,
                                omega=omega,
                                block_dinv=stage_array(
                                    Dinv if npdt is None
                                    else Dinv.astype(npdt, copy=False)),
                                blocksize=bs)
        return SmootherData(kind="block_gauss_seidel", iterations=iterations,
                            sweep=sweep,
                            block_dinv=stage_array(
                                Dinv if npdt is None
                                else Dinv.astype(npdt, copy=False)),
                            blocksize=bs,
                            color_masks=_color_masks(A_csr, blocksize=bs,
                                                     dtype=rdt))

    if fn_name in ("jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr"):
        # device path: damped Jacobi on the normal equations (the parallel
        # member of the Kaczmarz family; sequential NE/NR sweeps remain in
        # relaxation.relaxation for host parity).
        # NE (≙ relaxation.h:466,530): A A^H system, row 2-norms;
        # NR (≙ relaxation.h:595):     A^H A system, column 2-norms.
        from ..sparse import SparseELL

        omega = float(kwargs.get("omega", 1.0))
        if kwargs.get("withrho", True):
            # reference smoothing.py:452-456: omega /= rho(D^{-1}A)^2 — the
            # normal-equation operator's spectrum is the square of A's
            omega = omega / rho_D_inv_A(A_csr) ** 2
        AH = A_csr.conjugate().T.tocsr()
        axis = 1 if fn_name in ("jacobi_ne", "gauss_seidel_ne") else 0
        d = np.asarray(
            A_csr.multiply(A_csr.conjugate()).sum(axis=axis)).ravel().real
        mask = d != 0
        dinv_ne = np.zeros(d.shape, dtype=A_csr.dtype)
        dinv_ne[mask] = 1.0 / d[mask]
        kind = ("jacobi_ne" if fn_name in ("jacobi_ne", "gauss_seidel_ne")
                else "jacobi_nr")
        return SmootherData(kind=kind, iterations=iterations,
                            omega=omega, AT=SparseELL.from_scipy(AH),
                            dinv_ne=stage_array(
                                dinv_ne if npdt is None
                                else dinv_ne.astype(npdt, copy=False)))

    if fn_name in ("line_jacobi", "zebra", "line_gauss_seidel"):
        # exact tridiagonal solves along one grid axis (data-parallel line
        # relaxation for anisotropic problems; batched cyclic reduction)
        n_dof = A_csr.shape[0]
        q_node = max(getattr(lvl, "blocksize", 1), 1)
        if grid is not None and q_node > 1 \
                and int(np.prod(grid)) * q_node == n_dof:
            # node-blocked structured level (q dofs per grid node, e.g. the
            # K-channel coarse levels of a multi-candidate hierarchy):
            # BLOCK-tridiagonal line solves — the scalar fallback to point
            # GS here destroyed the line-relaxation property the
            # semicoarsened hierarchy above it relies on
            return _make_block_line_data(lvl, A_csr, tuple(
                int(g) for g in grid), q_node, fn_name, iterations, sweep,
                kwargs, npdt)
        if grid is None or int(np.prod(grid)) != n_dof:
            # level lost its grid structure (e.g. classical coarse levels):
            # fall back to multicolor GS, which needs no geometry
            return make_smoother_data(lvl, "gauss_seidel",
                                      {"iterations": iterations,
                                       "sweep": sweep}, dtype=dtype)
        grid = tuple(int(g) for g in grid)
        dgrid = len(grid)
        strides = [int(np.prod(grid[k + 1:])) for k in range(dgrid)]
        axis = kwargs.get("axis")
        if axis is None:
            # strongest coupling direction
            coup = [np.abs(A_csr.diagonal(s)).sum() for s in strides]
            axis = int(np.argmax(coup))
        axis = axis % dgrid
        stride = strides[axis]
        n = A_csr.shape[0]
        L = grid[axis]

        d_flat = A_csr.diagonal().astype(A_csr.dtype)
        du_flat = np.zeros(n, dtype=A_csr.dtype)
        du_flat[:n - stride] = A_csr.diagonal(stride)
        dl_flat = np.zeros(n, dtype=A_csr.dtype)
        dl_flat[stride:] = A_csr.diagonal(-stride)
        coords = np.unravel_index(np.arange(n), grid)
        du_flat[coords[axis] == L - 1] = 0.0
        dl_flat[coords[axis] == 0] = 0.0

        def lines(v):
            return np.moveaxis(v.reshape(grid), axis, -1).reshape(-1, L)

        tri = np.stack([lines(dl_flat), lines(d_flat), lines(du_flat)])
        omega = float(kwargs.get("omega",
                                 0.7 if fn_name == "line_jacobi" else 1.0))
        kind = "line_jacobi" if fn_name == "line_jacobi" else "zebra"
        return SmootherData(kind=kind, iterations=iterations, sweep=sweep,
                            omega=omega,
                            line_tri=stage_array(
                                tri if npdt is None
                                else tri.astype(npdt, copy=False)),
                            grid=grid, line_axis=axis)

    if fn_name in ("schwarz", "strength_based_schwarz"):
        # damped additive overlapping Schwarz: batched dense subdomain
        # solves (≙ relaxation.h:936, additive variant for SIMD execution)
        from .relaxation import schwarz_parameters
        from ..strength import classical_strength_of_connection

        base = A_csr
        if fn_name == "strength_based_schwarz":
            base = classical_strength_of_connection(A_csr, 0.0)
        sub, sub_ptr, inv, inv_ptr = schwarz_parameters(
            A_csr, kwargs.get("subdomain"), kwargs.get("subdomain_ptr"),
            kwargs.get("inv_subblock"), kwargs.get("inv_subblock_ptr"))
        n_dom = sub_ptr.shape[0] - 1
        sizes = np.diff(sub_ptr)
        L = int(sizes.max()) if n_dom else 1
        idx = np.full((n_dom, L), -1, dtype=np.int32)
        binv = np.zeros((n_dom, L, L), dtype=A_csr.dtype)
        for d in range(n_dom):
            s = sizes[d]
            idx[d, :s] = sub[sub_ptr[d]:sub_ptr[d + 1]]
            binv[d, :s, :s] = inv[inv_ptr[d]:inv_ptr[d + 1]].reshape(s, s)
        omega = float(kwargs.get("omega", 1.0))
        return SmootherData(kind="schwarz", iterations=iterations,
                            omega=omega,
                            subdomain_idx=stage_array(idx),
                            subdomain_inv=stage_array(
                                binv if npdt is None
                                else binv.astype(npdt, copy=False)))

    if fn_name in ("gmres", "cg", "cgne", "cgnr"):
        # Krylov-as-smoother (reference smoothing.py:481-509): a fixed
        # number of fully-traced Krylov steps.  cgne/cgnr carry A^H so the
        # normal-equation iterations are genuine on nonsymmetric/complex A.
        AT = None
        if fn_name in ("cgne", "cgnr"):
            from ..sparse import SparseELL

            AT = SparseELL.from_scipy(A_csr.conjugate().T.tocsr())
        return SmootherData(kind=f"{fn_name}_smoother",
                            iterations=max(iterations, 1), AT=AT)

    raise ValueError(f"unknown smoother {fn_name!r}")


def change_smoothers(ml, presmoother, postsmoother):
    """Attach pre/post SmootherData to every level of ``ml``
    (reference smoothing.py:24).

    Smoother arrays are host-staged; the batched upload happens at
    ``MultilevelSolver._dev()`` (one transfer call for the hierarchy).

    Examples
    --------
    >>> from pyamg_tpu.gallery import poisson
    >>> from pyamg_tpu.aggregation import smoothed_aggregation_solver
    >>> from pyamg_tpu.relaxation.smoothing import change_smoothers
    >>> A = poisson((16, 16), format='csr')
    >>> ml = smoothed_aggregation_solver(A, max_coarse=20)
    >>> _ = change_smoothers(ml, 'jacobi', ('gauss_seidel',
    ...                                     {'sweep': 'symmetric'}))
    >>> ml.levels[0].presmoother.kind
    'jacobi'
    """
    from ..util.staging import staging

    with staging():
        return _change_smoothers_impl(ml, presmoother, postsmoother)


def _change_smoothers_impl(ml, presmoother, postsmoother):
    from ..util.utils import levelize_smooth_or_improve_candidates

    n = len(ml.levels)
    dtype = getattr(ml, "_op_dtype", None)
    sym = getattr(ml, "symmetry", None)
    sym_hint = sym in ("hermitian", "symmetric")
    pres = levelize_smooth_or_improve_candidates(presmoother, n)
    posts = levelize_smooth_or_improve_candidates(postsmoother, n)
    for lvl, pre, post in zip(ml.levels[:-1], pres, posts):
        if not hasattr(lvl, "_sym_hint"):
            lvl._sym_hint = sym_hint
        fn, kw = unpack_arg(pre) if pre is not None else (None, {})
        lvl.presmoother = make_smoother_data(lvl, fn, kw, dtype=dtype)
        fn, kw = unpack_arg(post) if post is not None else (None, {})
        lvl.postsmoother = make_smoother_data(lvl, fn, kw, dtype=dtype)
    ml._cycle_cache = {}
    ml._solve_cache = {}
    ml._devh = None
    ml._smoother_config = (presmoother, postsmoother)
    return ml
