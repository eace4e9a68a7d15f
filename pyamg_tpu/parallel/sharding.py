"""Multi-chip execution: row-sharded hierarchies over a device mesh.

The reference is a serial library (SURVEY.md §2.3); this module is the
designed-fresh distributed layer (§7.5): every level's operators and vectors
are 1-D row-sharded over a ``jax.sharding.Mesh``; the padded-ELL SpMV's
``x[cols]`` gather makes XLA insert the halo/all-gather collectives
automatically, reductions become ``psum``-style collectives inside compiled
Krylov loops, and coarse levels below a size threshold are replicated (the
classic AMG agglomeration trick — here the dense coarse solve is replicated).

Examples
--------
>>> import numpy as np, pyamg_tpu
>>> from pyamg_tpu.gallery import poisson
>>> from pyamg_tpu.parallel import make_mesh, shard_solver
>>> mesh = make_mesh(1)                       # 1-device mesh (any backend)
>>> int(mesh.devices.size)
1
>>> A = poisson((12, 12), format='csr')
>>> sol = shard_solver(pyamg_tpu.smoothed_aggregation_solver(A), mesh=mesh)
>>> b = np.ones(A.shape[0])
>>> x = sol.solve(b, tol=1e-8, maxiter=100, accel='cg')
>>> r = np.linalg.norm(b - A @ np.asarray(x, dtype=float))
>>> bool(r < 1e-6 * np.linalg.norm(b))
True
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sparse import SparseELL
from ..relaxation.device import SmootherData
from ..multilevel import MultilevelSolver, Level

__all__ = ["make_mesh", "shard_solver", "ShardedSolver", "pad_to",
           "shard_structured_solver", "StructuredShardedSolver"]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "rows"):
    """1-D device mesh over the first ``n_devices`` available devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis_name,))


def pad_to(n: int, k: int) -> int:
    return -(-n // k) * k


def _line_pad_quantum(sm) -> int:
    """Row-count quantum a line smoother needs for padding.

    Line smoothers reshape vectors to the level's grid, so padded rows must
    arrive as WHOLE leading-axis slabs (row-major: appending axis-0 slabs
    is exactly appending rows at the end of the flat vector).  One slab is
    ``prod(grid[1:]) * q`` rows (q = dofs per grid node for node-blocked
    levels)."""
    if sm is None or sm.line_tri is None or not sm.grid:
        return 1
    # blocked line_tri is (3, q, q, nlines, L) component layout
    q = sm.line_tri.shape[1] if sm.line_tri.ndim == 5 else 1
    return int(np.prod(sm.grid[1:])) * q


def _pad_ell(E: SparseELL, n_rows_pad: int, n_cols_pad: int) -> SparseELL:
    """Pad an ELL operator with structurally-empty rows/columns.

    Padding rows have zero data and in-bounds column index 0, so SpMV
    results are zero there and gathers stay valid.
    """
    n, m = E.shape
    w = E.width
    data = np.zeros((n_rows_pad, w), dtype=E.dtype)
    cols = np.zeros((n_rows_pad, w), dtype=np.int32)
    nnz = np.zeros((n_rows_pad,), dtype=np.int32)
    data[:n] = np.asarray(E.data)
    cols[:n] = np.asarray(E.cols)
    nnz[:n] = np.asarray(E.row_nnz)
    return SparseELL(data=jnp.asarray(data), cols=jnp.asarray(cols),
                     row_nnz=jnp.asarray(nnz),
                     shape=(n_rows_pad, n_cols_pad))


def _place_ell(E: SparseELL, mesh, axis) -> SparseELL:
    sh2 = NamedSharding(mesh, P(axis, None))
    sh1 = NamedSharding(mesh, P(axis))
    return SparseELL(
        data=jax.device_put(E.data, sh2),
        cols=jax.device_put(E.cols, sh2),
        row_nnz=jax.device_put(E.row_nnz, sh1),
        shape=E.shape)


def _pad_smoother(sm: SmootherData, n_pad: int, mesh, axis) -> SmootherData:
    """Pad/re-place every piece of smoother state for the sharded cycle.

    All smoother kinds are carried faithfully; configurations that cannot
    survive row padding (line smoothers on a level whose size changed) fail
    loudly instead of silently degrading.
    """
    if sm is None or sm.kind == "none":
        return sm
    nd = mesh.devices.size
    sh1 = NamedSharding(mesh, P(axis))
    shm = NamedSharding(mesh, P(None, axis))
    repl = NamedSharding(mesh, P())
    dinv = sm.dinv
    if dinv is not None:
        d = np.zeros(n_pad, dtype=dinv.dtype)
        d[:dinv.shape[0]] = np.asarray(dinv)
        dinv = jax.device_put(jnp.asarray(d), sh1)
    masks = sm.color_masks
    if masks is not None:
        m = np.zeros((masks.shape[0], n_pad), dtype=masks.dtype)
        m[:, :masks.shape[1]] = np.asarray(masks)
        masks = jax.device_put(jnp.asarray(m), shm)
    block_dinv = sm.block_dinv
    if block_dinv is not None:
        bs = block_dinv.shape[-1]
        nb_pad = n_pad // bs
        bd = np.zeros((nb_pad, bs, bs), dtype=block_dinv.dtype)
        bd[:block_dinv.shape[0]] = np.asarray(block_dinv)
        block_dinv = jax.device_put(
            jnp.asarray(bd), NamedSharding(mesh, P(axis, None, None)))
    AT = sm.AT
    dinv_ne = sm.dinv_ne
    if AT is not None:
        AT = _place_ell(_pad_ell(AT, n_pad, n_pad), mesh, axis)
    if dinv_ne is not None:
        d = np.zeros(n_pad, dtype=dinv_ne.dtype)
        d[:dinv_ne.shape[0]] = np.asarray(dinv_ne)
        dinv_ne = jax.device_put(jnp.asarray(d), sh1)
    subdomain_idx, subdomain_inv = sm.subdomain_idx, sm.subdomain_inv
    if subdomain_idx is not None:
        # indices address original rows (< n <= n_pad): still valid; shard
        # the batched dense solves over the subdomain axis when possible
        n_dom = subdomain_idx.shape[0]
        sdom = (NamedSharding(mesh, P(axis, None)) if n_dom % nd == 0
                else repl)
        sinv = (NamedSharding(mesh, P(axis, None, None)) if n_dom % nd == 0
                else repl)
        subdomain_idx = jax.device_put(subdomain_idx, sdom)
        subdomain_inv = jax.device_put(subdomain_inv, sinv)
    line_tri = sm.line_tri
    grid = sm.grid
    if line_tri is not None:
        blocked = line_tri.ndim == 5      # (3, q, q, nlines, L) layout
        q = line_tri.shape[1] if blocked else 1
        slab = int(np.prod(grid[1:])) * q
        n_grid = int(np.prod(grid)) * q
        if n_grid != n_pad:
            # Pad by whole axis-0 slabs (row-major: appended slabs ARE the
            # trailing pad rows of the flat vector).  Padding rows carry a
            # structurally-zero A row and zero RHS, so their residual is
            # identically zero throughout the iteration; the tridiagonal
            # systems are extended with DECOUPLED identity rows/lines, so
            # the correction there is exactly zero and the original lines'
            # solves are bit-unchanged (eliminations across the zero
            # couplings contribute exact zeros in the cyclic reduction).
            if n_pad % slab:
                raise ValueError(
                    f"padded size {n_pad} is not a whole number of grid "
                    f"slabs ({slab} rows) for the {sm.kind!r} line smoother")
            g0_new = n_pad // slab
            tri = np.asarray(line_tri)
            laxis = sm.line_axis % len(grid)
            # axis index of L (the along-line axis) and of the lines axis
            # in the stored layout: scalar (3, nlines, L); blocked
            # component layout (3, q, q, nlines, L)
            ax_L = 4 if blocked else 2
            ax_lines = 3 if blocked else 1
            if laxis == 0:
                # lines RUN along the padded axis: each system gains a
                # decoupled identity tail
                L = tri.shape[ax_L]
                shp = list(tri.shape)
                shp[ax_L] = g0_new
                new = np.zeros(shp, dtype=tri.dtype)
                new[..., :L] = tri
                if blocked:
                    for i in range(q):
                        new[1, i, i, :, L:] = 1.0
                    new[2, :, :, :, L - 1:] = 0.0  # cut coupling into tail
                else:
                    new[1, :, L:] = 1.0
                    new[2, :, L - 1:] = 0.0
            else:
                # padding adds whole NEW lines, appended after the original
                # ones in the flattened line order
                nlines = tri.shape[ax_lines]
                nlines_new = (g0_new * int(np.prod(grid[1:]))
                              // int(grid[laxis]))
                shp = list(tri.shape)
                shp[ax_lines] = nlines_new
                new = np.zeros(shp, dtype=tri.dtype)
                if blocked:
                    new[:, :, :, :nlines] = tri
                    for i in range(q):
                        new[1, i, i, nlines:] = 1.0
                else:
                    new[:, :nlines] = tri
                    new[1, nlines:] = 1.0
            line_tri = jnp.asarray(new)
            grid = (g0_new,) + tuple(grid[1:])
        nlines = line_tri.shape[3 if blocked else 1]
        if nlines % nd == 0:
            stri = NamedSharding(
                mesh, P(None, None, None, axis, None) if blocked
                else P(None, axis, None))
        else:
            stri = repl
        line_tri = jax.device_put(line_tri, stri)
    color_rows, color_cols, color_data = (sm.color_rows, sm.color_cols,
                                          sm.color_data)
    if color_rows is not None:
        # gather-form GS state: row ids address original rows (< n_pad) and
        # the x-gather is global; replicate the (C, R, W) arrays (they live
        # on gather-bound unstructured levels, which are small)
        color_rows = jax.device_put(color_rows, repl)
        color_cols = jax.device_put(color_cols, repl)
        color_data = jax.device_put(color_data, repl)
    return SmootherData(kind=sm.kind, iterations=sm.iterations,
                        sweep=sm.sweep, omega=sm.omega, dinv=dinv,
                        color_masks=masks, coefficients=sm.coefficients,
                        block_dinv=block_dinv, blocksize=sm.blocksize,
                        AT=AT, dinv_ne=dinv_ne,
                        subdomain_idx=subdomain_idx,
                        subdomain_inv=subdomain_inv,
                        line_tri=line_tri, grid=grid,
                        line_axis=sm.line_axis,
                        color_rows=color_rows, color_cols=color_cols,
                        color_data=color_data)


class ShardedSolver:
    """A MultilevelSolver whose levels are row-sharded over a mesh.

    ``solve`` pads the RHS, runs the same compiled cycle/Krylov machinery
    (XLA partitions it over the mesh), and un-pads the result.
    """

    def __init__(self, ml: MultilevelSolver, mesh, axis_name: str = "rows",
                 halo: str = "pack"):
        self.mesh = mesh
        if axis_name not in mesh.axis_names and len(mesh.axis_names) == 1:
            # adopt the caller's single mesh axis whatever they named it
            axis_name = mesh.axis_names[0]
        self.axis = axis_name
        if halo not in ("pack", "gather"):
            raise ValueError("halo must be 'pack' or 'gather'")
        self.halo = halo
        nd = mesh.devices.size
        self.n_orig = ml.levels[0].A_csr.shape[0]

        # padded sizes per level (multiple of device count; blocksize-safe;
        # line smoothers additionally require whole grid slabs — see
        # _line_pad_quantum)
        import math

        sizes = []
        for lvl in ml.levels:
            bs = max(getattr(lvl, "blocksize", 1), 1)
            quantum = nd * bs
            for sm in (getattr(lvl, "presmoother", None),
                       getattr(lvl, "postsmoother", None)):
                quantum = math.lcm(quantum, _line_pad_quantum(sm))
            sizes.append(pad_to(lvl.A_csr.shape[0], quantum))
        self.sizes = sizes

        def place(E_pad):
            """Halo-compacted when it pays, full-gather ELL otherwise.

            ``build_halo_ell`` reads exactly the values the gather SpMV
            reads (ulp-level parity) and replaces the full-vector
            all-gather with one small pack exchange; it declines (returns
            None) on tiny/dense-halo levels where the full gather is no
            worse."""
            if halo == "pack":
                from .halo import build_halo_ell
                Hd = build_halo_ell(E_pad, mesh, axis_name)
                if Hd is not None:
                    return Hd
            return _place_ell(E_pad, mesh, axis_name)

        levels = []
        for i, lvl in enumerate(ml.levels):
            new = Level()
            new.A_csr = lvl.A_csr
            n_pad = sizes[i]
            # the sharded path uses the gather-ELL representation (built
            # fresh from the host CSR twins, independent of the single-chip
            # format choice)
            A_ell = SparseELL.from_scipy(lvl.A_csr)
            new.A = place(_pad_ell(A_ell, n_pad, n_pad))
            if hasattr(lvl, "P_csr") and i + 1 < len(ml.levels):
                nc_pad = sizes[i + 1]
                new.P = place(
                    _pad_ell(SparseELL.from_scipy(lvl.P_csr), n_pad, nc_pad))
                new.R = place(
                    _pad_ell(SparseELL.from_scipy(lvl.R_csr), nc_pad, n_pad))
            new.presmoother = _pad_smoother(lvl.presmoother, n_pad, mesh,
                                            axis_name)
            new.postsmoother = _pad_smoother(lvl.postsmoother, n_pad, mesh,
                                             axis_name)
            levels.append(new)

        self._finalize(levels, ml.coarse_solver_spec)

    def _finalize(self, levels, coarse_spec):
        self.inner = MultilevelSolver(levels, coarse_solver=coarse_spec)
        # coarse dense inverse: padded + replicated
        A_c = levels[-1].A_csr
        nc, nc_pad = A_c.shape[0], self.sizes[-1]
        Ainv = np.zeros((nc_pad, nc_pad), dtype=A_c.dtype)
        Ainv[:nc, :nc] = np.linalg.pinv(A_c.toarray())
        Ainv_dev = jax.device_put(jnp.asarray(Ainv),
                                  NamedSharding(self.mesh, P(None, None)))
        self.inner._coarse_mat_override = Ainv_dev

    @classmethod
    def from_sharded_levels(cls, levels, sizes, mesh, axis_name, n_orig,
                            coarse_spec="pinv", halo: str = "pack"):
        """Assemble from levels whose operators are ALREADY padded, placed
        and sharded (the distributed-setup path, parallel/setup.py).

        With ``halo='pack'`` (default) the solve-path operators (A/P/R of
        every level) are re-expressed as :class:`~.halo.HaloELL` where the
        static pack exchange beats the full-vector gather on wire bytes —
        the setup-side pattern operators are untouched."""
        if halo == "pack":
            from .halo import build_halo_ell
            from ..sparse import SparseELL

            for lvl in levels:
                for attr in ("A", "P", "R"):
                    E = getattr(lvl, attr, None)
                    if isinstance(E, SparseELL):
                        Hd = build_halo_ell(E, mesh, axis_name)
                        if Hd is not None:
                            setattr(lvl, attr, Hd)
        self = object.__new__(cls)
        self.mesh, self.axis = mesh, axis_name
        self.sizes, self.n_orig = list(sizes), n_orig
        self._finalize(levels, coarse_spec)
        return self

    @property
    def levels(self):
        return self.inner.levels

    def cycle_fn(self, cycle="V"):
        return self.inner.cycle_fn(cycle)

    def _pad_vec(self, b):
        n_pad = self.sizes[0]
        out = np.zeros(n_pad, dtype=np.asarray(b).dtype)
        out[:self.n_orig] = np.asarray(b).ravel()
        sh = NamedSharding(self.mesh, P(self.axis))
        return jax.device_put(jnp.asarray(out), sh)

    def solve(self, b, **kw):
        b_pad = self._pad_vec(b)
        with self.mesh:
            x = self.inner.solve(b_pad, **kw)
        return np.asarray(x)[:self.n_orig]

    def __repr__(self):
        return (f"ShardedSolver(devices={self.mesh.devices.size}, "
                f"levels={len(self.levels)})\n" + repr(self.inner))


def shard_solver(ml: MultilevelSolver, mesh=None, n_devices=None,
                 axis_name: str = "rows", halo: str = "pack") -> ShardedSolver:
    """Shard an existing hierarchy row-wise over a device mesh."""
    if mesh is None:
        mesh = make_mesh(n_devices, axis_name)
    return ShardedSolver(ml, mesh, axis_name, halo=halo)


class StructuredShardedSolver:
    """Row-sharding for fully-structured (DIA + grid-op) hierarchies.

    Instead of rebuilding gather-ELL operators, the existing device pytree
    is re-placed with ``NamedSharding``s (vectors/diagonals split over rows;
    small coarse operators replicated).  XLA turns the DIA shifts into
    halo ``collective_permute``s and partitions the grid
    reshape/repeat/pool transfers.  Requires the leading grid dimension of
    every sharded level to be divisible by the device count (levels that
    are not divisible are replicated — they are small).
    """

    def __init__(self, ml: MultilevelSolver, mesh=None, n_devices=None,
                 axis_name: str = "rows", min_shard_rows: int = 4096):
        if mesh is None:
            mesh = make_mesh(n_devices, axis_name)
        self.mesh = mesh
        if axis_name not in mesh.axis_names and len(mesh.axis_names) == 1:
            # adopt the caller's single mesh axis whatever they named it
            axis_name = mesh.axis_names[0]
        self.axis = axis_name
        self.ml = ml
        nd = mesh.devices.size

        hier = ml._dev()
        repl = NamedSharding(mesh, P())

        def spec_for(leaf):
            shape = getattr(leaf, "shape", None)
            if shape is None:
                return repl
            # shard the axis whose extent is a multiple of the device count
            if len(shape) == 1 and shape[0] % nd == 0 \
                    and shape[0] >= min_shard_rows:
                return NamedSharding(mesh, P(axis_name))
            if len(shape) == 2 and shape[1] % nd == 0 \
                    and shape[1] >= min_shard_rows:
                return NamedSharding(mesh, P(None, axis_name))
            if len(shape) == 3 and shape[0] % nd == 0 \
                    and shape[0] >= min_shard_rows:
                return NamedSharding(mesh, P(axis_name, None, None))
            return repl

        self._hier = jax.tree_util.tree_map(
            lambda leaf: jax.device_put(leaf, spec_for(leaf)), hier)
        self.n = ml.levels[0].A.shape[0]
        if self.n % nd:
            raise ValueError(
                f"fine-level size {self.n} not divisible by {nd} devices")

    @property
    def levels(self):
        return self.ml.levels

    def solve(self, b, tol=1e-8, maxiter=100, cycle="V", accel="cg",
              residuals=None):
        if accel is not None and accel not in ("cg", "bicgstab",
                                               "gmres", "fgmres"):
            raise ValueError("StructuredShardedSolver supports accel in "
                             "('cg', 'bicgstab', 'gmres', 'fgmres', None)")
        b_d = jax.device_put(
            jnp.asarray(np.ravel(np.asarray(b)),
                        dtype=self.ml.levels[0].A.dtype),
            NamedSharding(self.mesh, P(self.axis)))
        normb = jnp.linalg.norm(b_d)
        tol_t = tol * jnp.where(normb == 0, 1.0, normb)
        if accel is None:
            # the standalone chunked programs take the hierarchy pytree as
            # an argument, so they shard exactly like the accel cores
            key = ("standalone", str(cycle).upper(), int(maxiter))
            self.ml._get_cached_standalone(cycle, int(maxiter))
            init, chunk = self.ml._solve_cache[key]
            rdt = jnp.real(jnp.zeros(0, b_d.dtype)).dtype
            tol_r = jnp.asarray(tol_t, dtype=rdt)
            carry = init(self._hier, jnp.zeros_like(b_d), b_d)
            it = 0
            while it < maxiter:
                carry, stat = chunk(self._hier, b_d, carry, tol_r,
                                    min(it + 25, maxiter))
                stat = np.asarray(stat)
                res, it_new = float(stat[0]), int(stat[1])
                if res <= float(tol_r) or it_new == it:
                    it = it_new
                    break
                it = it_new
            x, _it, res_buf = carry
        else:
            run = self.ml._raw_accel(accel, cycle, int(maxiter))
            x, it, res_buf = run(self._hier, jnp.zeros_like(b_d), b_d, tol_t)
        it = int(it)
        if residuals is not None:
            residuals.extend([float(v) for v in np.asarray(res_buf)[:it + 1]])
        return np.asarray(x)


def shard_structured_solver(ml, mesh=None, n_devices=None,
                            axis_name: str = "rows",
                            min_shard_rows: int = 4096):
    """Shard a structured (DIA/grid-op) hierarchy by re-placing its device
    pytree with NamedShardings."""
    return StructuredShardedSolver(ml, mesh=mesh, n_devices=n_devices,
                                   axis_name=axis_name,
                                   min_shard_rows=min_shard_rows)
