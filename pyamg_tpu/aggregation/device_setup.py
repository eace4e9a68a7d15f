"""Fully on-device SA setup for grid-structured problems.

The staged host setup (aggregation.py) is general; this module is the
device setup path the north star asks for: for a stencil-structured fine
operator, EVERY numeric setup step runs inside jit on device —

* spectral radius of D^{-1}A by power iteration (`lax.fori_loop`)
* the Jacobi smoothing factor S = I - (omega/rho) D^{-1} A by DIA arithmetic
  (same offsets as A; no sparse assembly)
* tentative prolongation weights by grid pooling of the near-nullspace
  (the K=1 specialization of fit_candidates' per-aggregate QR)
* the Galerkin product A_c = R A P by **comb-vector probing**: on a coarse
  grid the 3^d mod-3 classes of coarse nodes are far enough apart that each
  application of (R∘A∘P) to a class-indicator vector yields exactly one
  coarse-stencil entry per row — 3^d composed applies reconstruct the full
  coarse DIA operator exactly (no SpGEMM, no host)
* geometric multicolor masks from broadcasted iota

Host involvement per level: only static bookkeeping (shapes, offsets) and
the final tiny coarsest-grid factorization.

Reference roles covered on device: jacobi_prolongation_smoother
(smooth.py:67), fit_candidates (smoothed_aggregation.h:323), and the
Galerkin ``R*A*P`` (aggregation.py:429).
"""

from __future__ import annotations

import itertools
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..sparse import SparseDIA, ComposedOp, GridRepeatOp, GridPoolOp
from ..multilevel import MultilevelSolver, Level
from ..relaxation.device import SmootherData

__all__ = ["structured_sa_setup", "device_rap", "device_smoothing_factor",
           "device_power_rho"]


def _grid_offsets(grid):
    """Flat offsets of the full 3^d stencil on a row-major grid."""
    d = len(grid)
    strides = [int(np.prod(grid[k + 1:])) for k in range(d)]
    offs = []
    for deltas in itertools.product((-1, 0, 1), repeat=d):
        offs.append(sum(dd * s for dd, s in zip(deltas, strides)))
    return sorted(set(offs)), strides


@partial(jax.jit, static_argnames=("n_iter",))
def device_power_rho(A: SparseDIA, dinv, n_iter: int = 30, seed: int = 0):
    """Spectral radius of D^{-1}A by power iteration, fully on device
    (role of approximate_spectral_radius, util/linalg.py:282)."""
    n = A.shape[0]
    key = jax.random.PRNGKey(seed)
    v = jax.random.normal(key, (n,), dtype=A.dtype)

    def body(_, carry):
        v, lam = carry
        w = dinv * A.matvec(v)
        lam = jnp.linalg.norm(w)
        return (w / jnp.maximum(lam, 1e-30), lam)

    _, lam = jax.lax.fori_loop(0, n_iter, body, (v, jnp.asarray(1.0,
                                                                A.dtype)))
    return lam


def device_smoothing_factor(A: SparseDIA, omega_over_rho):
    """S = I - c D^{-1} A as a DIA operator (same offsets as A)."""
    d = A.diagonal()
    dinv = jnp.where(d != 0, 1.0 / jnp.where(d != 0, d, 1), 0.0)
    diags = -omega_over_rho * dinv[None, :] * A.diags
    if 0 in A.offsets:
        k0 = A.offsets.index(0)
        diags = diags.at[k0].add(1.0)
        return SparseDIA(diags=diags, offsets=A.offsets, shape=A.shape)
    offsets = tuple(sorted(set(A.offsets) | {0}))
    full = jnp.zeros((len(offsets), A.shape[0]), dtype=A.dtype)
    for k, off in enumerate(A.offsets):
        full = full.at[offsets.index(off)].set(diags[k])
    full = full.at[offsets.index(0)].add(1.0)
    return SparseDIA(diags=full, offsets=offsets, shape=A.shape)


def dia_transpose(S: SparseDIA) -> SparseDIA:
    """Transpose of a square DIA operator, on device: the (-off) diagonal of
    S^T at row j is the (off) diagonal of S at row j + (-off)... i.e. a
    shift of each diagonal array."""
    n, m = S.shape
    offsets = tuple(-o for o in reversed(S.offsets))
    diags = []
    for o in offsets:
        k = S.offsets.index(-o)
        src = S.diags[k]
        # T[j, j+o] = S[j+o, j]  -> value src[j + o]
        if o >= 0:
            val = jnp.concatenate([src[o:], jnp.zeros((o,), S.dtype)])
        else:
            val = jnp.concatenate([jnp.zeros((-o,), S.dtype), src[:o]])
        diags.append(val)
    return SparseDIA(diags=jnp.stack(diags), offsets=offsets, shape=(m, n))


def _class_arrays(cgrid):
    """Static per-node coordinate arrays of the coarse grid."""
    coords = np.unravel_index(np.arange(int(np.prod(cgrid))), cgrid)
    return [c.astype(np.int32) for c in coords]


def device_rap(P, R, A: SparseDIA, cgrid):
    """A_c = R A P on device by 3^d comb-vector probes (exact for coarse
    stencils within the 3^d neighborhood)."""
    d = len(cgrid)
    nc = int(np.prod(cgrid))
    offsets_c, strides_c = _grid_offsets(cgrid)
    coords = _class_arrays(cgrid)          # host static int arrays

    # apply R A P to one comb per mod-3 class
    ys = []
    classes = list(itertools.product(range(3), repeat=d))
    for cls in classes:
        comb_np = np.ones((nc,), dtype=bool)
        for k in range(d):
            comb_np &= (coords[k] % 3) == cls[k]
        comb = jnp.asarray(comb_np.astype(np.float32)).astype(A.dtype)
        ys.append(R.matvec(A.matvec(P.matvec(comb))))
    Y = jnp.stack(ys)                       # (3^d, nc)

    class_index = {cls: i for i, cls in enumerate(classes)}

    # for each coarse offset (deltas), the probing class at node i is
    # ((coord_k + delta_k) mod 3)_k ; gather from Y accordingly
    diags = []
    for deltas in itertools.product((-1, 0, 1), repeat=d):
        off = sum(dd * s for dd, s in zip(deltas, strides_c))
        # selector: which class row of Y feeds this diagonal at each node
        sel = np.zeros(nc, dtype=np.int32)
        mult = 1
        for k in range(d - 1, -1, -1):
            sel += ((coords[k] + deltas[k]) % 3) * mult
            mult *= 3
        # class tuple order must match `classes` (itertools.product order:
        # first coordinate most significant)
        # itertools.product(range(3), repeat=d) enumerates with LAST factor
        # fastest, matching the mixed-radix sel computed above.
        # in-grid validity of the neighbor
        valid = np.ones(nc, dtype=bool)
        for k in range(d):
            valid &= (coords[k] + deltas[k] >= 0) & \
                     (coords[k] + deltas[k] < cgrid[k])
        vals = jnp.take_along_axis(Y, jnp.asarray(sel)[None, :],
                                   axis=0)[0]
        vals = vals * jnp.asarray(valid.astype(np.float32)).astype(A.dtype)
        diags.append((off, vals))

    diags.sort(key=lambda t: t[0])
    offsets = tuple(t[0] for t in diags)
    return SparseDIA(diags=jnp.stack([t[1] for t in diags]),
                     offsets=offsets, shape=(nc, nc))


def _geometric_masks(grid, two_colors, dtype):
    """(ncolors, n) float masks from broadcasted iota (device)."""
    d = len(grid)
    n = int(np.prod(grid))
    coords = _class_arrays(grid)
    if two_colors:
        colors = np.zeros(n, dtype=np.int64)
        for c in coords:
            colors += c
        colors %= 2
        nc = 2
    else:
        colors = np.zeros(n, dtype=np.int64)
        for c in coords:
            colors = colors * 2 + (c % 2)
        nc = 2 ** d
    masks = np.zeros((nc, n), dtype=np.float32)
    masks[colors, np.arange(n)] = 1.0
    return jnp.asarray(masks).astype(dtype)


def structured_sa_setup(A, grid, block=None, omega=4.0 / 3.0, degree=1,
                        max_levels=10, max_coarse=200,
                        presmoother_sweep="symmetric",
                        coarse_solver="pinv", dtype=jnp.float32,
                        mesh=None, mesh_axis=None):
    """Build an SA hierarchy for a stencil matrix with the numeric setup on
    device.  ``A`` may be scipy CSR or a SparseDIA.

    Returns a MultilevelSolver whose compiled cycle is identical in form to
    the host-staged one.

    ``mesh``: a ``jax.sharding.Mesh`` distributes the CONSTRUCTION itself
    (SURVEY §7 step 8 "distributed RAP and setup"): the fine operator's
    diagonals and the candidate are row-sharded over the mesh, every level
    build (power iteration, smoothing factor, tentative pooling, comb-probe
    RAP) is one SPMD program with XLA-inserted collectives, and each coarse
    operator comes out of the jit already sharded — no single-host setup
    stage.  Numerically identical to the single-device build up to
    reduction reassociation in the norms (~1 ulp-scale)."""
    import scipy.sparse as sp

    dtype = jnp.dtype(dtype)
    if not isinstance(A, SparseDIA):
        A_csr0 = sp.csr_matrix(A)
        # cast on host before the H2D transfer (an f64 transfer + device
        # cast moves 2x the bytes)
        A_dev = SparseDIA.from_scipy(A_csr0,
                                     dtype=np.dtype(str(dtype)))
    else:
        A_dev = A.astype(dtype)
        A_csr0 = A.to_scipy()

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        mesh_axis = mesh_axis or mesh.axis_names[0]
        _nd = mesh.shape[mesh_axis]

        def _place(A_d, B_v):
            # row-shard while the level divides the mesh; replicate the
            # small ragged coarse levels (their work is negligible)
            if A_d.shape[0] % _nd == 0:
                sh_diag = NamedSharding(mesh, _P(None, mesh_axis))
                sh_vec = NamedSharding(mesh, _P(mesh_axis))
            else:
                sh_diag = NamedSharding(mesh, _P())
                sh_vec = NamedSharding(mesh, _P())
            A_d = SparseDIA(diags=jax.device_put(A_d.diags, sh_diag),
                            offsets=A_d.offsets, shape=A_d.shape)
            return A_d, (None if B_v is None
                         else jax.device_put(B_v, sh_vec))
    else:
        def _place(A_d, B_v):
            return A_d, B_v

    grid = tuple(int(g) for g in grid)
    if int(np.prod(grid)) != A_dev.shape[0]:
        raise ValueError(f"grid {grid} has {int(np.prod(grid))} nodes but "
                         f"A is {A_dev.shape[0]}x{A_dev.shape[1]}")
    d = len(grid)
    if block is None:
        block = (3,) * d

    # Exactness guard for the comb-probe RAP: the coarse stencil must fit
    # the 3^d coarse neighborhood.  P = S^degree T spreads each coarse
    # basis function `degree` fine cells beyond its block, so the coarse
    # row support stays within one coarse cell iff 2*degree < min(block);
    # and A itself must live on the fine 3^d stencil.  Violations would
    # silently produce a wrong Galerkin operator, so they are errors.
    if 2 * degree >= min(block):
        raise ValueError(
            f"structured_sa_setup: comb-probe RAP is exact only when "
            f"2*degree < min(block); got degree={degree}, block={block}. "
            f"Use a larger block or the host-staged "
            f"smoothed_aggregation_solver for this configuration.")
    strides0 = [int(np.prod(grid[k + 1:])) for k in range(d)]
    valid_offs = {sum(dd * s for dd, s in zip(deltas, strides0))
                  for deltas in itertools.product((-1, 0, 1), repeat=d)}
    if not set(A_dev.offsets) <= valid_offs:
        bad = sorted(set(A_dev.offsets) - valid_offs)
        raise ValueError(
            f"structured_sa_setup: A has offsets {bad} outside the 3^{d} "
            f"stencil of grid {grid}; the comb-probe RAP would be inexact. "
            f"Use the host-staged smoothed_aggregation_solver instead.")

    @partial(jax.jit, static_argnames=("cur_grid", "blk", "deg"))
    def build_level(A_l, B_l, cur_grid, blk, deg):
        """One whole level of device setup as a single compiled program."""
        n = int(np.prod(cur_grid))
        dvec = A_l.diagonal()
        dinv = jnp.where(dvec != 0, 1.0 / jnp.where(dvec != 0, dvec, 1), 0.0)
        rho = device_power_rho(A_l, dinv)
        S = device_smoothing_factor(A_l, omega / rho)
        ST = dia_transpose(S)

        cgrid = tuple(-(-g // b) for g, b in zip(cur_grid, blk))
        nc = int(np.prod(cgrid))

        pool1 = GridPoolOp(wmap=jnp.ones((n,), dtype), fine_grid=cur_grid,
                           block=blk, shape=(nc, n))
        rep1 = GridRepeatOp(wmap=jnp.ones((n,), dtype), fine_grid=cur_grid,
                            block=blk, shape=(n, nc))
        agg_nrm2 = pool1.matvec(jnp.abs(B_l) ** 2)
        agg_nrm = jnp.sqrt(jnp.maximum(agg_nrm2, 1e-30))
        wmap = B_l * rep1.matvec(1.0 / agg_nrm)
        B_c = agg_nrm

        T = GridRepeatOp(wmap=wmap, fine_grid=cur_grid, block=blk,
                         shape=(n, nc))
        Tt = GridPoolOp(wmap=wmap, fine_grid=cur_grid, block=blk,
                        shape=(nc, n))
        if deg > 0:
            P = ComposedOp(ops=tuple([S] * deg + [T]), shape=(n, nc))
            R = ComposedOp(ops=tuple([Tt] + [ST] * deg), shape=(nc, n))
        else:
            P, R = T, Tt

        A_c = device_rap(P, R, A_l, cgrid)
        return P, R, A_c, B_c, dinv

    levels = []
    B = jnp.ones((A_dev.shape[0],), dtype=dtype)
    A_dev, B = _place(A_dev, B)
    cur_grid = grid

    while len(levels) < max_levels - 1 and A_dev.shape[0] > max_coarse:
        lvl = Level()
        lvl.A = A_dev
        lvl.grid = cur_grid

        P, R, A_c, B_c, dinv = build_level(A_dev, B, cur_grid, block,
                                           degree)
        # keep coarse operands on the mesh in the canonical row-sharded
        # placement (XLA's propagated output sharding may differ)
        A_c, B_c = _place(A_c, B_c)
        cgrid = tuple(-(-g // b) for g, b in zip(cur_grid, block))
        lvl.P = P
        lvl.R = R

        # smoother data (device): multicolor GS with geometric colors
        strides = [int(np.prod(cur_grid[k + 1:])) for k in range(d)]
        cross = {0} | {s for s in strides} | {-s for s in strides}
        two = set(A_dev.offsets) <= cross    # cross stencil -> checkerboard
        masks = _geometric_masks(cur_grid, two, dtype)
        sm = SmootherData(kind="gauss_seidel", iterations=1,
                          sweep=presmoother_sweep, dinv=dinv,
                          color_masks=masks)
        lvl.presmoother = sm
        lvl.postsmoother = sm

        levels.append(lvl)
        A_dev = A_c
        B = B_c
        cur_grid = cgrid

    # coarsest level
    last = Level()
    last.A = A_dev
    last.grid = cur_grid
    levels.append(last)

    # host twin only for the (small) coarsest level — it feeds the dense
    # coarse factorization; finer twins would cost large D2H transfers and
    # are reconstructable on demand via .A.to_scipy()
    levels[-1].A_csr = levels[-1].A.to_scipy()

    ml = MultilevelSolver(levels, coarse_solver=coarse_solver)
    ml._smoother_config = (("gauss_seidel", {"sweep": presmoother_sweep}),) * 2
    ml._mesh = mesh
    return ml
