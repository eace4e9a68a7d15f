"""Halo-compacted ELL operators for row-sharded hierarchies.

The plain sharded gather-ELL SpMV (``x[cols]`` with ``x`` row-sharded)
makes XLA all-gather the ENTIRE vector to every device before the gather —
the collective census of ``benchmarks/suite.py --sharded`` counts megabytes
on the wire per classical solve program where the analytic halo is tens of
kilobytes.  This module closes that gap: each shard statically
knows which out-of-shard entries its rows touch, packs exactly those into
a fixed-width buffer, and one small ``all_gather`` of the packs replaces
the full-vector broadcast.

Reference parity: the reference is serial (SURVEY.md §2.3) — this is the
distributed-SpMV design a parallel AMG needs (the classic "communicate the
halo, not the vector" pattern of distributed sparse solvers), expressed
as a ``shard_map`` over the mesh with one tiled ``lax.all_gather``
collective between the devices.

Value contract: the remapped gather reads EXACTLY the values the global
gather read (pinned in tests/test_parallel.py), so the SpMV differs from
the gather-ELL form only by compiler-level reassociation/FMA rounding
(measured: <=1 ulp per row on the CPU backend — XLA schedules the two
programs differently even though the arithmetic is the same).

Examples
--------
>>> import numpy as np, jax
>>> from pyamg_tpu.gallery import poisson
>>> from pyamg_tpu.sparse import SparseELL
>>> from pyamg_tpu.parallel import make_mesh
>>> from pyamg_tpu.parallel.halo import build_halo_ell
>>> mesh = make_mesh(1)
>>> A = poisson((8, 8), format='csr')
>>> E = SparseELL.from_scipy(A)
>>> H = build_halo_ell(E, mesh, mesh.axis_names[0], force=True)
>>> x = np.arange(A.shape[0], dtype=float)
>>> bool(np.array_equal(np.asarray(H.matvec(x)), A @ x))
True
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ["HaloELL", "build_halo_ell"]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class HaloELL:
    """Row-sharded padded-ELL operator with static halo exchange.

    ``cols`` holds LOCAL indices into ``concat([x_local, halo])`` where
    ``halo`` is the tiled all-gather of every shard's packed boundary
    entries (``pack_idx`` rows, one per shard).  ``matvec`` runs as one
    ``shard_map``: a local pack gather (H entries), one small
    ``all_gather`` (nd*H values on the wire instead of the whole vector),
    then the ordinary ELL multiply + row-sum.
    """

    data: jnp.ndarray          # (n_rows, w), P(axis, None)
    cols: jnp.ndarray          # (n_rows, w) int32 remapped, P(axis, None)
    pack_idx: jnp.ndarray      # (nd, H) int32 local x indices, P(axis, None)
    row_nnz: jnp.ndarray       # (n_rows,) int32, P(axis)
    shape: Tuple[int, int]
    mesh: object
    axis: str

    def tree_flatten(self):
        return ((self.data, self.cols, self.pack_idx, self.row_nnz),
                (self.shape, self.mesh, self.axis))

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, cols, pack_idx, row_nnz = children
        shape, mesh, axis = aux
        return cls(data=data, cols=cols, pack_idx=pack_idx,
                   row_nnz=row_nnz, shape=shape, mesh=mesh, axis=axis)

    # -- properties mirrored from SparseELL (cycle-facing surface) --------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def halo_width(self) -> int:
        return self.pack_idx.shape[1]

    def astype(self, dtype) -> "HaloELL":
        return HaloELL(self.data.astype(dtype), self.cols, self.pack_idx,
                       self.row_nnz, self.shape, self.mesh, self.axis)

    def global_cols(self) -> np.ndarray:
        """Host reconstruction of the ORIGINAL global column indices from
        the local+halo remap (inverse of the build_halo_ell remap)."""
        cols = np.asarray(self.cols).astype(np.int64)
        nd = int(self.mesh.devices.size)
        n_pad, m_pad = self.shape
        nl, ml = n_pad // nd, m_pad // nd
        H = self.halo_width
        pidx = np.asarray(self.pack_idx).astype(np.int64)
        rs = (np.arange(n_pad) // nl)[:, None]
        local = cols < ml
        out = np.where(local, cols + rs * ml, 0)
        h = cols - ml
        s, pos = h // H, h % H
        out = np.where(local, out, pidx[np.clip(s, 0, nd - 1),
                                        np.clip(pos, 0, H - 1)]
                       + np.clip(s, 0, nd - 1) * ml)
        return out.astype(np.int32)

    def to_scipy(self):
        import scipy.sparse as sp

        n, m = self.shape
        data = np.asarray(self.data)
        cols = self.global_cols()
        nnz = np.asarray(self.row_nnz)
        w = self.width
        valid = np.arange(w)[None, :] < nnz[:, None]
        rows = np.repeat(np.arange(n), w).reshape(n, w)
        return sp.coo_matrix((data[valid], (rows[valid], cols[valid])),
                             shape=(n, m)).tocsr()

    # -- compute ----------------------------------------------------------
    def _specs(self, vec_spec):
        ax = self.axis
        return ((P(ax, None), P(ax, None), P(ax, None), vec_spec),)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        ax = self.axis

        @partial(shard_map, mesh=self.mesh,
                 in_specs=(P(ax, None), P(ax, None), P(ax, None), P(ax)),
                 out_specs=P(ax))
        def run(data, cols, pidx, xl):
            pack = xl[pidx[0]]                              # (H,)
            halo = jax.lax.all_gather(pack, ax, tiled=True)  # (nd*H,)
            xx = jnp.concatenate([xl, halo])
            return jnp.sum(data * xx[cols], axis=1)

        return run(self.data, self.cols, self.pack_idx, x)

    def matmat(self, X: jnp.ndarray) -> jnp.ndarray:
        ax = self.axis

        @partial(shard_map, mesh=self.mesh,
                 in_specs=(P(ax, None), P(ax, None), P(ax, None),
                           P(ax, None)),
                 out_specs=P(ax, None))
        def run(data, cols, pidx, Xl):
            pack = Xl[pidx[0]]                              # (H, k)
            halo = jax.lax.all_gather(pack, ax, tiled=True)  # (nd*H, k)
            XX = jnp.concatenate([Xl, halo], axis=0)
            return jnp.einsum("nw,nwk->nk", data, XX[cols],
                              precision=jax.lax.Precision.HIGHEST)

        return run(self.data, self.cols, self.pack_idx, X)

    def __matmul__(self, x):
        x = jnp.asarray(x)
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    def __repr__(self):
        return (f"HaloELL(shape={self.shape}, width={self.width}, "
                f"halo={self.halo_width}, dtype={self.dtype})")


def build_halo_ell(E, mesh, axis, n_cols: int | None = None,
                   max_halo_frac: float = 0.9, force: bool = False):
    """Build a :class:`HaloELL` from an already-padded :class:`SparseELL`.

    ``E`` must be padded so its row count AND ``n_cols`` (the x-vector
    length, default square) are multiples of the mesh size.  Returns
    ``None`` when the pack exchange would NOT beat the full gather on wire
    bytes — per device the tiled pack all-gather receives ``(nd-1)*H``
    values vs ``m - m/nd`` for the full-vector gather; the pack must come
    in under ``max_halo_frac`` of that (tiny/dense-halo coarse levels
    decline).  ``force=True`` builds regardless (tests).

    Host-side symbolic stage (numpy): per row-shard out-of-shard column
    sets, per-owner packed index lists, and the col remap into
    ``concat([x_local, halo])`` coordinates.
    """
    from ..sparse import SparseELL  # noqa: F401  (type of E)

    nd = int(mesh.devices.size)
    n_pad, m_pad = E.shape
    if n_cols is not None:
        m_pad = n_cols
    if n_pad % nd or m_pad % nd:
        raise ValueError(f"operator {E.shape} not padded for {nd} devices")
    nl, ml = n_pad // nd, m_pad // nd

    cols = np.asarray(E.cols)
    nnz = np.asarray(E.row_nnz)
    w = cols.shape[1]
    valid = np.arange(w, dtype=np.int64)[None, :] < nnz[:, None]
    rs = (np.arange(n_pad, dtype=np.int64) // nl)[:, None]   # row shard id
    owner = np.where(valid, cols // ml, rs)

    packs = []
    for s in range(nd):
        sel = valid & (owner == s) & (rs != s)
        packs.append(np.unique(cols[sel]) if sel.any()
                     else np.empty(0, dtype=np.int64))
    H = max(1, max(len(p) for p in packs))
    if not force and (nd - 1) * H >= max_halo_frac * (m_pad - ml):
        return None

    pack_idx = np.zeros((nd, H), dtype=np.int32)
    for s, p in enumerate(packs):
        pack_idx[s, :len(p)] = (p - s * ml).astype(np.int32)

    remap = (cols - rs * ml).astype(np.int64)       # owner == rs slots
    for s in range(nd):
        m = valid & (owner == s) & (rs != s)
        if m.any():
            remap[m] = ml + s * H + np.searchsorted(packs[s], cols[m])
    remap[~valid] = 0
    remap = remap.astype(np.int32)

    sh2 = NamedSharding(mesh, P(axis, None))
    sh1 = NamedSharding(mesh, P(axis))
    return HaloELL(
        data=jax.device_put(E.data, sh2),
        cols=jax.device_put(jnp.asarray(remap), sh2),
        pack_idx=jax.device_put(jnp.asarray(pack_idx), sh2),
        row_nnz=jax.device_put(E.row_nnz, sh1),
        shape=(n_pad, m_pad), mesh=mesh, axis=axis)
