"""Block diagonal-offset (BDIA) sparse storage.

The block analogue of :class:`SparseDIA` for matrices whose *block*
sparsity is banded: multi-candidate smoothed aggregation on structured
grids and Q1 elasticity produce coarse operators that are BSR matrices on
a stencil pattern (e.g. a 9-point coarse stencil of K x K blocks, K =
number of near-nullspace candidates / dofs per node).  Storing one dense
(n_blocks, K, K) array per block diagonal turns the BSR matvec into
shifted batched small-matrix products: streamed multiply-adds, no gathers
(replaces the role of scipy BSR, SURVEY.md L1, the way SparseDIA replaces
CSR).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SparseBDIA"]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class SparseBDIA:
    """blocks[k, i] = A_block[i, i + offsets[k]] (K x K zero block where
    absent/out of range); offsets are in block units.  Square only."""

    blocks: jnp.ndarray           # (n_off, n_brows, K, K)
    offsets: Tuple[int, ...]      # static, block-column - block-row
    shape: Tuple[int, int]        # scalar (unblocked) shape

    def tree_flatten(self):
        return (self.blocks,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (blocks,) = children
        offsets, shape = aux
        return cls(blocks=blocks, offsets=offsets, shape=shape)

    # -- properties ----------------------------------------------------------
    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def blocksize(self) -> int:
        return self.blocks.shape[-1]

    @property
    def n_brows(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.blocks)))

    # -- constructors --------------------------------------------------------
    @staticmethod
    def host_blocks(A_bsr, max_offsets: int = 128, dtype=None):
        """Host-side (numpy) BDIA arrays for a scipy BSR matrix: returns
        ``(blocks_np, offsets_tuple)``; raises ValueError for rectangular
        blocks or too many block diagonals."""
        import scipy.sparse as sp

        A_bsr = sp.bsr_matrix(A_bsr)
        K, K2 = A_bsr.blocksize
        if K != K2:
            raise ValueError("SparseBDIA needs square blocks")
        nb = A_bsr.shape[0] // K
        rows = np.repeat(np.arange(nb, dtype=np.int64),
                         np.diff(A_bsr.indptr))
        offs = A_bsr.indices.astype(np.int64, copy=False) - rows
        uniq = np.unique(offs)
        if uniq.size > max_offsets:
            raise ValueError(
                f"matrix has {uniq.size} block diagonals > {max_offsets}")
        dt = np.dtype(dtype) if dtype is not None else A_bsr.dtype
        if np.iscomplexobj(A_bsr.data) \
                and not np.issubdtype(dt, np.complexfloating):
            raise ValueError("cannot build real BDIA from complex data")
        blocks = np.zeros((uniq.size, nb, K, K), dtype=dt)
        ks = np.searchsorted(uniq, offs)
        blocks[ks, rows] = A_bsr.data.astype(dt, copy=False)
        return blocks, tuple(int(o) for o in uniq)

    @staticmethod
    def from_scipy_bsr(A_bsr, max_offsets: int = 128,
                       dtype=None) -> "SparseBDIA":
        from ..util.staging import stage_array
        blocks, offsets = SparseBDIA.host_blocks(A_bsr, max_offsets, dtype)
        return SparseBDIA(blocks=stage_array(blocks), offsets=offsets,
                          shape=A_bsr.shape)

    @staticmethod
    def host_transpose(blocks: np.ndarray, offsets, conj=False):
        """(A^T or A^H) of host BDIA arrays in numpy: negate offsets, shift
        each block diagonal, transpose every block."""
        nb = blocks.shape[1]
        K = blocks.shape[-1]
        offs_t = tuple(-o for o in reversed(offsets))
        out = np.zeros((len(offs_t), nb, K, K), dtype=blocks.dtype)
        for j, o in enumerate(offs_t):
            src = blocks[offsets.index(-o)]
            src_t = src.conj() if conj else src
            src_t = src_t.transpose(0, 2, 1)
            ln = max(min(nb - abs(o), nb), 0)
            if o >= 0:
                out[j, :ln] = src_t[o:o + ln]
            else:
                out[j, -o:-o + ln] = src_t[:ln]
        return out, offs_t

    def to_scipy(self):
        import scipy.sparse as sp

        nb = self.n_brows
        K = self.blocksize
        blocks = np.asarray(self.blocks)
        rows, cols, data = [], [], []
        for k, off in enumerate(self.offsets):
            r = np.arange(nb)
            c = r + off
            valid = (c >= 0) & (c < nb)
            valid &= np.abs(blocks[k]).reshape(nb, -1).sum(axis=1) > 0
            rows.append(r[valid])
            cols.append(c[valid])
            data.append(blocks[k][valid])
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        data = np.concatenate(data) if rows.size else \
            np.zeros((0, K, K), dtype=blocks.dtype)
        order = np.argsort(rows, kind="stable")
        rows, cols, data = rows[order], cols[order], data[order]
        indptr = np.bincount(rows, minlength=nb)
        indptr = np.concatenate([[0], np.cumsum(indptr)])
        return sp.bsr_matrix((data, cols, indptr), shape=self.shape,
                             blocksize=(K, K)).tocsr()

    # -- compute --------------------------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y_blk[i] = sum_k blocks[k, i] @ x_blk[i + offsets[k]]."""
        nb = self.n_brows
        K = self.blocksize
        xb = x.reshape(nb, K)
        lo = -min(min(self.offsets), 0)
        hi = max(max(self.offsets), 0)
        xpad = jnp.pad(xb, ((lo, hi), (0, 0)))
        y = jnp.zeros((nb, K), dtype=jnp.result_type(self.dtype, x.dtype))
        for k, off in enumerate(self.offsets):
            xs = jax.lax.dynamic_slice_in_dim(xpad, lo + off, nb, axis=0)
            y = y + jnp.einsum("nij,nj->ni", self.blocks[k], xs,
                               precision=jax.lax.Precision.HIGHEST)
        return y.reshape(-1)

    def matmat(self, X: jnp.ndarray) -> jnp.ndarray:
        nb = self.n_brows
        K = self.blocksize
        m = X.shape[1]
        Xb = X.reshape(nb, K, m)
        lo = -min(min(self.offsets), 0)
        hi = max(max(self.offsets), 0)
        Xpad = jnp.pad(Xb, ((lo, hi), (0, 0), (0, 0)))
        Y = jnp.zeros((nb, K, m),
                      dtype=jnp.result_type(self.dtype, X.dtype))
        for k, off in enumerate(self.offsets):
            Xs = jax.lax.dynamic_slice_in_dim(Xpad, lo + off, nb, axis=0)
            Y = Y + jnp.einsum("nij,njm->nim", self.blocks[k], Xs,
                               precision=jax.lax.Precision.HIGHEST)
        return Y.reshape(nb * K, m)

    def __matmul__(self, x):
        x = jnp.asarray(x)
        return self.matvec(x) if x.ndim == 1 else self.matmat(x)

    def diagonal(self) -> jnp.ndarray:
        """Scalar main diagonal (for Jacobi/GS dinv)."""
        if 0 in self.offsets:
            k0 = self.offsets.index(0)
            d = jnp.diagonal(self.blocks[k0], axis1=-2, axis2=-1)
            return d.reshape(-1)
        return jnp.zeros((self.shape[0],), dtype=self.dtype)

    def block_diagonal(self) -> jnp.ndarray:
        """(n_brows, K, K) main block diagonal (for block smoothers)."""
        if 0 in self.offsets:
            return self.blocks[self.offsets.index(0)]
        return jnp.zeros((self.n_brows, self.blocksize, self.blocksize),
                         dtype=self.dtype)

    def astype(self, dtype) -> "SparseBDIA":
        return SparseBDIA(self.blocks.astype(dtype), self.offsets,
                          self.shape)

    def __repr__(self):
        return (f"SparseBDIA(shape={self.shape}, K={self.blocksize}, "
                f"n_offsets={self.n_offsets}, dtype={self.dtype})")
