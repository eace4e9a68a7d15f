"""Padded-ELL sparse matrix container — the general sparse substrate.

Design rationale (vs the reference's CSR, pyamg/amg_core/*.h): XLA wants static
shapes, contiguous vectors and gather-friendly layouts.  A padded-ELL
layout stores each row's nonzeros in a fixed-width ``(n_rows, width)`` slab so
every sparse op becomes a dense gather + elementwise + row-reduction that XLA
fuses into one loop, and SpMV jit-compiles once per shape.

Conventions
-----------
* ``data[i, j]`` / ``cols[i, j]`` hold the j-th stored entry of row i.
* Valid entries come first; ``row_nnz[i]`` counts them.
* Padding entries have ``data == 0`` and ``cols == i`` (the row's own index),
  so a gather of ``x[cols]`` stays in-bounds and *local* under row sharding,
  and SpMV needs no mask at all.

Reference parity: this file replaces the CSR/BSR substrate the reference gets
from scipy.sparse (SURVEY.md L1) and the raw-array kernel calling convention of
pyamg/amg_core (SURVEY.md L0).

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu.gallery import poisson
>>> from pyamg_tpu.sparse import SparseELL
>>> A = poisson((8, 8), format='csr')
>>> E = SparseELL.from_scipy(A)
>>> x = np.arange(A.shape[0], dtype=float)
>>> bool(np.allclose(np.asarray(E.matvec(x)), A @ x))
True
>>> bool((E.to_scipy() != A).nnz == 0)
True
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _as_int(x):
    return int(x)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class SparseELL:
    """Fixed-width padded sparse matrix (ELLPACK layout) on device.

    Attributes
    ----------
    data : (n_rows, width) array of entry values; zero at padding slots.
    cols : (n_rows, width) int32 array of column indices; padding slots
        hold the row's own index.
    row_nnz : (n_rows,) int32 count of valid entries per row.
    shape : static (n_rows, n_cols).
    """

    data: jnp.ndarray
    cols: jnp.ndarray
    row_nnz: jnp.ndarray
    shape: Tuple[int, int]

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.data, self.cols, self.row_nnz), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, cols, row_nnz = children
        (shape,) = aux
        return cls(data=data, cols=cols, row_nnz=row_nnz, shape=shape)

    # -- basic properties --------------------------------------------------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        return int(np.asarray(self.row_nnz).sum())

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_scipy(A, width: int | None = None, dtype=None, pad_to: int = 1) -> "SparseELL":
        """Convert a scipy.sparse matrix (any format) to padded ELL.

        Parameters
        ----------
        width : optional fixed row width; defaults to the max row nnz,
            rounded up to a multiple of ``pad_to``.
        pad_to : round the width up to a multiple of this (lane alignment).
        """
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        A.sort_indices()
        n, m = A.shape
        nnz_per_row = np.diff(A.indptr).astype(np.int32)
        max_nnz = int(nnz_per_row.max()) if n else 0
        w = max(1, max_nnz if width is None else width)
        w = -(-w // pad_to) * pad_to
        if width is not None and max_nnz > width:
            raise ValueError(f"width={width} < max row nnz {max_nnz}")
        dt = np.dtype(dtype) if dtype is not None else A.dtype
        data = np.zeros((n, w), dtype=dt)
        cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
        # scatter CSR entries into the slab
        rows = np.repeat(np.arange(n), nnz_per_row)
        offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
        data[rows, offs] = A.data.astype(dt)
        cols[rows, offs] = A.indices.astype(np.int32)
        from ..util.staging import stage_array
        return SparseELL(
            data=stage_array(data),
            cols=stage_array(cols),
            row_nnz=stage_array(nnz_per_row),
            shape=(n, m),
        )

    @staticmethod
    def from_dense(A, **kw) -> "SparseELL":
        import scipy.sparse as sp

        return SparseELL.from_scipy(sp.csr_matrix(np.asarray(A)), **kw)

    def to_scipy(self):
        import scipy.sparse as sp

        n, m = self.shape
        data = np.asarray(self.data)
        cols = np.asarray(self.cols)
        nnz = np.asarray(self.row_nnz)
        w = self.width
        valid = np.arange(w)[None, :] < nnz[:, None]
        rows = np.repeat(np.arange(n), w).reshape(n, w)
        M = sp.coo_matrix(
            (data[valid], (rows[valid], cols[valid])), shape=(n, m)
        )
        return M.tocsr()

    def to_dense(self) -> jnp.ndarray:
        n, m = self.shape
        w = self.width
        valid = self.valid_mask()
        out = jnp.zeros((n, m), dtype=self.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, w))
        return out.at[rows, self.cols].add(jnp.where(valid, self.data, 0))

    # -- masks / views -----------------------------------------------------
    def valid_mask(self) -> jnp.ndarray:
        """(n_rows, width) boolean mask of valid (non-padding) slots."""
        w = self.width
        return jnp.arange(w, dtype=jnp.int32)[None, :] < self.row_nnz[:, None]

    def diagonal(self) -> jnp.ndarray:
        """Extract the main diagonal (0 where structurally absent)."""
        n = self.shape[0]
        isdiag = self.cols == jnp.arange(n, dtype=self.cols.dtype)[:, None]
        return jnp.sum(jnp.where(isdiag, self.data, 0), axis=1)

    # -- compute -----------------------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x.  Pure gather + multiply + row-sum; fuses under jit."""
        return ell_matvec(self.data, self.cols, x)

    def rmatvec(self, y: jnp.ndarray) -> jnp.ndarray:
        """x = A.T @ y via scatter-add (no explicit transpose)."""
        contrib = self.data * y[:, None]
        out = jnp.zeros((self.shape[1],), dtype=jnp.result_type(self.dtype, y.dtype))
        return out.at[self.cols].add(contrib)

    def matmat(self, X: jnp.ndarray) -> jnp.ndarray:
        """Y = A @ X for dense X of shape (n_cols, k)."""
        gathered = X[self.cols]                      # (n, w, k)
        return jnp.einsum("nw,nwk->nk", self.data, gathered,
                          precision=jax.lax.Precision.HIGHEST)

    def rmatmat(self, Y: jnp.ndarray) -> jnp.ndarray:
        """X = A.T @ Y for dense Y of shape (n_rows, k)."""
        contrib = self.data[:, :, None] * Y[:, None, :]   # (n, w, k)
        out = jnp.zeros((self.shape[1], Y.shape[1]),
                        dtype=jnp.result_type(self.dtype, Y.dtype))
        return out.at[self.cols].add(contrib)

    def __matmul__(self, x):
        if isinstance(x, SparseELL):
            raise TypeError("sparse@sparse: use pyamg_tpu.sparse.ops.spgemm")
        x = jnp.asarray(x)
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)

    def scale_rows(self, s: jnp.ndarray) -> "SparseELL":
        return SparseELL(self.data * s[:, None], self.cols, self.row_nnz, self.shape)

    def scale_cols(self, s: jnp.ndarray) -> "SparseELL":
        return SparseELL(self.data * s[self.cols], self.cols, self.row_nnz, self.shape)

    def astype(self, dtype) -> "SparseELL":
        return SparseELL(self.data.astype(dtype), self.cols, self.row_nnz, self.shape)

    def __repr__(self):
        return (f"SparseELL(shape={self.shape}, width={self.width}, "
                f"dtype={self.dtype})")


@jax.jit
def ell_matvec(data: jnp.ndarray, cols: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Core padded-ELL SpMV: ``y[i] = sum_j data[i,j] * x[cols[i,j]]``.

    Equivalent computation to CSR SpMV in the reference's scipy substrate; the
    padded layout turns it into one gather and one lane-aligned reduction.
    """
    return jnp.sum(data * x[cols], axis=1)
