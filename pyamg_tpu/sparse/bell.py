"""Block padded-ELL (BELL) — the device replacement for BSR.

The reference uses scipy BSR plus block C++ kernels (``bsr_gauss_seidel``
relaxation.h:90, ``bsr_jacobi`` relaxation.h:268, ``incomplete_mat_mult_bsr``
smoothed_aggregation.h:797).  Here a block matrix is stored as a fixed-width
slab of dense blocks so block ops become *batched dense* ops.

Layout: ``data[(n_brows, width, bs, bs)]``, ``cols[(n_brows, width)]`` are
block-column indices, padding blocks are zero with ``cols`` equal to the
block-row's own index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class BlockELL:
    data: jnp.ndarray          # (n_brows, width, bs, bs)
    cols: jnp.ndarray          # (n_brows, width) int32, block-column ids
    row_nnz: jnp.ndarray       # (n_brows,) int32
    shape: Tuple[int, int]     # scalar (unblocked) shape

    def tree_flatten(self):
        return (self.data, self.cols, self.row_nnz), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, cols, row_nnz = children
        (shape,) = aux
        return cls(data=data, cols=cols, row_nnz=row_nnz, shape=shape)

    @property
    def blocksize(self) -> int:
        return self.data.shape[-1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def n_brows(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def from_scipy(A, blocksize: int | None = None, width: int | None = None,
                   dtype=None) -> "BlockELL":
        import scipy.sparse as sp

        if blocksize is None:
            blocksize = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
        B = sp.bsr_matrix(A, blocksize=(blocksize, blocksize))
        B.sort_indices()
        nb = B.shape[0] // blocksize
        nnz_per_row = np.diff(B.indptr).astype(np.int32)
        w = max(1, int(nnz_per_row.max()) if width is None else width)
        dt = np.dtype(dtype) if dtype is not None else B.dtype
        data = np.zeros((nb, w, blocksize, blocksize), dtype=dt)
        cols = np.tile(np.arange(nb, dtype=np.int32)[:, None], (1, w))
        rows = np.repeat(np.arange(nb), nnz_per_row)
        offs = np.arange(len(B.indices)) - np.repeat(B.indptr[:-1], nnz_per_row)
        data[rows, offs] = B.data.astype(dt)
        cols[rows, offs] = B.indices.astype(np.int32)
        from ..util.staging import stage_array
        return BlockELL(
            data=stage_array(data),
            cols=stage_array(cols),
            row_nnz=stage_array(nnz_per_row),
            shape=B.shape,
        )

    def to_scipy(self):
        import scipy.sparse as sp

        bs = self.blocksize
        nb = self.n_brows
        w = self.width
        data = np.asarray(self.data)
        cols = np.asarray(self.cols)
        nnz = np.asarray(self.row_nnz)
        valid = np.arange(w)[None, :] < nnz[:, None]
        indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int32)
        return sp.bsr_matrix(
            (data[valid], cols[valid], indptr), shape=self.shape
        ).tocsr()

    def valid_mask(self) -> jnp.ndarray:
        w = self.width
        return jnp.arange(w, dtype=jnp.int32)[None, :] < self.row_nnz[:, None]

    def block_diagonal(self) -> jnp.ndarray:
        """(n_brows, bs, bs) array of diagonal blocks (zero where absent)."""
        nb = self.n_brows
        isdiag = self.cols == jnp.arange(nb, dtype=self.cols.dtype)[:, None]
        return jnp.sum(jnp.where(isdiag[:, :, None, None], self.data, 0), axis=1)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x with x of (unblocked) length shape[1]."""
        bs = self.blocksize
        xb = x.reshape(self.shape[1] // bs, bs)
        gathered = xb[self.cols]                                # (nb, w, bs)
        yb = jnp.einsum("nwij,nwj->ni", self.data, gathered,
                        precision=jax.lax.Precision.HIGHEST)
        return yb.reshape(-1)

    def __matmul__(self, x):
        return self.matvec(jnp.asarray(x))

    def astype(self, dtype) -> "BlockELL":
        return BlockELL(self.data.astype(dtype), self.cols, self.row_nnz, self.shape)

    def __repr__(self):
        return (f"BlockELL(shape={self.shape}, blocksize={self.blocksize}, "
                f"width={self.width}, dtype={self.dtype})")
