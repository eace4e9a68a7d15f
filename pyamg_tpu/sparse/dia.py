"""Diagonal-offset (DIA) sparse storage — the structured fast path.

A gather-based ELL SpMV reads its column indices and gathers x: it moves
more bytes than the values and is a poor hot path.  Matrices from discretized
PDEs on grids — and their Galerkin coarse operators under grid-block
aggregation — have entries on a handful of fixed diagonals.  Storing one
dense vector per diagonal turns SpMV into shifted elementwise multiply-adds:
streamed reads, no gathers, and under `jax.sharding` the shifts become
automatic halo exchanges.

Replaces the role of CSR for structured levels (reference substrate:
scipy.sparse, SURVEY.md L1); unstructured levels fall back to
:class:`~pyamg_tpu.sparse.ell.SparseELL`.

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu.gallery import poisson
>>> from pyamg_tpu.sparse import SparseDIA
>>> A = poisson((8, 8), format='csr')
>>> D = SparseDIA.from_scipy(A)
>>> x = np.arange(A.shape[0], dtype=float)
>>> bool(np.allclose(np.asarray(D.matvec(x)), A @ x))
True
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SparseDIA"]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class SparseDIA:
    """diags[k, i] = A[i, i + offsets[k]] (zero where absent/out of range).

    Square or rectangular; ``matvec`` pads x once and accumulates k shifted
    products.
    """

    diags: jnp.ndarray            # (k, n_rows)
    offsets: Tuple[int, ...]      # static
    shape: Tuple[int, int]

    def tree_flatten(self):
        return (self.diags,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (diags,) = children
        offsets, shape = aux
        return cls(diags=diags, offsets=offsets, shape=shape)

    # -- properties ---------------------------------------------------------
    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.diags)))

    # -- constructors --------------------------------------------------------
    @staticmethod
    def host_diags(A, max_offsets: int = 128, dtype=None,
                   offsets=None, entry_offsets=None, entry_rows=None):
        """Host-side (numpy) DIA arrays for a scipy matrix: returns
        ``(diags_np, offsets_tuple)`` without touching the device.  Setup
        code stages all array massaging through this so each operator costs
        exactly one H2D upload and zero device compiles.

        ``dtype``: build the array directly in this dtype (a host-side cast
        is cheaper than transferring f64 and casting on device).
        ``offsets``: precomputed sorted distinct diagonal offsets.
        ``entry_offsets``: precomputed per-entry col-row array (skips the
        O(nnz) rediscovery when the caller already computed it).
        """
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        n, m = A.shape
        if offsets is None and entry_offsets is None and entry_rows is None:
            from ..amg_core import csr_to_dia_native

            out = csr_to_dia_native(A, dtype=dtype,
                                    max_offsets=max_offsets)
            if out is not None:
                return out
            # fall through: numpy staging (also raises the over-limit
            # ValueError below for parity with the native rejection)
        if entry_rows is None:
            rows = np.repeat(np.arange(n, dtype=np.int32),
                             np.diff(A.indptr))
        else:
            rows = entry_rows
        if entry_offsets is None:
            offs = A.indices.astype(np.int32, copy=False) - rows
        else:
            offs = entry_offsets
        if offsets is None:
            uniq = np.unique(offs)
        else:
            uniq = np.asarray(sorted(int(o) for o in offsets),
                              dtype=offs.dtype)
        if uniq.size > max_offsets:
            raise ValueError(
                f"matrix has {uniq.size} distinct diagonals > {max_offsets}")
        dt = np.dtype(dtype) if dtype is not None else A.dtype
        if np.iscomplexobj(A.data) \
                and not np.issubdtype(dt, np.complexfloating):
            raise ValueError("cannot build real DIA from complex data")
        diags = np.zeros((uniq.size, n), dtype=dt)
        # offset -> slot lookup table: O(nnz) gather instead of an
        # O(nnz log k) searchsorted (plus it validates coverage for free)
        lut = np.full(n + m + 1, -1, dtype=np.int64)
        lut[uniq + n] = np.arange(uniq.size, dtype=np.int64)
        ks = lut[offs.astype(np.int64, copy=False) + n]
        if offsets is not None and entry_offsets is None:
            # offsets supplied independently of the entries: validate
            # (when entry_offsets is given, uniq came from the same array)
            if (ks < 0).any():
                raise ValueError("provided offsets do not cover the matrix")
        # flat 1-D scatter (2-D fancy assignment is ~2x slower)
        diags.reshape(-1)[ks * n + rows] = A.data.astype(dt, copy=False)
        return diags, tuple(int(o) for o in uniq)

    @staticmethod
    def from_scipy(A, max_offsets: int = 128, dtype=None,
                   offsets=None, entry_offsets=None) -> "SparseDIA":
        """Convert CSR/any scipy matrix; raises ValueError if the matrix has
        more than ``max_offsets`` distinct diagonals."""
        diags, uniq = SparseDIA.host_diags(
            A, max_offsets=max_offsets, dtype=dtype, offsets=offsets,
            entry_offsets=entry_offsets)
        from ..util.staging import stage_array
        return SparseDIA(diags=stage_array(diags), offsets=uniq,
                         shape=A.shape)

    @staticmethod
    def host_transpose(diags: np.ndarray, offsets, shape):
        """Transpose of host DIA arrays, in numpy: the (-o) diagonal of A^T
        at row j equals A's (o) diagonal at row j+o — a shift of each
        diagonal vector.  Returns ``(diags_T, offsets_T)`` for the
        ``shape[::-1]`` operator (no device work; used by setup staging)."""
        n, m = shape
        offs_t = tuple(-o for o in reversed(offsets))
        out = np.zeros((len(offs_t), m), dtype=diags.dtype)
        for j, o in enumerate(offs_t):
            src = diags[offsets.index(-o)]
            ln = min(n, m + o) if o < 0 else min(n - o, m)
            ln = max(ln, 0)
            if o >= 0:
                out[j, :ln] = src[o:o + ln]
            else:
                out[j, -o:-o + ln] = src[:ln]
        return out, offs_t

    def to_scipy(self):
        import scipy.sparse as sp

        n, m = self.shape
        diags = np.asarray(self.diags)
        rows, cols, vals = [], [], []
        for k, off in enumerate(self.offsets):
            r = np.arange(n)
            c = r + off
            valid = (c >= 0) & (c < m) & (diags[k] != 0)
            rows.append(r[valid])
            cols.append(c[valid])
            vals.append(diags[k][valid])
        return sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=self.shape).tocsr()

    # -- compute --------------------------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y[i] = sum_k diags[k, i] * x[i + offsets[k]]: x padded once, then
        k shifted slices feeding one multiply-add chain, which XLA fuses
        into a single pass; under ``jax.sharding`` the shifts become halo
        exchanges."""
        n, m = self.shape
        lo = -min(min(self.offsets), 0)
        hi = max(max(self.offsets), 0)
        xpad = jnp.pad(x, (lo, hi + max(n - m, 0)))
        y = jnp.zeros((n,), dtype=jnp.result_type(self.dtype, x.dtype))
        for k, off in enumerate(self.offsets):
            y = y + self.diags[k] * jax.lax.dynamic_slice_in_dim(
                xpad, lo + off, n)
        return y

    def matmat(self, X: jnp.ndarray) -> jnp.ndarray:
        n, m = self.shape
        lo = -min(min(self.offsets), 0)
        hi = max(max(self.offsets), 0)
        Xpad = jnp.pad(X, ((lo, hi + max(n - m, 0)), (0, 0)))
        Y = jnp.zeros((n, X.shape[1]),
                      dtype=jnp.result_type(self.dtype, X.dtype))
        for k, off in enumerate(self.offsets):
            Y = Y + self.diags[k][:, None] * jax.lax.dynamic_slice_in_dim(
                Xpad, lo + off, n, axis=0)
        return Y

    def __matmul__(self, x):
        x = jnp.asarray(x)
        return self.matvec(x) if x.ndim == 1 else self.matmat(x)

    def diagonal(self) -> jnp.ndarray:
        if 0 in self.offsets:
            return self.diags[self.offsets.index(0)]
        return jnp.zeros((self.shape[0],), dtype=self.dtype)

    def astype(self, dtype) -> "SparseDIA":
        return SparseDIA(self.diags.astype(dtype), self.offsets, self.shape)

    def __repr__(self):
        return (f"SparseDIA(shape={self.shape}, n_offsets={self.n_offsets}, "
                f"dtype={self.dtype})")
