"""Automatic device-format selection for hierarchy operators.

Priority: DIA (shift-multiply-add, no gathers) → dense (one matmul) for
small operators → padded-ELL gather fallback.
"""

from __future__ import annotations

import numpy as np

from .dia import SparseDIA
from .ell import SparseELL
from .linop import DenseOp

__all__ = ["device_operator", "count_diagonals"]

# Cost model: a k-offset DIA matvec streams ~k+2 vectors, a dense matvec
# n^2 MACs, an ELL matvec a gather per stored entry.  The thresholds below
# are heuristics that have not been measured on a GPU.
DIA_MAX_OFFSETS = 512
DIA_MEM_BUDGET = 10          # accept k*n up to this multiple of nnz
DIA_MEM_FLOOR = 64_000_000   # ... or up to this many stored entries
DENSE_MAX = 4096


def _entry_rows_offsets(A_csr):
    """(row, col - row) for every stored entry, in int32."""
    rows = np.repeat(np.arange(A_csr.shape[0], dtype=np.int32),
                     np.diff(A_csr.indptr))
    return rows, A_csr.indices.astype(np.int32, copy=False) - rows


def _entry_offsets(A_csr):
    """col - row for every stored entry, in int32 (valid for dims < 2^31)."""
    return _entry_rows_offsets(A_csr)[1]


def _distinct_offsets(A_csr, entry_offs=None):
    if entry_offs is None:
        entry_offs = _entry_offsets(A_csr)
    return np.unique(entry_offs)


def count_diagonals(A_csr) -> int:
    return int(_distinct_offsets(A_csr).size)


def device_operator(A_csr, dia_max_offsets: int = DIA_MAX_OFFSETS,
                    dense_max: int = DENSE_MAX, dtype=None):
    """Pick the best device representation for a host CSR operator."""
    import scipy.sparse as sp

    from ..amg_core import dia_offsets_native, csr_to_dia_fill_native

    A_csr = sp.csr_matrix(A_csr)
    n, m = A_csr.shape
    offs = dia_offsets_native(A_csr, max_offsets=dia_max_offsets)
    entry_rows = entry_offs = None
    if offs is None:
        # no native library (or >max_offsets): numpy discovery
        entry_rows, entry_offs = _entry_rows_offsets(A_csr)
        offs = _distinct_offsets(A_csr, entry_offs)
    k = int(offs.size)
    mem_ok = k * n <= max(DIA_MEM_BUDGET * max(A_csr.nnz, 1), DIA_MEM_FLOOR)
    if k <= dia_max_offsets and mem_ok:
        from ..util.staging import stage_array

        diags = csr_to_dia_fill_native(A_csr, offs, dtype=dtype)
        if diags is not None:
            return SparseDIA(diags=stage_array(diags),
                             offsets=tuple(int(o) for o in offs),
                             shape=A_csr.shape)
        diags, uniq = SparseDIA.host_diags(
            A_csr, max_offsets=dia_max_offsets, dtype=dtype, offsets=offs,
            entry_offsets=entry_offs, entry_rows=entry_rows)
        return SparseDIA(diags=stage_array(diags), offsets=uniq,
                         shape=A_csr.shape)
    if n <= dense_max and m <= dense_max:
        from ..util.staging import stage_array

        # cast the nnz-sized sparse data BEFORE densifying: toarray() then
        # writes the (n, m) array directly in the target dtype (astype on
        # the dense array costs a full extra n*m read+write pass)
        if dtype is not None and A_csr.dtype != np.dtype(dtype):
            A_csr = A_csr.astype(dtype)
        mat = A_csr.toarray()
        return DenseOp(mat=stage_array(mat), shape=(n, m))
    return SparseELL.from_scipy(A_csr, dtype=dtype)
