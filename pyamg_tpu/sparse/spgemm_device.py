"""Device-side numeric SpGEMM over a host-symbolic pattern (padded ELL).

Host/device split of the Galerkin product (role of the reference's serial
``A = R * A * P``, aggregation/aggregation.py:429 / classical/classical.py:187
via scipy csr_matmat): the *symbolic* phase — integer-only pattern
construction — is inherently irregular pointer chasing and stays on host,
while the *numeric* phase (all the flops and HBM traffic) runs on device as
a fully regular program:

    out[i, o] = sum_a sum_b  A.data[i, a] * B.data[A.cols[i, a], b]
                             * [B.cols[A.cols[i, a], b] == out_cols[i, o]]

i.e. one row gather of B per A-slot followed by a broadcast-compare
contraction — no scatters, no dynamic shapes, lanes fully occupied.  Under a
``jax.sharding.Mesh`` the A/out arrays row-shard and XLA inserts a single
all-gather for B's (much smaller) arrays: hierarchy *construction* becomes
an SPMD program (SURVEY §7 step 8), not a serial host stage.

The contraction is scanned over A's slot axis so the transient is
``(n, w_B, w_out)`` per step rather than ``(n, w_A, w_B, w_out)``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .ell import SparseELL

__all__ = ["masked_spgemm_ell", "pattern_spgemm", "rap_pattern",
           "sentinel_cols"]


@jax.jit
def _masked_matmul_vals(Ad, Ac, Bd, Bc, out_cols):
    """Values of (A @ B) at ``out_cols`` slots; -1 marks padding slots.

    Padding is self-masking: A's padding slots have data 0, B's padding
    slots have data 0, and out's padding sentinel -1 matches no column —
    so no explicit validity masks are needed anywhere.
    """
    acc0 = jnp.zeros(out_cols.shape,
                     dtype=jnp.result_type(Ad.dtype, Bd.dtype))

    def body(acc, slot):
        a_val, a_col = slot                       # (n,), (n,) int32
        bg = Bd[a_col]                            # (n, w_B) gathered B rows
        bgc = Bc[a_col]                           # (n, w_B)
        hit = bgc[:, :, None] == out_cols[:, None, :]   # (n, w_B, w_out)
        contrib = a_val[:, None] * bg             # (n, w_B)
        return acc + jnp.sum(jnp.where(hit, contrib[:, :, None], 0),
                             axis=1), None

    acc, _ = jax.lax.scan(body, acc0, (Ad.T, Ac.T))
    return acc


def sentinel_cols(pattern: SparseELL) -> jnp.ndarray:
    """Pattern column slab with padding slots replaced by -1 (match-never)."""
    return jnp.where(pattern.valid_mask(), pattern.cols, -1)


def masked_spgemm_ell(A: SparseELL, B: SparseELL, pattern: SparseELL,
                      out_cols=None) -> SparseELL:
    """C = (A @ B) restricted to ``pattern``'s slots, numeric on device.

    ``pattern`` supplies the output structure (cols/row_nnz); its data is
    ignored.  ``out_cols`` may pass a precomputed :func:`sentinel_cols`
    slab to keep repeated products (energy iterations, re-RAPs) free of
    host work.  Entries of the true product outside the pattern are
    dropped — the caller guarantees containment (Galerkin patterns are
    built from the same symbolic chain, so they are exact).
    """
    if out_cols is None:
        out_cols = sentinel_cols(pattern)
    vals = _masked_matmul_vals(A.data, A.cols, B.data, B.cols, out_cols)
    return SparseELL(data=vals, cols=pattern.cols,
                     row_nnz=pattern.row_nnz, shape=pattern.shape)


def _host_pattern(X):
    import scipy.sparse as sp

    if isinstance(X, SparseELL):
        X = X.to_scipy()
    X = sp.csr_matrix(X).copy()
    X.data = np.ones_like(X.data, dtype=np.float64)
    return X


def pattern_spgemm(A, B, dtype=None) -> SparseELL:
    """Host-symbolic product pattern of A @ B as a structure-only ELL."""
    import scipy.sparse as sp

    C = sp.csr_matrix(_host_pattern(A) @ _host_pattern(B))
    C.sort_indices()
    return SparseELL.from_scipy(C, dtype=dtype or np.float32)


def rap_pattern(R, A, P, dtype=None):
    """Host-symbolic patterns (pat_AP, pat_RAP) for the Galerkin product."""
    import scipy.sparse as sp

    pA, pP, pR = _host_pattern(A), _host_pattern(P), _host_pattern(R)
    pAP = sp.csr_matrix(pA @ pP)
    pAP.sort_indices()
    pRAP = sp.csr_matrix(pR @ pAP)
    pRAP.sort_indices()
    dt = dtype or np.float32
    return (SparseELL.from_scipy(pAP, dtype=dt),
            SparseELL.from_scipy(pRAP, dtype=dt))


@jax.jit
def _transpose_vals(Ad, Ac, Tc_sent):
    """Values of A^T laid onto a precomputed transpose pattern.

    Transpose entry (j, i) equals A[i, j]: gather source row i per slot
    (Tc_sent holds i, -1 at padding) and pick out column j by compare —
    the same gather+match shape as the masked product, no scatters."""
    n_t = Tc_sent.shape[0]
    rows_t = jnp.arange(n_t, dtype=jnp.int32)
    src_rows = jnp.where(Tc_sent >= 0, Tc_sent, 0)   # (n_t, w_t)
    cols_g = Ac[src_rows]                            # (n_t, w_t, w_a)
    vals_g = Ad[src_rows]
    hit = cols_g == rows_t[:, None, None]
    out = jnp.sum(jnp.where(hit, vals_g, 0), axis=2)
    return jnp.where(Tc_sent >= 0, out, 0)


def ell_transpose_onto(A: SparseELL, pattern: SparseELL) -> SparseELL:
    """A^T with values computed on device onto a host-symbolic pattern."""
    vals = _transpose_vals(A.data, A.cols, sentinel_cols(pattern))
    return SparseELL(data=vals.astype(A.dtype), cols=pattern.cols,
                     row_nnz=pattern.row_nnz, shape=pattern.shape)
