"""Host-side relaxation methods (reference-parity smoothers).

Reference parity: pyamg/relaxation/relaxation.py — every public entry point,
same in-place ``(A, x, b, ...)`` contract.  These numpy/scipy versions serve
the *setup phase* (improve_candidates, CR, adaptive bootstraps) and as the
gold-reference oracle for the device smoothers in
:mod:`pyamg_tpu.relaxation.device`, which are the device execution path.

Sequential sweeps (Gauss-Seidel & friends) use sparse triangular solves
instead of the reference's per-row C loops (relaxation.h:34).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.utils import to_csr, get_block_diag

__all__ = [
    "make_system", "sor", "gauss_seidel", "jacobi", "polynomial",
    "block_jacobi", "block_gauss_seidel", "gauss_seidel_indexed",
    "jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr", "schwarz",
    "schwarz_parameters", "zebra", "line_gauss_seidel", "line_jacobi",
]


def make_system(A, x, b, formats=None):
    """Validate shapes/dtypes and return (A_csr, x, b) with x, b raveled
    views (reference relaxation.py:21)."""
    if not sp.issparse(A):
        A = to_csr(A)
    else:
        A = A.tocsr() if A.format not in ("csr", "bsr") else A
    x = np.ravel(np.asarray(x))
    b = np.ravel(np.asarray(b))
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    if A.shape[0] != x.size or A.shape[0] != b.size:
        raise ValueError("A, x and b must have matching dimensions")
    if x.dtype != A.dtype and np.iscomplexobj(A.data) and not np.iscomplexobj(x):
        raise ValueError("x and A must have compatible dtypes")
    if not np.issubdtype(x.dtype, np.inexact):
        # the sweeps update x in place; an integer x cannot hold the result
        # (reference make_system is equally strict, relaxation.py:21)
        raise TypeError(f"x must be a float/complex array, got {x.dtype}")
    return A, x, b


def _fix_zero_diag(T, r):
    """Rows with a zero (or missing) diagonal are skipped by the
    reference's Gauss-Seidel (relaxation.h:34 updates only when diag != 0).
    In delta form that means dx[i] = 0: put 1 on those diagonals and zero
    the corresponding rhs entries."""
    d = T.diagonal()
    zero = d == 0
    if zero.any():
        T = T + sp.dia_matrix((zero.astype(T.dtype)[None, :], [0]),
                              shape=T.shape)
        r = np.where(zero, 0, r)
    return T.tocsr(), r


def _tril_solve(A, r):
    """(D+L)^{-1} r via sparse forward triangular solve."""
    from scipy.sparse.linalg import spsolve_triangular

    T, r = _fix_zero_diag(sp.tril(A, 0).tocsr(), r)
    return spsolve_triangular(T, r, lower=True)


def _triu_solve(A, r):
    from scipy.sparse.linalg import spsolve_triangular

    T, r = _fix_zero_diag(sp.triu(A, 0).tocsr(), r)
    return spsolve_triangular(T, r, lower=False)


def gauss_seidel(A, x, b, iterations=1, sweep="forward"):
    """In-place Gauss-Seidel: (D+L) x_{k+1} = b - U x_k (forward).

    Reference: relaxation.py:280 → amg_core.gauss_seidel (relaxation.h:34).
    Real f64 CSR input runs the native in-place sweep (a full-order
    gauss_seidel_indexed); other dtypes use sparse triangular solves in
    delta form.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu.gallery import poisson
    >>> from pyamg_tpu.relaxation.relaxation import gauss_seidel
    >>> A = poisson((10, 10), format='csr')
    >>> b = np.ones(A.shape[0])
    >>> x = np.zeros(A.shape[0])
    >>> r0 = np.linalg.norm(b - A @ x)
    >>> _ = gauss_seidel(A, x, b, iterations=5)
    >>> bool(np.linalg.norm(b - A @ x) < r0)
    True
    """
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()

    if sweep not in ("forward", "backward", "symmetric"):
        raise ValueError(f"valid sweep directions: forward/"
                         f"backward/symmetric, got {sweep!r}")
    if A.dtype == np.float64 and x_v.dtype == np.float64:
        from ..amg_core import gauss_seidel_sweeps_native

        if gauss_seidel_sweeps_native(A, x_v, b_v, iterations, sweep):
            np.asarray(x).reshape(-1)[:] = x_v
            return x

    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            r = b_v - A @ x_v
            x_v += _tril_solve(A, r)
        if sweep in ("backward", "symmetric"):
            r = b_v - A @ x_v
            x_v += _triu_solve(A, r)
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def zebra(A, x, b, iterations=1, sweep="symmetric", grid=None, axis=None,
          omega=1.0):
    """Host zebra line relaxation: exact tridiagonal solves along one grid
    axis, alternating even/odd lines (the host twin of the device PCR
    zebra, relaxation/device.py:line_relaxation_step).

    ``grid`` defaults to ``A.grid`` (stencil matrices carry it; the
    structured SA path attaches it to coarse levels).  Without a usable
    grid — or on node-blocked levels — falls back to symmetric GS, like
    the device smoother factory does for structure-less levels.

    The adaptive (aSA) candidate machinery resolves smoothers from this
    module by name: candidates must be relaxed with the SAME iteration the
    final cycle uses, or the 'algebraically smooth error' the candidates
    capture is the wrong one (Brezina et al., §3 — the reference relaxes
    candidates with its cycle smoother too, adaptive.py:363).  A GS-relaxed
    candidate on a strongly anisotropic problem looks locally constant
    along the strong axis, gets eliminated as redundant, and leaves a
    multi-candidate hierarchy effectively single-candidate.
    """
    A, x, b = make_system(A, x, b)
    n = A.shape[0]
    if grid is None:
        grid = getattr(A, "grid", None)
    if grid is None or int(np.prod(grid)) != n:
        return gauss_seidel(A, x, b, iterations=iterations,
                            sweep="symmetric")
    # the setup (several O(n) diagonal extractions) is cached ON the
    # matrix: aSA candidate relaxation calls zebra hundreds of times on
    # the same operator (adaptive.py), and re-deriving it dominated.
    # A small value probe (<=64 samples of A.data) guards against callers
    # that mutate the operator's values in place between sweeps.
    key = (tuple(int(g) for g in grid), axis)
    stride = max(1, A.data.shape[0] // 64)
    probe = A.data[::stride]
    cache = getattr(A, "_zebra_setup", None)
    if (cache is not None and cache[0] == key
            and np.array_equal(cache[1], probe)):
        lines, unlines, solve_lines, parity, solve_phase = cache[2]
    else:
        lines, unlines, solve_lines, parity, solve_phase = \
            _line_setup(A, grid, axis)
        try:
            A._zebra_setup = (key, probe.copy(),
                              (lines, unlines, solve_lines, parity,
                               solve_phase))
        except AttributeError:      # exotic matrix types: skip the cache
            pass
    phases = (0, 1) if sweep in ("forward", "symmetric") else (1, 0)
    for _ in range(iterations):
        for ph in phases:
            # solve_phase runs Thomas on the phase's lines only (half the
            # work of solve-all-then-mask) with bit-identical results
            x += omega * unlines(solve_phase(lines(b - A @ x), ph))
    return x


def _line_setup(A, grid, axis):
    """Shared host line-solve machinery: returns (lines, unlines,
    solve_lines, parity) for tridiagonal lines along ``axis``."""
    n = A.shape[0]
    grid = tuple(int(g) for g in grid)
    d = len(grid)
    strides = [int(np.prod(grid[k + 1:])) for k in range(d)]
    if axis is None:
        coup = [np.abs(A.diagonal(s)).sum() for s in strides]
        axis = int(np.argmax(coup))
    axis = axis % d
    stride = strides[axis]
    L = grid[axis]

    d_flat = A.diagonal().copy()
    d_flat[d_flat == 0] = 1.0
    du_flat = np.zeros(n, dtype=A.dtype)
    du_flat[:n - stride] = A.diagonal(stride)
    dl_flat = np.zeros(n, dtype=A.dtype)
    dl_flat[stride:] = A.diagonal(-stride)
    coords = np.unravel_index(np.arange(n), grid)
    du_flat[coords[axis] == L - 1] = 0.0
    dl_flat[coords[axis] == 0] = 0.0

    def lines(v):
        return np.moveaxis(v.reshape(grid), axis, -1).reshape(-1, L)

    def unlines(M):
        shp = tuple(grid[k] for k in range(d) if k != axis) + (L,)
        return np.moveaxis(M.reshape(shp), -1, axis).ravel()

    dl, dm, du = lines(dl_flat), lines(d_flat), lines(du_flat)
    parity = np.arange(dm.shape[0]) % 2

    dlc = np.ascontiguousarray(dl, dtype=np.float64) \
        if not np.iscomplexobj(dm) else None
    dmc = np.ascontiguousarray(dm, dtype=np.float64) if dlc is not None \
        else None
    duc = np.ascontiguousarray(du, dtype=np.float64) if dlc is not None \
        else None

    def solve_lines(R):
        """Vectorized Thomas over all lines: (nlines, L) rhs -> solution."""
        if dlc is not None and not np.iscomplexobj(R):
            from ..amg_core import thomas_lines_native

            # one allocation: converts dtype/layout AND detaches from R
            xp = np.array(R, dtype=np.float64, order="C", copy=True)
            if thomas_lines_native(dlc, dmc, duc, xp):
                return xp
        cp = np.zeros_like(dm)
        xp = np.zeros_like(R)
        cp[:, 0] = du[:, 0] / dm[:, 0]
        xp[:, 0] = R[:, 0] / dm[:, 0]
        for i in range(1, L):
            den = dm[:, i] - dl[:, i] * cp[:, i - 1]
            den = np.where(den == 0, 1.0, den)
            cp[:, i] = du[:, i] / den
            xp[:, i] = (R[:, i] - dl[:, i] * xp[:, i - 1]) / den
        for i in range(L - 2, -1, -1):
            xp[:, i] -= cp[:, i] * xp[:, i + 1]
        return xp

    # per-parity contiguous triplets: zebra half-sweeps run Thomas over
    # only that phase's lines (solve-all-then-mask did 2x the work)
    tri_ph = None
    if dlc is not None:
        tri_ph = tuple(
            (np.ascontiguousarray(dlc[ph::2]),
             np.ascontiguousarray(dmc[ph::2]),
             np.ascontiguousarray(duc[ph::2])) for ph in (0, 1))

    def solve_phase(R, ph):
        """Solution on phase-``ph`` lines, zeros elsewhere: (nlines, L)."""
        if tri_ph is not None and not np.iscomplexobj(R):
            from ..amg_core import thomas_lines_native

            dlp, dmp, dup = tri_ph[ph]
            Rp = np.array(R[ph::2], dtype=np.float64, order="C", copy=True)
            if thomas_lines_native(dlp, dmp, dup, Rp):
                out = np.zeros(R.shape, dtype=Rp.dtype)
                out[ph::2] = Rp
                return out
        xp = solve_lines(R)
        xp[parity != ph] = 0.0
        return xp

    return lines, unlines, solve_lines, parity, solve_phase


def line_gauss_seidel(A, x, b, iterations=1, sweep="symmetric", grid=None,
                      axis=None):
    """Alias of :func:`zebra` (even/odd line Gauss-Seidel)."""
    return zebra(A, x, b, iterations=iterations, sweep=sweep, grid=grid,
                 axis=axis)


def line_jacobi(A, x, b, iterations=1, grid=None, axis=None, omega=0.7):
    """Damped line Jacobi: all lines solved simultaneously from one
    residual (host twin of the device line_jacobi)."""
    A, x, b = make_system(A, x, b)
    if grid is None:
        grid = getattr(A, "grid", None)
    if grid is None or int(np.prod(grid)) != A.shape[0]:
        return jacobi(A, x, b, iterations=iterations, omega=omega)
    lines, unlines, solve_lines, _parity, _solve_phase = \
        _line_setup(A, grid, axis)
    for _ in range(iterations):
        dx = solve_lines(lines(b - A @ x))
        x += omega * unlines(dx)
    return x


def sor(A, x, b, omega, iterations=1, sweep="forward"):
    """Successive over-relaxation (reference relaxation.py:108):
    (D/omega + L) x_{k+1} = b - (U + (1-1/omega) D) x_k."""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    D = sp.dia_matrix((A.diagonal()[None, :], [0]), shape=A.shape).tocsr()
    from scipy.sparse.linalg import spsolve_triangular

    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            M = (sp.tril(A, -1) + D / omega).tocsr()
            r = b_v - A @ x_v
            x_v += spsolve_triangular(M, r, lower=True)
        if sweep in ("backward", "symmetric"):
            M = (sp.triu(A, 1) + D / omega).tocsr()
            r = b_v - A @ x_v
            x_v += spsolve_triangular(M, r, lower=False)
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(f"invalid sweep {sweep!r}")
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def jacobi(A, x, b, iterations=1, omega=1.0):
    """Weighted Jacobi (reference relaxation.py:357):
    x += omega D^{-1} (b - A x).

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu.gallery import poisson
    >>> from pyamg_tpu.relaxation.relaxation import jacobi
    >>> A = poisson((10, 10), format='csr')
    >>> b = np.ones(A.shape[0])
    >>> x = np.zeros(A.shape[0])
    >>> r0 = np.linalg.norm(b - A @ x)
    >>> _ = jacobi(A, x, b, iterations=5, omega=2.0 / 3.0)
    >>> bool(np.linalg.norm(b - A @ x) < r0)
    True
    """
    A, x_v, b_v = make_system(A, x, b)
    d = A.diagonal()
    mask = d != 0
    dinv = np.zeros_like(d)
    dinv[mask] = 1.0 / d[mask]
    for _ in range(iterations):
        x_v += omega * dinv * (b_v - A @ x_v)
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def polynomial(A, x, b, coefficients, iterations=1):
    """Polynomial smoother x += p(A) r with Horner evaluation; coefficients
    in descending order (reference relaxation.py:593)."""
    A, x_v, b_v = make_system(A, x, b)
    for _ in range(iterations):
        r = b_v - A @ x_v
        h = coefficients[0] * r
        for c in coefficients[1:]:
            h = c * r + A @ h
        x_v += h
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def block_jacobi(A, x, b, Dinv=None, blocksize=1, iterations=1, omega=1.0):
    """Block weighted Jacobi with batched block-diagonal inverse
    (reference relaxation.py:430)."""
    A, x_v, b_v = make_system(A, x, b)
    bs = int(blocksize)
    if Dinv is None:
        Dinv = get_block_diag(A, bs, inv_flag=True)
    n_blocks = A.shape[0] // bs
    for _ in range(iterations):
        r = (b_v - A @ x_v).reshape(n_blocks, bs)
        x_v += omega * np.einsum("nij,nj->ni", Dinv, r).reshape(-1)
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def block_gauss_seidel(A, x, b, Dinv=None, blocksize=1, iterations=1,
                       sweep="forward"):
    """Block Gauss-Seidel (reference relaxation.py:509).  Sequential over
    block rows; native C++ sweep (amg_core bsr_gauss_seidel role) with a
    pure-Python fallback for exotic dtypes."""
    from ..amg_core import bsr_gauss_seidel_native

    bs = int(blocksize)
    if bs == 1 and Dinv is None:
        # 1x1 "blocks" are exactly scalar GS — skip the BSR conversion and
        # the batched block-diag pinv a degenerate block path would pay
        return gauss_seidel(A, x, b, iterations=iterations, sweep=sweep)
    A, x_v, b_v = make_system(A, x, b)
    if Dinv is None:
        Dinv = get_block_diag(A, bs, inv_flag=True)
    Dinv = np.asarray(Dinv)
    B = sp.bsr_matrix(A, blocksize=(bs, bs))
    nb = B.shape[0] // bs
    indptr, indices, data = B.indptr, B.indices, B.data
    if sweep not in ("forward", "backward", "symmetric"):
        raise ValueError(f"invalid sweep {sweep!r}")

    if data.dtype == np.float64 and not np.iscomplexobj(data) \
            and Dinv.dtype == np.float64:
        xc = np.ascontiguousarray(x_v, dtype=np.float64)
        for _ in range(iterations):
            if sweep in ("forward", "symmetric"):
                if not bsr_gauss_seidel_native(indptr, indices, data, Dinv,
                                               xc, b_v, bs, 0, nb, 1):
                    break
            if sweep in ("backward", "symmetric"):
                if not bsr_gauss_seidel_native(indptr, indices, data, Dinv,
                                               xc, b_v, bs, nb - 1, -1, -1):
                    break
        else:
            np.asarray(x).reshape(-1)[:] = xc
            return x
        x_v = xc            # native unavailable: fall through to Python

    def fwd(order):
        xb = x_v.reshape(nb, bs)
        bb = b_v.reshape(nb, bs)
        for i in order:
            rhs = bb[i].copy()
            for jj in range(indptr[i], indptr[i + 1]):
                j = indices[jj]
                if j != i:
                    rhs -= data[jj] @ xb[j]
            # solve diag block: x_i = Dinv_i (rhs)  [rhs excludes diag term]
            xb[i] = Dinv[i] @ rhs

    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            fwd(range(nb))
        if sweep in ("backward", "symmetric"):
            fwd(range(nb - 1, -1, -1))
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def gauss_seidel_indexed(A, x, b, indices, iterations=1, sweep="forward"):
    """Gauss-Seidel restricted to (and ordered by) an index list
    (reference relaxation.py:671 → amg_core.gauss_seidel_indexed)."""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    indices = np.asarray(indices, dtype=np.int64)

    from ..amg_core import gauss_seidel_indexed_native

    if A.dtype == np.float64 and x_v.dtype == np.float64:
        done = True
        for _ in range(iterations):
            if sweep in ("forward", "symmetric"):
                done &= gauss_seidel_indexed_native(A, x_v, b_v, indices)
            if sweep in ("backward", "symmetric"):
                done &= gauss_seidel_indexed_native(A, x_v, b_v,
                                                    indices[::-1])
            if sweep not in ("forward", "backward", "symmetric"):
                raise ValueError(f"invalid sweep {sweep!r}")
        if done:
            np.asarray(x).reshape(-1)[:] = x_v
            return x

    indptr, cols, data = A.indptr, A.indices, A.data

    def one_pass(order):
        for i in order:
            s, e = indptr[i], indptr[i + 1]
            row_cols = cols[s:e]
            row_data = data[s:e]
            diag = 0.0
            rsum = 0.0
            for k in range(e - s):
                j = row_cols[k]
                if j == i:
                    diag = row_data[k]
                else:
                    rsum += row_data[k] * x_v[j]
            if diag != 0:
                x_v[i] = (b_v[i] - rsum) / diag

    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            one_pass(indices)
        if sweep in ("backward", "symmetric"):
            one_pass(indices[::-1])
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(f"invalid sweep {sweep!r}")
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def jacobi_ne(A, x, b, iterations=1, omega=1.0):
    """Jacobi on the normal equations A^H A x = A^H b
    (reference relaxation.py:744): x += omega D(A^HA)^{-1} A^H (b - A x)."""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    d = np.asarray(A.multiply(A.conjugate()).sum(axis=0)).ravel().real
    mask = d != 0
    dinv = np.zeros(A.shape[1])
    dinv[mask] = 1.0 / d[mask]
    for _ in range(iterations):
        r = b_v - A @ x_v
        x_v += omega * dinv * (A.conjugate().T @ r)
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def gauss_seidel_ne(A, x, b, iterations=1, sweep="forward", omega=1.0):
    """Kaczmarz / Gauss-Seidel on A A^H (reference relaxation.py:823):
    sequential row projections."""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()

    from ..amg_core import gauss_seidel_kaczmarz_native

    if (A.dtype == np.float64 and x_v.dtype == np.float64
            and sweep == "forward"):
        ok = True
        for _ in range(iterations):
            ok &= gauss_seidel_kaczmarz_native(A, x_v, b_v, omega)
        if ok:
            np.asarray(x).reshape(-1)[:] = x_v
            return x

    indptr, cols, data = A.indptr, A.indices, A.data
    row_norms = np.asarray(A.multiply(A.conjugate()).sum(axis=1)).ravel().real

    def one_pass(order):
        for i in order:
            if row_norms[i] == 0:
                continue
            s, e = indptr[i], indptr[i + 1]
            ri = b_v[i] - data[s:e] @ x_v[cols[s:e]]
            x_v[cols[s:e]] += omega * (ri / row_norms[i]) * \
                data[s:e].conjugate()

    n = A.shape[0]
    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            one_pass(range(n))
        if sweep in ("backward", "symmetric"):
            one_pass(range(n - 1, -1, -1))
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(f"invalid sweep {sweep!r}")
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def gauss_seidel_nr(A, x, b, iterations=1, sweep="forward", omega=1.0):
    """Gauss-Seidel on the normal equations A^H A
    (reference relaxation.py:912): sequential column updates."""
    A, x_v, b_v = make_system(A, x, b)
    Ac = A.tocsc()
    indptr, rows, data = Ac.indptr, Ac.indices, Ac.data
    col_norms = np.asarray(A.multiply(A.conjugate()).sum(axis=0)).ravel().real
    r = b_v - A @ x_v

    def one_pass(order):
        nonlocal r
        for j in order:
            if col_norms[j] == 0:
                continue
            s, e = indptr[j], indptr[j + 1]
            delta = omega * (data[s:e].conjugate() @ r[rows[s:e]]) / col_norms[j]
            x_v[j] += delta
            r[rows[s:e]] -= delta * data[s:e]

    n = A.shape[1]
    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            one_pass(range(n))
        if sweep in ("backward", "symmetric"):
            one_pass(range(n - 1, -1, -1))
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(f"invalid sweep {sweep!r}")
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def schwarz_parameters(A, subdomain=None, subdomain_ptr=None,
                       inv_subblock=None, inv_subblock_ptr=None):
    """Compute overlapping-Schwarz subdomains (row + its neighbors) and the
    inverses of the corresponding dense subblocks
    (reference relaxation.py:1011 → amg_core extract_subblocks)."""
    A = to_csr(A)
    n = A.shape[0]
    if subdomain is None or subdomain_ptr is None:
        # default: each node's subdomain = its strength-of-adjacency stencil
        subdomain_ptr = A.indptr.copy()
        subdomain = A.indices.copy()
    if inv_subblock is None or inv_subblock_ptr is None:
        inv_subblock_ptr = np.zeros(n + 1, dtype=np.int64)
        sizes = np.diff(subdomain_ptr)
        inv_subblock_ptr[1:] = np.cumsum(sizes ** 2)
        inv_subblock = np.zeros(int(inv_subblock_ptr[-1]), dtype=A.dtype)
        Ad = A.tocsr()
        for i in range(n):
            idx = subdomain[subdomain_ptr[i]:subdomain_ptr[i + 1]]
            block = Ad[np.ix_(idx, idx)].toarray()
            inv_subblock[inv_subblock_ptr[i]:inv_subblock_ptr[i + 1]] = \
                np.linalg.pinv(block).ravel()
    return subdomain, subdomain_ptr, inv_subblock, inv_subblock_ptr


def schwarz(A, x, b, iterations=1, subdomain=None, subdomain_ptr=None,
            inv_subblock=None, inv_subblock_ptr=None, sweep="forward"):
    """Multiplicative overlapping Schwarz (reference relaxation.py:172 →
    amg_core.overlapping_schwarz_csr)."""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    subdomain, subdomain_ptr, inv_subblock, inv_subblock_ptr = \
        schwarz_parameters(A, subdomain, subdomain_ptr, inv_subblock,
                           inv_subblock_ptr)
    n_dom = subdomain_ptr.shape[0] - 1

    def one_pass(order):
        for i in order:
            idx = subdomain[subdomain_ptr[i]:subdomain_ptr[i + 1]]
            m = idx.size
            Binv = inv_subblock[inv_subblock_ptr[i]:
                                inv_subblock_ptr[i + 1]].reshape(m, m)
            r = b_v[idx] - A[idx] @ x_v
            x_v[idx] += Binv @ r

    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            one_pass(range(n_dom))
        if sweep in ("backward", "symmetric"):
            one_pass(range(n_dom - 1, -1, -1))
        if sweep not in ("forward", "backward", "symmetric"):
            raise ValueError(f"invalid sweep {sweep!r}")
    np.asarray(x).reshape(-1)[:] = x_v
    return x
