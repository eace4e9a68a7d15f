"""Device-side (jit-compiled) smoother kernels over padded-ELL operators.

This is the device execution path for the smoother menu of
pyamg/relaxation/relaxation.py.  Design (SURVEY.md §7.2): sequential
Gauss-Seidel is hostile to SIMD, so the device family is

* weighted Jacobi                       (≙ relaxation.h:202 ``jacobi``)
* multicolor Gauss-Seidel               (≙ relaxation.h:34, reformulated via
  graph coloring — same smoothing semantics, parallel execution; colors come
  from the Jones-Plassmann coloring the reference already ships, graph.h:243)
* polynomial / Chebyshev (Horner)       (≙ relaxation.py:593 ``polynomial``)
* block Jacobi with batched block pinv  (≙ relaxation.h:662 + linalg.h:889)
* Jacobi on the normal equations        (≙ relaxation.h:466 ``jacobi_ne``)
* additive overlapping Schwarz          (≙ relaxation.h:936, damped-additive
  variant for parallel execution)

Every function is pure (x in, x out) and traceable; smoother *state*
(inverted diagonals, color masks, coefficients) is precomputed at setup into
:class:`SmootherData`, a pytree the compiled cycle closes over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..sparse import SparseELL

# f32 contractions with a free (non-contracting) dimension pin full
# precision: a GPU may run such a dot as a TF32 GEMM at DEFAULT.  A
# vector-vector dot (jnp.vdot) needs no pin: XLA's GPU compiler turns it
# into a multiply and a reduction, which keep f32.
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class SmootherData:
    """Precomputed smoother state attached to a hierarchy level."""

    kind: str = "jacobi"                 # static
    iterations: int = 1                  # static
    sweep: str = "forward"               # static
    omega: float = 1.0                   # static scalar (baked into jaxpr)
    dinv: Optional[jnp.ndarray] = None           # (n,) inverted diagonal
    color_masks: Optional[jnp.ndarray] = None    # (ncolors, n) float masks
    coefficients: Tuple[float, ...] = ()         # static, descending order
    block_dinv: Optional[jnp.ndarray] = None     # (nb, bs, bs)
    blocksize: int = 1                   # static
    AT: Optional[SparseELL] = None       # transpose, for NE/NR smoothers
    dinv_ne: Optional[jnp.ndarray] = None
    subdomain_idx: Optional[jnp.ndarray] = None     # (n_dom, L) int32, -1 pad
    subdomain_inv: Optional[jnp.ndarray] = None     # (n_dom, L, L)
    line_tri: Optional[jnp.ndarray] = None   # (3, nlines, L) dl/d/du;
    # blocked levels: (3, q, q, nlines, L) component layout
    grid: Tuple[int, ...] = ()               # static, for line smoothers
    line_axis: int = -1                      # static
    color_rows: Optional[jnp.ndarray] = None  # (C, R) int32, -1 padded
    color_cols: Optional[jnp.ndarray] = None  # (C, R, W) int32
    color_data: Optional[jnp.ndarray] = None  # (C, R, W)

    def tree_flatten(self):
        children = (self.dinv, self.color_masks, self.block_dinv, self.AT,
                    self.dinv_ne, self.subdomain_idx, self.subdomain_inv,
                    self.line_tri, self.color_rows, self.color_cols,
                    self.color_data)
        aux = (self.kind, self.iterations, self.sweep, self.omega,
               self.coefficients, self.blocksize, self.grid, self.line_axis)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        (dinv, color_masks, block_dinv, AT, dinv_ne, subdomain_idx,
         subdomain_inv, line_tri, color_rows, color_cols,
         color_data) = children
        (kind, iterations, sweep, omega, coefficients, blocksize, grid,
         line_axis) = aux
        return cls(kind=kind, iterations=iterations, sweep=sweep, omega=omega,
                   dinv=dinv, color_masks=color_masks,
                   coefficients=coefficients, block_dinv=block_dinv,
                   blocksize=blocksize, AT=AT, dinv_ne=dinv_ne,
                   subdomain_idx=subdomain_idx, subdomain_inv=subdomain_inv,
                   line_tri=line_tri, grid=grid, line_axis=line_axis,
                   color_rows=color_rows, color_cols=color_cols,
                   color_data=color_data)

    def astype(self, dtype):
        cast = lambda a: None if a is None else a.astype(dtype)  # noqa: E731
        return SmootherData(
            kind=self.kind, iterations=self.iterations, sweep=self.sweep,
            omega=self.omega, dinv=cast(self.dinv),
            color_masks=cast(self.color_masks),
            coefficients=self.coefficients,
            block_dinv=cast(self.block_dinv), blocksize=self.blocksize,
            AT=None if self.AT is None else self.AT.astype(dtype),
            dinv_ne=cast(self.dinv_ne),
            subdomain_idx=self.subdomain_idx,    # indices stay integer
            subdomain_inv=cast(self.subdomain_inv),
            line_tri=cast(self.line_tri), grid=self.grid,
            line_axis=self.line_axis,
            color_rows=self.color_rows, color_cols=self.color_cols,
            color_data=cast(self.color_data))


# ---------------------------------------------------------------------------
# individual smoother steps (pure functions)
# ---------------------------------------------------------------------------

def jacobi_step(A: SparseELL, dinv, x, b, omega=1.0):
    """x + omega * D^{-1} (b - A x)."""
    return x + omega * dinv * (b - A.matvec(x))


def richardson_step(A: SparseELL, x, b, omega=1.0):
    return x + omega * (b - A.matvec(x))


def multicolor_gs_step(A: SparseELL, dinv, color_masks, x, b, reverse=False):
    """One multicolor Gauss-Seidel sweep.

    Per color c (in order): x |= x + mask_c * D^{-1} (b - A x).  Within a
    color no two nodes are adjacent, so the update equals a true Gauss-Seidel
    step under the color ordering.  The color loop is a ``fori_loop`` so the
    compiled program stays small regardless of the number of colors.
    """
    ncolors = color_masks.shape[0]

    def body(c, x):
        idx = ncolors - 1 - c if reverse else c
        r = b - A.matvec(x)
        return x + color_masks[idx] * dinv * r

    return jax.lax.fori_loop(0, ncolors, body, x)


def multicolor_gs_gather_step(sm: "SmootherData", x, b, reverse=False):
    """One multicolor Gauss-Seidel sweep in gather form: per color, gather
    only that color's rows (padded (C, R, W) arrays) and update them.

    Equivalent iteration to :func:`multicolor_gs_step` under the same
    coloring, but the whole sweep touches each matrix row exactly once —
    one matvec-equivalent total instead of one FULL matvec per color
    (decisive on gather-bound ELL levels with dozens of colors)."""
    C = sm.color_rows.shape[0]

    def body(c, x):
        idx = C - 1 - c if reverse else c
        rows = sm.color_rows[idx]                    # (R,)
        valid = (rows >= 0).astype(x.dtype)
        safe = jnp.maximum(rows, 0)
        Ax = jnp.einsum("rw,rw->r", sm.color_data[idx],
                        x[sm.color_cols[idx]], precision=_HIGHEST)
        r = b[safe] - Ax
        upd = valid * sm.dinv[safe] * r
        return x.at[safe].add(upd)

    return jax.lax.fori_loop(0, C, body, x)


def polynomial_step(A: SparseELL, coefficients, x, b):
    """x + p(A) r by Horner; coefficients descending (≙ relaxation.py:593)."""
    r = b - A.matvec(x)
    h = coefficients[0] * r
    for c in coefficients[1:]:
        h = c * r + A.matvec(h)
    return x + h


def block_jacobi_step(A: SparseELL, block_dinv, x, b, omega=1.0):
    """x + omega * blockdiag(D)^{-1} (b - A x), batched over blocks."""
    bs = block_dinv.shape[-1]
    r = (b - A.matvec(x)).reshape(-1, bs)
    dx = jnp.einsum("nij,nj->ni", block_dinv, r,
                    precision=_HIGHEST).reshape(-1)
    return x + omega * dx


def batched_tridiag_pcr(dl, d, du, B):
    """Batched tridiagonal solve by parallel cyclic reduction.

    dl/d/du/B: (nlines, L).  log2(L) fully-vectorized elimination rounds —
    the data-parallel replacement for per-line Thomas sweeps.  Out-of-range
    neighbors are identity rows via zero-padding.
    """
    L = d.shape[-1]

    def shift(a, s):
        # a[..., i + s] with zero fill
        if s == 0:
            return a
        if s > 0:
            return jnp.concatenate(
                [a[..., s:], jnp.zeros(a.shape[:-1] + (s,), a.dtype)], -1)
        return jnp.concatenate(
            [jnp.zeros(a.shape[:-1] + (-s,), a.dtype), a[..., :s]], -1)

    def shift_d(a, s):
        # like shift but fills with 1 (identity diagonal)
        if s == 0:
            return a
        if s > 0:
            return jnp.concatenate(
                [a[..., s:], jnp.ones(a.shape[:-1] + (s,), a.dtype)], -1)
        return jnp.concatenate(
            [jnp.ones(a.shape[:-1] + (-s,), a.dtype), a[..., :s]], -1)

    s = 1
    while s < L:
        dm = shift_d(d, -s)
        dp = shift_d(d, s)
        alpha = -dl / dm
        beta = -du / dp
        d = d + alpha * shift(du, -s) + beta * shift(dl, s)
        B = B + alpha * shift(B, -s) + beta * shift(B, s)
        dl = alpha * shift(dl, -s)
        du = beta * shift(du, s)
        s *= 2
    return B / d


def _binv_small(M):
    """Batched inverse of tiny q x q blocks in CLOSED FORM (adjugate).

    ``M`` is in component layout (q, q, ...): block indices LEADING, the
    large batch axes trailing.  ``jnp.linalg.solve`` on (batch, 2, 2)
    lowers to a pivoted LU kernel with a serial loop per block, slow
    inside the block-PCR rounds.  The adjugate form is pure elementwise
    work.
    q >= 4 falls back to linalg.inv on a transposed view."""
    q = M.shape[0]
    if q == 1:
        return 1.0 / M
    if q == 2:
        a, b = M[0, 0], M[0, 1]
        c, d = M[1, 0], M[1, 1]
        det = a * d - b * c
        r = jnp.stack([jnp.stack([d, -b]), jnp.stack([-c, a])])
        return r / det
    if q == 3:
        m = [[M[i, j] for j in range(3)] for i in range(3)]

        def cof(i1, i2, j1, j2):
            return m[i1][j1] * m[i2][j2] - m[i1][j2] * m[i2][j1]

        c00 = cof(1, 2, 1, 2)
        c01 = -cof(1, 2, 0, 2)
        c02 = cof(1, 2, 0, 1)
        c10 = -cof(0, 2, 1, 2)
        c11 = cof(0, 2, 0, 2)
        c12 = -cof(0, 2, 0, 1)
        c20 = cof(0, 1, 1, 2)
        c21 = -cof(0, 1, 0, 2)
        c22 = cof(0, 1, 0, 1)
        det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02
        adjT = jnp.stack([jnp.stack([c00, c10, c20]),
                          jnp.stack([c01, c11, c21]),
                          jnp.stack([c02, c12, c22])])
        return adjT / det
    # rare: move block axes trailing for the LAPACK-style path
    Mt = jnp.moveaxis(M, (0, 1), (-2, -1))
    return jnp.moveaxis(jnp.linalg.inv(Mt), (-2, -1), (0, 1))


def batched_block_tridiag_pcr(dl, d, du, B):
    """Batched BLOCK-tridiagonal solve by parallel cyclic reduction.

    COMPONENT LAYOUT: dl/d/du are (q, q, nlines, L) node blocks and B is
    (q, nlines, L) — the tiny q x q block indices lead and the large
    (nlines, L) plane trails.  A layout whose minor dimensions are the
    tiny (2, 2) blocks pads badly on a compiler that tiles the two minor
    axes; in this layout any tiling applies to (nlines, L) and padding is
    negligible; all block algebra is unrolled elementwise work over full
    planes.

    Same log2(L) elimination rounds as the scalar kernel with q x q block
    algebra — the q-dof-per-node levels of a K-candidate structured
    hierarchy stay exactly line-solvable.  Out-of-range neighbors are
    identity blocks / zero blocks via padding.  Block inverses use the
    closed adjugate form (see :func:`_binv_small`).
    """
    L = d.shape[-1]
    q = d.shape[0]
    eye_col = jnp.eye(q, dtype=d.dtype)[:, :, None, None]

    def shift(a, s, fill_eye=False):
        if s == 0:
            return a
        pad_shape = a.shape[:-1] + (abs(s),)
        if fill_eye:
            pad = jnp.broadcast_to(eye_col, pad_shape)
        else:
            pad = jnp.zeros(pad_shape, a.dtype)
        if s > 0:
            return jnp.concatenate([a[..., s:], pad], axis=-1)
        return jnp.concatenate([pad, a[..., :s]], axis=-1)

    # The block contractions are UNROLLED into explicit elementwise
    # multiply-adds: an einsum here lowers to dot_general, which a matrix
    # unit may evaluate with reduced operand precision at DEFAULT precision
    # (bf16 or TF32) — the cyclic reduction relies on exact f32
    # cancellation of the eliminated couplings, and such rounding compounds
    # over the log2(L) rounds into a completely wrong solve.
    def bmm(X, Y):
        return jnp.stack([
            jnp.stack([
                sum(X[i, j] * Y[j, k] for j in range(q))
                for k in range(q)])
            for i in range(q)])

    def bmv(X, v):
        return jnp.stack([
            sum(X[i, j] * v[j] for j in range(q)) for i in range(q)])

    s = 1
    while s < L:
        dm_inv = _binv_small(shift(d, -s, fill_eye=True))
        dp_inv = _binv_small(shift(d, s, fill_eye=True))
        alpha = -bmm(dl, dm_inv)
        beta = -bmm(du, dp_inv)
        d = d + bmm(alpha, shift(du, -s)) + bmm(beta, shift(dl, s))
        B = B + bmv(alpha, shift(B, -s)) + bmv(beta, shift(B, s))
        dl = bmm(alpha, shift(dl, -s))
        du = bmm(beta, shift(du, s))
        s *= 2
    return bmv(_binv_small(d), B)


def line_relaxation_step(A, sm: "SmootherData", x, b, zebra_phase=None):
    """Damped line-Jacobi (or one zebra half-sweep): exact tridiagonal
    solves along the ``line_axis`` grid direction.

    The data-parallel counterpart of line/block Gauss-Seidel for anisotropic
    problems: all lines solve simultaneously via cyclic reduction.  A 5-D
    ``line_tri`` marks a node-blocked level (q dofs per grid node): lines
    are block-tridiagonal and solve via the block kernel.
    ``zebra_phase``: None = all lines (line Jacobi), 0/1 = even/odd lines
    only (zebra line Gauss-Seidel).
    """
    grid = sm.grid
    axis = sm.line_axis % len(grid)
    r = b - A.matvec(x)
    dl, d, du = sm.line_tri[0], sm.line_tri[1], sm.line_tri[2]
    if sm.line_tri.ndim == 5:
        # blocked level: line_tri is (3, q, q, nlines, L) component layout
        q = sm.line_tri.shape[1]
        L = d.shape[-1]
        Rg = r.reshape(tuple(grid) + (q,))
        Rg = jnp.moveaxis(Rg, axis, len(grid) - 1)
        lead_shape = Rg.shape[:-2]
        R2 = jnp.moveaxis(Rg.reshape(-1, L, q), -1, 0)     # (q, nlines, L)
        dx = batched_block_tridiag_pcr(dl, d, du, R2)
        if zebra_phase is not None:
            mask = (jnp.arange(dx.shape[1]) % 2 == zebra_phase)
            dx = dx * mask[None, :, None].astype(dx.dtype)
        dxg = jnp.moveaxis(jnp.moveaxis(dx, 0, -1).reshape(
            lead_shape + (L, q)), len(grid) - 1, axis)
        return x + sm.omega * dxg.reshape(-1)
    Rg = r.reshape(grid)
    Rg = jnp.moveaxis(Rg, axis, -1)
    lead_shape = Rg.shape[:-1]
    L = Rg.shape[-1]
    R2 = Rg.reshape(-1, L)
    dx = batched_tridiag_pcr(dl, d, du, R2)
    if zebra_phase is not None:
        nlines = dx.shape[0]
        mask = (jnp.arange(nlines) % 2 == zebra_phase)
        dx = dx * mask[:, None].astype(dx.dtype)
    dxg = jnp.moveaxis(dx.reshape(lead_shape + (L,)), -1, axis)
    return x + sm.omega * dxg.reshape(-1)


def schwarz_step(A, subdomain_idx, subdomain_inv, x, b, omega=1.0):
    """Weighted (partition-of-unity) additive overlapping Schwarz — the
    parallel counterpart of the reference's multiplicative sweep
    (relaxation.h:936), with each dof's correction averaged over the
    subdomains containing it (restricted-additive-Schwarz weighting, which
    keeps the additive iteration contractive).

    Batched dense subdomain solves + one gather/scatter pair.
    """
    r = b - A.matvec(x)
    safe = jnp.maximum(subdomain_idx, 0)
    valid = (subdomain_idx >= 0).astype(r.dtype)
    r_loc = r[safe] * valid                                 # (n_dom, L)
    dx_loc = jnp.einsum("dij,dj->di", subdomain_inv, r_loc,
                        precision=_HIGHEST) * valid
    dx = jnp.zeros_like(x).at[safe.reshape(-1)].add(
        (dx_loc * valid).reshape(-1))
    count = jnp.zeros_like(x).at[safe.reshape(-1)].add(valid.reshape(-1))
    dx = dx / jnp.maximum(count, 1)
    return x + omega * dx


def krylov_smoother_step(A, x, b, kind="cg", iterations=2):
    """Fixed-iteration Krylov smoothing (reference smoothing.py:481-509
    setup_cg/setup_gmres), fully traced (no convergence test)."""
    if kind in ("gmres", "gmres_smoother"):
        return _gmres_smoother_step(A, x, b, k=max(iterations, 1))
    r = b - A.matvec(x)
    p = r
    rz = jnp.vdot(r, r)
    for _ in range(iterations):
        Ap = A.matvec(p)
        d = jnp.vdot(p, Ap)
        alpha = rz / jnp.where(d == 0, 1, d)
        x = x + alpha * p
        r = r - alpha * Ap
        rz_new = jnp.vdot(r, r)
        beta = rz_new / jnp.where(rz == 0, 1, rz)
        p = r + beta * p
        rz = rz_new
    return x


def _gmres_smoother_step(A, x, b, k=2):
    """k-step unrestarted GMRES from the current iterate, fully unrolled
    (k is small and static): minimizes ||b - A(x + Vy)|| over the k-dim
    Krylov space — suitable for nonsymmetric smoothing."""
    r = b - A.matvec(x)
    beta = jnp.linalg.norm(r)
    safe = jnp.where(beta == 0, 1, beta)
    V = [r / safe]
    H = jnp.zeros((k + 1, k), dtype=r.dtype)
    for j in range(k):
        w = A.matvec(V[j])
        for i in range(j + 1):
            hij = jnp.vdot(V[i], w)
            H = H.at[i, j].set(hij)
            w = w - hij * V[i]
        hn = jnp.linalg.norm(w)
        H = H.at[j + 1, j].set(hn)
        V.append(w / jnp.where(hn == 0, 1, hn))
    e1 = jnp.zeros(k + 1, dtype=r.dtype).at[0].set(beta)
    y, *_ = jnp.linalg.lstsq(H, e1)
    Vm = jnp.stack(V[:k])                  # (k, n)
    return x + jnp.matmul(Vm.T, y, precision=_HIGHEST)


def jacobi_ne_step(A: SparseELL, AT: SparseELL, dinv_ne, x, b, omega=1.0):
    """Jacobi on the normal equations A A^H (Cimmino / parallel Kaczmarz):
    x + omega A^H diag(A A^H)^{-1} (b - Ax)   (≙ relaxation.h:466).

    ``AT`` is A^H; ``dinv_ne`` holds the inverted *row* 2-norms of A.
    """
    r = b - A.matvec(x)
    return x + omega * AT.matvec(dinv_ne * r)


def jacobi_nr_step(A: SparseELL, AT: SparseELL, dinv_ne, x, b, omega=1.0):
    """Jacobi on the normal residual equations A^H A:
    x + omega diag(A^H A)^{-1} A^H (b - Ax)   (≙ relaxation.h:595 semantics).

    ``dinv_ne`` holds the inverted *column* 2-norms of A.
    """
    r = b - A.matvec(x)
    return x + omega * dinv_ne * AT.matvec(r)


def cgnr_smoother_step(A, AT, x, b, iterations=2):
    """Fixed-depth CG on the normal equations A^H A x = A^H b — the genuine
    CGNR smoother (reference smoothing.py:481-509 setup_cgnr), fully traced.
    Correct for nonsymmetric/complex A (unlike plain CG steps)."""
    r = b - A.matvec(x)
    z = AT.matvec(r)                     # normal-equation residual
    p = z
    zz = jnp.vdot(z, z)
    for _ in range(max(iterations, 1)):
        Ap = A.matvec(p)
        d = jnp.vdot(Ap, Ap)
        alpha = zz / jnp.where(d == 0, 1, d)
        x = x + alpha * p
        r = r - alpha * Ap
        z = AT.matvec(r)
        zz_new = jnp.vdot(z, z)
        beta = zz_new / jnp.where(zz == 0, 1, zz)
        p = z + beta * p
        zz = zz_new
    return x


def cgne_smoother_step(A, AT, x, b, iterations=2):
    """Fixed-depth CGNE (Craig's method): CG on A A^H y = b with x = A^H y,
    minimizing the error norm — the genuine CGNE smoother
    (reference smoothing.py:481-509 setup_cgne), fully traced."""
    r = b - A.matvec(x)
    p = AT.matvec(r)
    rr = jnp.vdot(r, r)
    for _ in range(max(iterations, 1)):
        d = jnp.vdot(p, p)
        alpha = rr / jnp.where(d == 0, 1, d)
        x = x + alpha * p
        r = r - alpha * A.matvec(p)
        rr_new = jnp.vdot(r, r)
        beta = rr_new / jnp.where(rr == 0, 1, rr)
        p = AT.matvec(r) + beta * p
        rr = rr_new
    return x


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def apply_smoother(sm: SmootherData, A: SparseELL, x, b):
    """Apply ``sm.iterations`` sweeps of the configured smoother (traced)."""
    if sm is None or sm.kind in ("none", None):
        return x
    for _ in range(sm.iterations):
        if sm.kind == "jacobi":
            x = jacobi_step(A, sm.dinv, x, b, sm.omega)
        elif sm.kind == "richardson":
            x = richardson_step(A, x, b, sm.omega)
        elif sm.kind in ("gauss_seidel", "multicolor_gauss_seidel"):
            if sm.color_rows is not None:
                if sm.sweep in ("forward", "symmetric"):
                    x = multicolor_gs_gather_step(sm, x, b)
                if sm.sweep in ("backward", "symmetric"):
                    x = multicolor_gs_gather_step(sm, x, b, reverse=True)
            else:
                if sm.sweep in ("forward", "symmetric"):
                    x = multicolor_gs_step(A, sm.dinv, sm.color_masks, x, b)
                if sm.sweep in ("backward", "symmetric"):
                    x = multicolor_gs_step(A, sm.dinv, sm.color_masks, x, b,
                                           reverse=True)
        elif sm.kind in ("polynomial", "chebyshev"):
            x = polynomial_step(A, sm.coefficients, x, b)
        elif sm.kind == "block_jacobi":
            x = block_jacobi_step(A, sm.block_dinv, x, b, sm.omega)
        elif sm.kind in ("block_gauss_seidel", "multicolor_block_gauss_seidel"):
            # multicolor over block graph: masks are block-expanded
            if sm.sweep in ("forward", "symmetric"):
                x = _multicolor_block_gs(A, sm, x, b, reverse=False)
            if sm.sweep in ("backward", "symmetric"):
                x = _multicolor_block_gs(A, sm, x, b, reverse=True)
        elif sm.kind == "jacobi_ne":
            x = jacobi_ne_step(A, sm.AT, sm.dinv_ne, x, b, sm.omega)
        elif sm.kind == "jacobi_nr":
            x = jacobi_nr_step(A, sm.AT, sm.dinv_ne, x, b, sm.omega)
        elif sm.kind == "schwarz":
            x = schwarz_step(A, sm.subdomain_idx, sm.subdomain_inv, x, b,
                             sm.omega)
        elif sm.kind == "line_jacobi":
            x = line_relaxation_step(A, sm, x, b)
        elif sm.kind in ("zebra", "line_gauss_seidel"):
            order = (1, 0) if sm.sweep == "backward" else (0, 1)
            for ph in order:
                x = line_relaxation_step(A, sm, x, b, zebra_phase=ph)
            if sm.sweep == "symmetric":
                for ph in (1, 0):
                    x = line_relaxation_step(A, sm, x, b, zebra_phase=ph)
        elif sm.kind in ("cg_smoother", "gmres_smoother"):
            # fixed Krylov depth 2 per application; sm.iterations controls
            # the number of applications (outer loop)
            x = krylov_smoother_step(
                A, x, b,
                kind="gmres" if sm.kind == "gmres_smoother" else "cg",
                iterations=2)
        elif sm.kind == "cgnr_smoother":
            x = cgnr_smoother_step(A, sm.AT, x, b, iterations=2)
        elif sm.kind == "cgne_smoother":
            x = cgne_smoother_step(A, sm.AT, x, b, iterations=2)
        elif sm.kind == "sor":
            # device SOR = multicolor GS with over-relaxation weight
            if sm.sweep in ("forward", "symmetric"):
                x = _multicolor_sor(A, sm, x, b, reverse=False)
            if sm.sweep in ("backward", "symmetric"):
                x = _multicolor_sor(A, sm, x, b, reverse=True)
        else:
            raise ValueError(f"unknown device smoother kind {sm.kind!r}")
    return x


def _multicolor_sor(A, sm, x, b, reverse):
    ncolors = sm.color_masks.shape[0]

    def body(c, x):
        idx = ncolors - 1 - c if reverse else c
        r = b - A.matvec(x)
        return x + sm.omega * sm.color_masks[idx] * sm.dinv * r

    return jax.lax.fori_loop(0, ncolors, body, x)


def _multicolor_block_gs(A, sm, x, b, reverse):
    bs = sm.block_dinv.shape[-1]
    ncolors = sm.color_masks.shape[0]

    def body(c, x):
        idx = ncolors - 1 - c if reverse else c
        r = (b - A.matvec(x)).reshape(-1, bs)
        dx = jnp.einsum("nij,nj->ni", sm.block_dinv, r,
                        precision=_HIGHEST).reshape(-1)
        return x + sm.color_masks[idx] * dx

    return jax.lax.fori_loop(0, ncolors, body, x)
