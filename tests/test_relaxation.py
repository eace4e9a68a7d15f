"""Relaxation tests: host smoothers vs dense gold references, and device
smoothers vs host counterparts (SURVEY.md §4.1 oracle style)."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.linalg import solve

import jax.numpy as jnp

from pyamg_tpu.gallery import poisson, sprand
from pyamg_tpu.relaxation import relaxation as rel
from pyamg_tpu.relaxation.device import (SmootherData, apply_smoother,
                                         jacobi_step, multicolor_gs_step,
                                         polynomial_step, block_jacobi_step)
from pyamg_tpu.relaxation.smoothing import make_smoother_data
from pyamg_tpu.sparse import SparseELL


def rng():
    return np.random.default_rng(0)


class TestHostGoldReference:
    """Dense gold references, mirroring the reference's test style
    (relaxation/tests/test_relaxation.py:243-289)."""

    def _system(self, n=24):
        A = poisson((n,), format="csr")
        x = rng().standard_normal(n)
        b = rng().standard_normal(n)
        return A, x, b

    def test_gauss_seidel_forward(self):
        A, x, b = self._system()
        Ad = A.toarray()
        L = np.tril(Ad)
        U = np.triu(Ad, 1)
        expected = solve(L, b - U @ x)
        got = x.copy()
        rel.gauss_seidel(A, got, b, iterations=1, sweep="forward")
        assert np.allclose(got, expected, atol=1e-12)

    def test_gauss_seidel_backward(self):
        A, x, b = self._system()
        Ad = A.toarray()
        U = np.triu(Ad)
        L = np.tril(Ad, -1)
        expected = solve(U, b - L @ x)
        got = x.copy()
        rel.gauss_seidel(A, got, b, iterations=1, sweep="backward")
        assert np.allclose(got, expected, atol=1e-12)

    def test_jacobi(self):
        A, x, b = self._system()
        D = A.diagonal()
        expected = x + (2.0 / 3.0) * (b - A @ x) / D
        got = x.copy()
        rel.jacobi(A, got, b, iterations=1, omega=2.0 / 3.0)
        assert np.allclose(got, expected, atol=1e-12)

    def test_sor_equals_gs_at_omega_1(self):
        A, x, b = self._system()
        g1 = x.copy()
        rel.gauss_seidel(A, g1, b, iterations=2)
        g2 = x.copy()
        rel.sor(A, g2, b, omega=1.0, iterations=2)
        assert np.allclose(g1, g2, atol=1e-12)

    def test_polynomial_richardson(self):
        A, x, b = self._system()
        expected = x + 0.5 * (b - A @ x)
        got = x.copy()
        rel.polynomial(A, got, b, coefficients=[0.5], iterations=1)
        assert np.allclose(got, expected, atol=1e-12)

    def test_block_jacobi_equals_jacobi_bs1(self):
        A, x, b = self._system()
        g1 = x.copy()
        rel.jacobi(A, g1, b, iterations=2, omega=1.0)
        g2 = x.copy()
        rel.block_jacobi(A, g2, b, blocksize=1, iterations=2, omega=1.0)
        assert np.allclose(g1, g2, atol=1e-12)

    def test_block_gauss_seidel_equals_gs_bs1(self):
        A, x, b = self._system()
        g1 = x.copy()
        rel.gauss_seidel(A, g1, b, iterations=1)
        g2 = x.copy()
        rel.block_gauss_seidel(A, g2, b, blocksize=1, iterations=1)
        assert np.allclose(g1, g2, atol=1e-10)

    def test_gauss_seidel_indexed_full_equals_gs(self):
        A, x, b = self._system()
        g1 = x.copy()
        rel.gauss_seidel(A, g1, b, iterations=1)
        g2 = x.copy()
        rel.gauss_seidel_indexed(A, g2, b, indices=np.arange(A.shape[0]),
                                 iterations=1)
        assert np.allclose(g1, g2, atol=1e-12)

    def test_jacobi_ne_reduces_residual(self):
        A = poisson((15, 15), format="csr")
        x = rng().standard_normal(A.shape[0])
        b = rng().standard_normal(A.shape[0])
        r0 = np.linalg.norm(b - A @ x)
        rel.jacobi_ne(A, x, b, iterations=10, omega=0.3)
        assert np.linalg.norm(b - A @ x) < r0

    def test_gauss_seidel_ne_nr_reduce_residual(self):
        A = poisson((12, 12), format="csr")
        b = rng().standard_normal(A.shape[0])
        for fn in (rel.gauss_seidel_ne, rel.gauss_seidel_nr):
            x = rng().standard_normal(A.shape[0])
            r0 = np.linalg.norm(b - A @ x)
            fn(A, x, b, iterations=5)
            assert np.linalg.norm(b - A @ x) < 0.9 * r0

    def test_schwarz_reduces_residual(self):
        A = poisson((10, 10), format="csr")
        x = rng().standard_normal(A.shape[0])
        b = rng().standard_normal(A.shape[0])
        r0 = np.linalg.norm(b - A @ x)
        rel.schwarz(A, x, b, iterations=2)
        assert np.linalg.norm(b - A @ x) < 0.3 * r0

    def test_dimension_mismatch(self):
        A = poisson((10,), format="csr")
        with pytest.raises(ValueError):
            rel.jacobi(A, np.zeros(5), np.zeros(10))

    def test_complex(self):
        A = poisson((16,), format="csr").astype(complex)
        A = (A + 1j * sp.eye(16)).tocsr()
        x = (rng().standard_normal(16) + 1j * rng().standard_normal(16))
        b = rng().standard_normal(16) + 0j
        D = A.diagonal()
        expected = x + (b - A @ x) / D
        got = x.copy()
        rel.jacobi(A, got, b, iterations=1, omega=1.0)
        assert np.allclose(got, expected, atol=1e-12)


class TestDeviceSmoothers:
    """Device kernels vs host counterparts."""

    def _sys(self, n=20):
        A = poisson((n, n), format="csr")
        E = SparseELL.from_scipy(A)
        x = rng().standard_normal(A.shape[0])
        b = rng().standard_normal(A.shape[0])
        return A, E, x, b

    def test_jacobi_matches_host(self):
        A, E, x, b = self._sys()
        dinv = 1.0 / A.diagonal()
        got = np.asarray(jacobi_step(E, jnp.asarray(dinv), jnp.asarray(x),
                                     jnp.asarray(b), 0.8))
        host = x.copy()
        rel.jacobi(A, host, b, iterations=1, omega=0.8)
        assert np.allclose(got, host, atol=1e-12)

    def test_multicolor_gs_is_exact_gs_under_color_order(self):
        """Multicolor GS equals sequential GS applied in color-sorted order."""
        A, E, x, b = self._sys(8)
        from pyamg_tpu.graph import vertex_coloring

        colors = vertex_coloring(A, method="JP")
        nc = colors.max() + 1
        masks = np.zeros((nc, A.shape[0]))
        masks[colors, np.arange(A.shape[0])] = 1.0
        dinv = 1.0 / A.diagonal()
        got = np.asarray(multicolor_gs_step(
            E, jnp.asarray(dinv), jnp.asarray(masks), jnp.asarray(x),
            jnp.asarray(b)))
        order = np.argsort(colors, kind="stable")
        host = x.copy()
        rel.gauss_seidel_indexed(A, host, b, indices=order, iterations=1)
        assert np.allclose(got, host, atol=1e-10)

    def test_polynomial_matches_host(self):
        A, E, x, b = self._sys(6)
        coeffs = (0.2, -0.1, 0.05)
        got = np.asarray(polynomial_step(E, coeffs, jnp.asarray(x),
                                         jnp.asarray(b)))
        host = x.copy()
        rel.polynomial(A, host, b, coefficients=list(coeffs), iterations=1)
        assert np.allclose(got, host, atol=1e-10)

    def test_block_jacobi_matches_host(self):
        A, E, x, b = self._sys(6)
        from pyamg_tpu.util.utils import get_block_diag

        Dinv = get_block_diag(A, 2, inv_flag=True)
        got = np.asarray(block_jacobi_step(E, jnp.asarray(Dinv),
                                           jnp.asarray(x), jnp.asarray(b),
                                           1.0))
        host = x.copy()
        rel.block_jacobi(A, host, b, blocksize=2, iterations=1, omega=1.0)
        assert np.allclose(got, host, atol=1e-10)

    def test_smoother_factory_and_dispatch(self):
        from pyamg_tpu.multilevel import Level

        A, E, x, b = self._sys(10)
        lvl = Level()
        lvl.A_csr = A
        lvl.A = E
        for spec in ["jacobi", "richardson", "gauss_seidel", "chebyshev",
                     ("block_jacobi", {"blocksize": 2}),
                     ("sor", {"omega": 1.2}), "jacobi_ne", None]:
            name, kw = spec if isinstance(spec, tuple) else (spec, {})
            sm = make_smoother_data(lvl, name, kw)
            out = np.asarray(apply_smoother(sm, E, jnp.asarray(x),
                                            jnp.asarray(b)))
            if name is not None:
                r0 = np.linalg.norm(b - A @ x)
                r1 = np.linalg.norm(b - A @ out)
                assert r1 < r0, f"smoother {name} did not reduce residual"

    def test_schwarz_device_smoother_converges(self):
        import pyamg_tpu

        A = poisson((20, 20), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, presmoother="schwarz", postsmoother="schwarz", max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert (res[-1] / res[0]) ** (1 / max(len(res) - 1, 1)) < 0.7

    def test_krylov_smoother_converges(self):
        import pyamg_tpu

        A = poisson((20, 20), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, presmoother=("cg", {"iterations": 2}),
            postsmoother=("cg", {"iterations": 2}), max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert (res[-1] / res[0]) ** (1 / max(len(res) - 1, 1)) < 0.5

    def test_multicolor_gs_backward_matches_reverse_order(self):
        A, E, x, b = self._sys(8)
        from pyamg_tpu.graph import vertex_coloring

        colors = vertex_coloring(A, method="JP")
        nc = colors.max() + 1
        masks = np.zeros((nc, A.shape[0]))
        masks[colors, np.arange(A.shape[0])] = 1.0
        dinv = 1.0 / A.diagonal()
        got = np.asarray(multicolor_gs_step(
            E, jnp.asarray(dinv), jnp.asarray(masks), jnp.asarray(x),
            jnp.asarray(b), reverse=True))
        order = np.argsort(colors, kind="stable")[::-1]
        host = x.copy()
        rel.gauss_seidel_indexed(A, host, b, indices=order, iterations=1)
        assert np.allclose(got, host, atol=1e-10)

    def test_pcr_tridiag_exact(self):
        from pyamg_tpu.relaxation.device import batched_tridiag_pcr

        r = rng()
        L, nl = 17, 5
        dl = r.random((nl, L))
        dl[:, 0] = 0
        du = r.random((nl, L))
        du[:, -1] = 0
        d = 4 + r.random((nl, L))
        B = r.random((nl, L))
        X = np.asarray(batched_tridiag_pcr(
            jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du),
            jnp.asarray(B)))
        for i in range(nl):
            T = sp.diags([dl[i, 1:], d[i], du[i, :-1]], [-1, 0, 1]).toarray()
            assert np.allclose(T @ X[i], B[i], atol=1e-9)

    def test_block_pcr_exact_and_f32_stable_on_long_lines(self):
        # Component layout (q, q, nlines, L): exact vs dense in f64, and
        # f32 must stay accurate over the log2(L) elimination rounds on
        # realistic anisotropic blocks (an einsum form lowers to
        # dot_general, which a matrix unit may round to bf16 or TF32 and
        # so destroy the cancellation; the kernel is elementwise-only).
        from pyamg_tpu.relaxation.device import batched_block_tridiag_pcr

        r = rng()
        for q, L, nl in ((2, 16, 4), (3, 8, 3), (2, 256, 2)):
            d = r.standard_normal((nl, L, q, q)) + 6 * np.eye(q)
            dl = 0.5 * r.standard_normal((nl, L, q, q))
            dl[:, 0] = 0
            du = 0.5 * r.standard_normal((nl, L, q, q))
            du[:, -1] = 0
            B = r.standard_normal((nl, L, q))
            tc = lambda a: np.ascontiguousarray(a.transpose(2, 3, 0, 1))
            Bc = np.ascontiguousarray(B.transpose(2, 0, 1))
            for dt, tol in ((np.float64, 1e-9), (np.float32, 1e-3)):
                X = np.asarray(batched_block_tridiag_pcr(
                    jnp.asarray(tc(dl), dt), jnp.asarray(tc(d), dt),
                    jnp.asarray(tc(du), dt), jnp.asarray(Bc, dt)))
                X = X.transpose(1, 2, 0)            # (nl, L, q)
                for i in range(nl):
                    M = np.zeros((L * q, L * q))
                    for line in range(L):
                        s = slice(line * q, (line + 1) * q)
                        M[s, s] = d[i, line]
                        if line > 0:
                            M[s, slice((line - 1) * q, line * q)] = \
                                dl[i, line]
                        if line < L - 1:
                            M[s, slice((line + 1) * q,
                                       (line + 2) * q)] = du[i, line]
                    want = np.linalg.solve(M, B[i].ravel())
                    assert np.allclose(X[i].ravel(), want, atol=tol), \
                        (q, L, dt)

    def test_zebra_beats_point_gs_on_anisotropy(self):
        import pyamg_tpu
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d

        sten = diffusion_stencil_2d(epsilon=1e-3, theta=0.0, type="FD")
        A = stencil_grid(sten, (48, 48), format="csr")
        b = rng().standard_normal(A.shape[0])

        def cf(sm):
            ml = pyamg_tpu.smoothed_aggregation_solver(
                A, presmoother=sm, postsmoother=sm, max_coarse=20)
            res = []
            ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
            return (res[-1] / res[0]) ** (1 / max(len(res) - 1, 1))

        assert cf("zebra") < 0.1
        assert cf("line_jacobi") < 0.5

    def test_native_thomas_matches_numpy_zebra(self):
        # round-3: the host zebra's batched Thomas runs native
        # (amg_core thomas_lines) with a per-matrix cached line setup —
        # must be bit-identical to the numpy fallback
        import pyamg_tpu.amg_core as core
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        from pyamg_tpu.relaxation import relaxation as rel

        sten = diffusion_stencil_2d(epsilon=1e-3, theta=0.0, type="FD")
        b = rng().standard_normal(40 * 40)

        def run():
            A = stencil_grid(sten, (40, 40), format="csr").astype(
                np.float64)
            A.grid = (40, 40)
            x = np.zeros(A.shape[0])
            rel.zebra(A, x, b, iterations=2, sweep="symmetric")
            return x

        x_native = run()
        orig = core.thomas_lines_native
        core.thomas_lines_native = lambda *a, **k: False
        try:
            x_numpy = run()
        finally:
            core.thomas_lines_native = orig
        assert np.array_equal(x_native, x_numpy)

    def test_chebyshev_coefficients(self):
        from pyamg_tpu.relaxation import chebyshev_polynomial_coefficients

        coef = chebyshev_polynomial_coefficients(1.0, 2.0, 3)
        assert np.allclose(coef, [-0.32323232, 1.45454545, -2.12121212, 1.0])


class TestNormalEquationSmoothers:
    """NE/NR device smoothers are genuine (distinct scalings,
    complex-safe)."""

    def _complex_system(self, n=64):
        A = poisson((n,), format="csr").astype(complex)
        # complex perturbation that keeps A nonsingular
        A = A + 0.3j * sp.diags(np.ones(n - 1), 1, format="csr") \
              - 0.3j * sp.diags(np.ones(n - 1), -1, format="csr")
        A = sp.csr_matrix(A)
        b = (rng().standard_normal(n) + 1j * rng().standard_normal(n))
        return A, b

    def test_jacobi_ne_complex_converges(self):
        from types import SimpleNamespace

        A, b = self._complex_system()
        lvl = SimpleNamespace(A_csr=A, A=SparseELL.from_scipy(A))
        sm = make_smoother_data(lvl, "jacobi_ne", {"omega": 1.0,
                                                   "iterations": 40})
        x = jnp.zeros(A.shape[0], dtype=complex)
        bd = jnp.asarray(b)
        r0 = np.linalg.norm(b)
        x = apply_smoother(sm, lvl.A, x, bd)
        r1 = np.linalg.norm(b - A @ np.asarray(x))
        assert r1 < 0.9 * r0          # converges instead of diverging
        x = apply_smoother(sm, lvl.A, x, bd)
        r2 = np.linalg.norm(b - A @ np.asarray(x))
        assert r2 < r1

    def test_ne_vs_nr_scalings_differ(self):
        from types import SimpleNamespace

        # non-normal matrix: row and column 2-norms differ
        n = 32
        A = poisson((n,), format="csr")
        D = sp.diags(np.linspace(1.0, 4.0, n))
        A = sp.csr_matrix(D @ A)
        lvl = SimpleNamespace(A_csr=A, A=SparseELL.from_scipy(A))
        sm_ne = make_smoother_data(lvl, "jacobi_ne", {})
        sm_nr = make_smoother_data(lvl, "gauss_seidel_nr", {})
        assert sm_ne.kind == "jacobi_ne"
        assert sm_nr.kind == "jacobi_nr"
        assert not np.allclose(np.asarray(sm_ne.dinv_ne),
                               np.asarray(sm_nr.dinv_ne))
        # both reduce the residual of the nonsymmetric system
        b = rng().standard_normal(n)
        for sm in (sm_ne, sm_nr):
            x = jnp.zeros(n)
            for _ in range(30):
                x = apply_smoother(sm, lvl.A, x, jnp.asarray(b))
            assert np.linalg.norm(b - A @ np.asarray(x)) \
                < 0.8 * np.linalg.norm(b)

    def test_cgnr_cgne_genuine_on_nonsymmetric(self):
        from types import SimpleNamespace

        # recirculating-flow-like nonsymmetric operator
        n = 24
        A = poisson((n, n), format="csr")
        N = A.shape[0]
        conv = sp.diags([np.ones(N - 1), -np.ones(N - 1)], [1, -1],
                        format="csr") * 2.0
        A = sp.csr_matrix(A + conv)
        lvl = SimpleNamespace(A_csr=A, A=SparseELL.from_scipy(A))
        b = rng().standard_normal(N)
        for name in ("cgnr", "cgne"):
            sm = make_smoother_data(lvl, name, {"iterations": 30})
            assert sm.AT is not None            # carries the true adjoint
            x = apply_smoother(sm, lvl.A, jnp.zeros(N), jnp.asarray(b))
            r = np.linalg.norm(b - A @ np.asarray(x))
            assert r < 0.7 * np.linalg.norm(b), name


class TestGatherFormMulticolorGS:
    """The gather-form sweep (per-color row subsets) must produce the
    identical iteration to the mask-form multicolor GS."""

    def test_matches_mask_form(self):
        import jax.numpy as jnp
        from pyamg_tpu.gallery import sprand
        import scipy.sparse as sp
        from pyamg_tpu.sparse import SparseELL
        from pyamg_tpu.relaxation.smoothing import (
            _coloring, _color_masks, _color_gather_arrays)
        from pyamg_tpu.relaxation.device import (
            SmootherData, multicolor_gs_step, multicolor_gs_gather_step)
        rng = np.random.default_rng(3)
        A = (sprand(60, 60, 0.1, seed=5) + 10 * sp.eye(60)).tocsr()
        E = SparseELL.from_scipy(A)
        colors = _coloring(A)
        masks = _color_masks(A, colors=colors)
        cr, cc, cd = _color_gather_arrays(A, colors)
        dinv = jnp.asarray(1.0 / A.diagonal())
        sm = SmootherData(kind="gauss_seidel", dinv=dinv, color_rows=cr,
                          color_cols=cc, color_data=cd)
        x0 = jnp.asarray(rng.standard_normal(60))
        b = jnp.asarray(rng.standard_normal(60))
        for rev in (False, True):
            x1 = multicolor_gs_step(E, dinv, masks, x0, b, reverse=rev)
            x2 = multicolor_gs_gather_step(sm, x0, b, reverse=rev)
            assert np.allclose(np.asarray(x1), np.asarray(x2), atol=1e-12)
