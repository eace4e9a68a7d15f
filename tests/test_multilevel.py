"""Hierarchy runtime tests: cycles, complexity, preconditioning, solver set.

Oracle style per SURVEY.md §4.2: convergence-factor bounds on gallery
problems (classical < 0.2 on Poisson, SA < 0.9), not pinned outputs.
"""

import numpy as np
import pytest

import pyamg_tpu
from pyamg_tpu.gallery import poisson, linear_elasticity
from pyamg_tpu import (ruge_stuben_solver, smoothed_aggregation_solver,
                       MultilevelSolverSet)


def conv_factor(res):
    res = np.asarray(res)
    return (res[-1] / res[0]) ** (1.0 / max(len(res) - 1, 1))


def rng():
    return np.random.default_rng(0)


class TestClassical:
    def test_poisson_2d_v_cycle(self):
        A = poisson((40, 40), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        x = ml.solve(b, tol=1e-10, maxiter=40, residuals=res)
        assert conv_factor(res) < 0.2     # reference test_classical.py bound
        assert np.linalg.norm(b - A @ x) < 1e-9 * np.linalg.norm(b)

    def test_poisson_1d(self):
        A = poisson((200,), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-10, maxiter=40, residuals=res)
        assert conv_factor(res) < 0.2

    @pytest.mark.parametrize("cf", ["RS", "PMIS", "PMISc", "CLJP", "CLJPc"])
    def test_splittings_converge(self, cf):
        A = poisson((25, 25), format="csr")
        ml = ruge_stuben_solver(A, CF=cf, max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.7, f"CF={cf}"

    def test_anisotropic_classical(self):
        from pyamg_tpu.gallery import diffusion_stencil_2d, stencil_grid

        sten = diffusion_stencil_2d(epsilon=0.001, theta=0, type="FD")
        A = stencil_grid(sten, (30, 30), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.5

    def test_coarse_filter_keeps_convergence(self):
        from pyamg_tpu.gallery import diffusion_stencil_2d, stencil_grid

        sten = diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 4,
                                    type="FD")
        A = stencil_grid(sten, (48, 48), format="csr")
        b = rng().standard_normal(A.shape[0])
        res_f, res_n = [], []
        ml_f = ruge_stuben_solver(A, coarse_filter=0.02, max_coarse=20)
        ml_f.solve(b, tol=1e-8, maxiter=80, accel="cg", residuals=res_f)
        ml_n = ruge_stuben_solver(A, max_coarse=20)
        ml_n.solve(b, tol=1e-8, maxiter=80, accel="cg", residuals=res_n)
        # filtering must not blow up the iteration count
        assert len(res_f) <= len(res_n) + 10
        assert res_f[-1] / res_f[0] < 1e-6

    def test_standard_interpolation(self):
        A = poisson((25, 25), format="csr")
        ml = ruge_stuben_solver(A, interpolation="standard", max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.3


class TestCycles:
    @pytest.mark.parametrize("cycle", ["V", "W", "F", "AMLI"])
    def test_cycles_converge(self, cycle):
        A = poisson((30, 30), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=40, cycle=cycle, residuals=res)
        assert conv_factor(res) < 0.25, f"cycle={cycle}"

    def test_cycle_complexity_ordering(self):
        A = poisson((40, 40), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=10)
        assert ml.cycle_complexity("V") <= ml.cycle_complexity("F") \
            <= ml.cycle_complexity("W")

    def test_complexities(self):
        A = poisson((40, 40), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=10)
        assert 1.0 < ml.operator_complexity() < 3.5
        assert 1.0 < ml.grid_complexity() < 2.5
        assert "Number of Levels" in repr(ml)


class TestPreconditioning:
    def test_aspreconditioner_scipy_cg(self):
        import scipy.sparse.linalg as spla

        A = poisson((30, 30), format="csr")
        ml = smoothed_aggregation_solver(A, max_coarse=10)
        M = ml.aspreconditioner()
        b = rng().standard_normal(A.shape[0])
        counter = {"n": 0}

        def cb(xk):
            counter["n"] += 1

        x, info = spla.cg(A, b, M=M, rtol=1e-8, callback=cb)
        assert info == 0
        assert counter["n"] < 25
        assert np.linalg.norm(b - A @ x) < 1e-6 * np.linalg.norm(b)

    def test_accel_cg(self):
        A = poisson((30, 30), format="csr")
        ml = smoothed_aggregation_solver(A, max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        res = []
        x = ml.solve(b, tol=1e-10, maxiter=50, accel="cg", residuals=res)
        assert len(res) - 1 < 20
        assert np.linalg.norm(b - A @ np.asarray(x)) < \
            1e-8 * np.linalg.norm(b)

    def test_accel_gmres(self):
        A = poisson((20, 20), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        x = ml.solve(b, tol=1e-8, maxiter=50, accel="gmres")
        assert np.linalg.norm(b - A @ np.asarray(x)) < \
            1e-6 * np.linalg.norm(b)

    @pytest.mark.parametrize("accel", ["cr", "steepest_descent",
                                       "minimal_residual"])
    def test_accel_first_class_krylov(self, accel):
        # round-3: cr/steepest_descent/minimal_residual ride the same
        # fused hierarchy-as-argument programs as cg (multilevel.py:449)
        A = poisson((30, 30), format="csr")
        ml = smoothed_aggregation_solver(A, max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        res = []
        x, info = ml.solve(b, tol=1e-8, maxiter=100, accel=accel,
                           residuals=res, return_info=True)
        assert info == 0
        assert len(res) - 1 < 40
        assert np.linalg.norm(b - A @ np.asarray(x)) < \
            1e-6 * np.linalg.norm(b)


class TestCoarseSolvers:
    @pytest.mark.parametrize("cs", ["pinv", "splu", "lu", "cholesky",
                                    ("jacobi", {"iterations": 30})])
    def test_coarse_solver_options(self, cs):
        A = poisson((25, 25), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=30, coarse_solver=cs)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.6

    def test_factorized_backends_are_exact(self):
        """lu/cholesky/splu must solve the coarse system through genuine
        factorizations (reference multilevel.py:554-720), so a one-level
        'hierarchy' solved by them is a direct solve."""
        from pyamg_tpu.multilevel import _build_coarse_state, _apply_coarse
        import jax.numpy as jnp

        A = poisson((12, 12), format="csr")
        b = rng().standard_normal(A.shape[0])
        x_ref = np.linalg.solve(A.toarray(), b)
        for name in ("lu", "cholesky", "splu", "pinv"):
            kind, state = _build_coarse_state(A, name)
            x = np.asarray(_apply_coarse(kind, state, jnp.asarray(b)))
            assert np.allclose(x, x_ref, atol=1e-8), name

    def test_splu_zero_row_removal(self):
        """splu drops exactly-zero rows/columns before factorizing
        (reference multilevel.py:629-641)."""
        import scipy.sparse as sp
        from pyamg_tpu.multilevel import coarse_grid_solver

        n = 40
        A = sp.random(n, n, density=0.3, random_state=2)
        A = (A + A.T + 10 * sp.eye(n)).tolil()
        A[7, :] = 0
        A[:, 7] = 0
        A = A.tocsr()
        A.eliminate_zeros()
        b = np.asarray(A @ np.ones(n))
        x = coarse_grid_solver("splu")(A, b)
        assert np.linalg.norm(A @ x - b) < 1e-10 * max(np.linalg.norm(b), 1)
        assert x[7] == 0.0


class TestSolverSet:
    def test_additive_and_multiplicative(self):
        A = poisson((20, 20), format="csr")
        ml1 = ruge_stuben_solver(A, max_coarse=10)
        ml2 = smoothed_aggregation_solver(A, max_coarse=10)
        for mode in ("additive", "multiplicative"):
            mset = MultilevelSolverSet([ml1, ml2], mode=mode)
            b = rng().standard_normal(A.shape[0])
            x = mset.solve(b, tol=1e-8, maxiter=60)
            assert np.linalg.norm(b - A @ np.asarray(x)) < \
                1e-5 * np.linalg.norm(b)

    def test_management(self):
        A = poisson((10, 10), format="csr")
        ml1 = ruge_stuben_solver(A, max_coarse=10)
        mset = MultilevelSolverSet([ml1])
        mset.add_hierarchy(ruge_stuben_solver(A, max_coarse=20))
        assert len(mset.solvers) == 2
        mset.replace_hierarchy(ml1, 1)
        mset.remove_hierarchy(0)
        assert len(mset.solvers) == 1


class TestMiscSolve:
    def test_x0_and_callback(self):
        A = poisson((15, 15), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        calls = []
        x = ml.solve(b, x0=np.ones(A.shape[0]), tol=1e-8, maxiter=30,
                     callback=lambda xk: calls.append(1))
        assert len(calls) > 0

    def test_zero_rhs(self):
        A = poisson((10, 10), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=10)
        x = ml.solve(np.zeros(A.shape[0]), tol=1e-8)
        assert np.linalg.norm(x) < 1e-8

    def test_return_info(self):
        A = poisson((10, 10), format="csr")
        ml = ruge_stuben_solver(A, max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        x, info = ml.solve(b, tol=1e-8, maxiter=30, return_info=True)
        assert info == 0


class TestReturnResiduals:
    def test_fused_accel_returns_residuals(self):
        """return_residuals works without an explicit residuals list."""
        A = poisson((24, 24), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=20)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        x, res = ml.solve(b, tol=1e-8, maxiter=30, accel="cg",
                          return_residuals=True)
        assert len(res) >= 2
        assert res[-1] < 1e-8 * np.linalg.norm(b) * 10
        assert np.linalg.norm(b - A @ x) < 1e-6 * np.linalg.norm(b)


class TestSolveMP:
    """Mixed-precision solve: f32 device hierarchy, true f64 residual."""

    @pytest.mark.parametrize("method", ["pcg", "defect"])
    def test_reaches_f64_tol(self, method):
        import jax.numpy as jnp
        A = poisson((64, 64), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=50,
                                                   op_dtype=jnp.float32)
        rng = np.random.default_rng(0)
        b = np.asarray(A @ rng.random(A.shape[0]))
        x, info = ml.solve_mp(b, tol=1e-10, return_info=True, method=method)
        x = np.asarray(x, dtype=float)
        rr = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
        assert rr < 5e-10
        assert info["inner_iterations"] >= 1
        # pcg: "rounds" counts bounded device dispatches (chunks); unlike
        # defect rounds they carry full CG state, no restart
        assert info["rounds"] >= 1

    def test_pcg_matches_f64_iteration_count(self):
        """The f32-preconditioned f64 PCG must not lose momentum vs an
        all-f64 solve (the point of method='pcg' over defect correction)."""
        import jax.numpy as jnp
        A = poisson((64, 64), format="csr")
        rng = np.random.default_rng(0)
        b = np.asarray(A @ rng.random(A.shape[0]))
        ml32 = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=50,
                                                     op_dtype=jnp.float32)
        _, info = ml32.solve_mp(b, tol=1e-8, return_info=True, method="pcg")
        ml64 = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=50)
        res = []
        ml64.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res)
        assert info["inner_iterations"] <= (len(res) - 1) + 2


class TestComplexClassicalTransfers:
    def test_embedded_R_matches_host_R(self):
        """Classical R_csr = P.T (plain transpose, no conjugate); the
        fine-embedded device restriction must match it for complex A."""
        import scipy.sparse as sp
        rng = np.random.default_rng(0)
        A = (poisson((24, 24), format="csr")
             + 0.05j * sp.eye(576)).tocsr()
        ml = pyamg_tpu.ruge_stuben_solver(A)
        for i, l in enumerate(ml.levels[:-1]):
            r = (rng.standard_normal(l.P_csr.shape[0])
                 + 1j * rng.standard_normal(l.P_csr.shape[0]))
            assert np.allclose(np.asarray(l.R @ r), l.R_csr @ r,
                               atol=1e-12), f"R{i}"


class TestCompatibleRelaxation:
    """CR coarsening (reference cr.py:81 + cr_helper, ruge_stuben.h:641)."""

    def test_cr_splitting_poisson(self):
        from pyamg_tpu.classical import CR
        from pyamg_tpu.gallery import poisson

        A = poisson((20, 20), format="csr")
        s = CR(A)
        frac = s.sum() / s.size
        assert 0.1 < frac < 0.6        # sensible coarsening ratio

    def test_cr_thetacs_schedules(self):
        from pyamg_tpu.classical import CR
        from pyamg_tpu.gallery import poisson

        A = poisson((16, 16), format="csr")
        s_auto = CR(A, thetacs="auto")
        s_flt = CR(A, thetacs=0.5)
        s_lst = CR(A, thetacs=[0.9, 0.7, 0.5])
        for s in (s_auto, s_flt, s_lst):
            assert s.sum() > 0
        # a lower threshold admits at least as many candidates
        assert s_flt.sum() >= CR(A, thetacs=0.95).sum()
        import pytest

        with pytest.raises(ValueError):
            CR(A, thetacs=1.5)

    def test_cr_splitting_converges_aniso(self):
        # CR-driven hierarchy on anisotropic Poisson converges
        # (quality oracle in the reference's CR paper)
        import pyamg_tpu
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d

        sten = diffusion_stencil_2d(epsilon=0.01, theta=0.0, type="FD")
        A = stencil_grid(sten, (32, 32), format="csr")
        ml = pyamg_tpu.ruge_stuben_solver(A, CF="CR", max_levels=2)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=res)
        assert res[-1] / res[0] < 1e-8


class TestAsPreconditionerInterop:
    def test_scipy_and_native_krylov(self):
        # the returned operator must serve BOTH scipy's numpy-matvec
        # contract and this package's traced Krylov cores (scipy's
        # LinearOperator.matvec numpy-converts tracers and would fail)
        import scipy.sparse.linalg as spla
        import pyamg_tpu
        from pyamg_tpu import krylov
        from pyamg_tpu.gallery import poisson
        from pyamg_tpu.sparse import device_operator

        A = poisson((16, 16), format="csr")
        b = np.random.default_rng(3).standard_normal(A.shape[0])
        ml = pyamg_tpu.smoothed_aggregation_solver(A)
        M = ml.aspreconditioner(cycle="V")
        x, _ = krylov.cg(device_operator(A), b, M=M, tol=1e-8, maxiter=100)
        assert np.linalg.norm(b - A @ np.asarray(x)) < \
            1e-5 * np.linalg.norm(b)
        x2, _ = spla.cg(A, b, M=M, rtol=1e-8, maxiter=100)
        assert np.linalg.norm(b - A @ x2) < 1e-5 * np.linalg.norm(b)


class TestClassicalPoisson500IterationParity:
    """Pin of the classical_poisson_500 +1-iteration analysis
    (docs/design.md, "Findings kept from the round notes").

    The RS hierarchy is bit-identical to the reference (fingerprint
    tests), yet the suite config takes 8 PCG+V(1,1) iterations to 1e-10
    where the reference takes 7.  Isolation: the
    reference's OWN hierarchy solved with multicolor-ORDERED symmetric
    Gauss-Seidel (gauss_seidel_indexed over a greedy coloring) takes
    exactly 8 iterations at relres 2.368e-11 — matching ours to three
    digits — while its default lexicographic ordering takes 7.  The +1
    iteration is the parallel-ordering cost of the smoother; precision
    (f32 vs f64 cycles), the solve_mp wrapper, and the accel are all
    exonerated (each isolated variant still gives 8).  Zebra line
    relaxation — equally parallel (batched PCR) — reaches 7.
    """

    def test_color_gs_8_zebra_7(self):
        import jax.numpy as jnp

        A = poisson((500, 500), format="csr")
        b = np.asarray(A @ np.random.default_rng(0).random(A.shape[0]))

        ml = pyamg_tpu.ruge_stuben_solver(A, CF="RS",
                                          op_dtype=jnp.float32)
        x, info = ml.solve_mp(b, tol=1e-10, return_info=True)
        rr = float(np.linalg.norm(b - A @ np.asarray(x, float))
                   / np.linalg.norm(b))
        assert info["inner_iterations"] == 8
        assert abs(rr - 2.368e-11) < 2e-12   # the reference color-GS pin

        mlz = pyamg_tpu.ruge_stuben_solver(A, CF="RS",
                                           op_dtype=jnp.float32,
                                           presmoother="zebra",
                                           postsmoother="zebra")
        xz, infoz = mlz.solve_mp(b, tol=1e-10, return_info=True)
        rrz = float(np.linalg.norm(b - A @ np.asarray(xz, float))
                    / np.linalg.norm(b))
        assert infoz["inner_iterations"] == 7      # reference parity
        assert rrz < 1e-10
