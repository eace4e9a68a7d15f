"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

import pyamg_tpu
from pyamg_tpu.gallery import poisson
from pyamg_tpu.parallel import make_mesh, shard_solver


def conv_factor(res):
    res = np.asarray(res)
    return (res[-1] / res[0]) ** (1.0 / max(len(res) - 1, 1))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestSharded:
    def test_sharded_solve_matches_single(self):
        A = poisson((31, 33), format="csr")     # deliberately non-divisible
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=20)
        res1 = []
        x1 = ml.solve(b, tol=1e-10, maxiter=40, residuals=res1)

        sml = shard_solver(ml, n_devices=8)
        res2 = []
        x2 = sml.solve(b, tol=1e-10, maxiter=40, residuals=res2)
        assert np.allclose(x1, x2, atol=1e-8)
        assert abs(conv_factor(res1) - conv_factor(res2)) < 1e-6

    def test_sharded_accel_cg(self):
        A = poisson((24, 24), format="csr")
        b = np.random.default_rng(1).standard_normal(A.shape[0])
        ml = pyamg_tpu.ruge_stuben_solver(A, max_coarse=20)
        sml = shard_solver(ml, n_devices=8)
        x = sml.solve(b, tol=1e-10, maxiter=40, accel="cg")
        assert np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)

    def test_sharding_is_actually_distributed(self):
        A = poisson((16, 16), format="csr")
        ml = pyamg_tpu.ruge_stuben_solver(A, max_coarse=20)
        sml = shard_solver(ml, n_devices=8)
        data = sml.levels[0].A.data
        assert len(data.sharding.device_set) == 8

    def test_structured_sharded_matches_single(self):
        from pyamg_tpu.parallel import shard_structured_solver

        A = poisson((48, 48), format="csr")     # 2304 % 8 == 0
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=50, improve_candidates=None)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        x1 = ml.solve(b, tol=1e-10, maxiter=50, accel="cg")
        sml = shard_structured_solver(ml, n_devices=8, axis_name="rows", min_shard_rows=256)
        res = []
        x2 = sml.solve(b, tol=1e-10, maxiter=50, residuals=res)
        assert np.allclose(x1, x2, atol=1e-8)

    def test_mesh_sizes(self):
        mesh = make_mesh(4)
        assert mesh.devices.size == 4
        with pytest.raises(ValueError):
            make_mesh(10**6)

    def test_custom_mesh_axis_adopted(self):
        # every sharded entry point must adopt the caller's single mesh
        # axis whatever its name (round-3: StructuredShardedSolver missed
        # the adoption branch ShardedSolver/general_sa_setup_sharded got)
        from jax.sharding import Mesh
        from pyamg_tpu.parallel import ShardedSolver, StructuredShardedSolver

        mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
        A = poisson((48, 48), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=50, improve_candidates=None)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        x1 = ml.solve(b, tol=1e-10, maxiter=50, accel="cg")
        sml = StructuredShardedSolver(ml, mesh=mesh, min_shard_rows=256)
        assert sml.axis == "x"
        x2 = sml.solve(b, tol=1e-10, maxiter=50)
        assert np.allclose(x1, x2, atol=1e-8)
        psml = ShardedSolver(ml, mesh)
        assert psml.axis == "x"
        x3 = psml.solve(b, tol=1e-10, maxiter=50, accel="cg")
        assert np.allclose(x1, x3, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestShardedSmootherFidelity:
    """Every smoother kind survives sharding faithfully."""

    def test_sharded_zebra_matches_single(self):
        from pyamg_tpu.relaxation.smoothing import change_smoothers

        A = poisson((32, 8), format="csr")      # every dim divisible by 8
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=400, max_levels=2, improve_candidates=None)
        change_smoothers(ml, ("zebra", {"axis": 0}), ("zebra", {"axis": 0}))
        res1 = []
        x1 = ml.solve(b, tol=1e-10, maxiter=40, residuals=res1)

        sml = shard_solver(ml, n_devices=8)
        res2 = []
        x2 = sml.solve(b, tol=1e-10, maxiter=40, residuals=res2)
        assert np.allclose(x1, x2, atol=1e-8)
        assert abs(conv_factor(res1) - conv_factor(res2)) < 1e-6

    def test_sharded_jacobi_ne_matches_single(self):
        from pyamg_tpu.relaxation.smoothing import change_smoothers

        A = poisson((24, 24), format="csr")     # 576 % 8 == 0 (no padding)
        b = np.random.default_rng(1).standard_normal(A.shape[0])
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=30, improve_candidates=None)
        change_smoothers(ml, "jacobi_ne", "jacobi_ne")
        res1 = []
        x1 = ml.solve(b, tol=1e-8, maxiter=60, residuals=res1)
        sml = shard_solver(ml, n_devices=8)
        res2 = []
        x2 = sml.solve(b, tol=1e-8, maxiter=60, residuals=res2)
        assert abs(conv_factor(res1) - conv_factor(res2)) < 1e-6
        assert np.allclose(x1, x2, atol=1e-7)

    def test_sharded_schwarz_matches_single(self):
        from pyamg_tpu.relaxation.smoothing import change_smoothers

        A = poisson((16, 16), format="csr")
        b = np.random.default_rng(2).standard_normal(A.shape[0])
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=30, improve_candidates=None)
        change_smoothers(ml, "schwarz", "schwarz")
        x1 = ml.solve(b, tol=1e-8, maxiter=60)
        sml = shard_solver(ml, n_devices=8)
        x2 = sml.solve(b, tol=1e-8, maxiter=60)
        assert np.allclose(x1, x2, atol=1e-7)

    def test_sharded_zebra_on_padded_level_matches_single(self):
        """A level whose size does not
        divide the mesh is padded by whole grid slabs — tridiagonal
        systems gain decoupled identity rows, so the sharded zebra solve
        matches the single-device one instead of raising."""
        from pyamg_tpu.relaxation.smoothing import change_smoothers

        A = poisson((31, 7), format="csr")      # 217 not divisible by 8
        b = np.random.default_rng(4).standard_normal(A.shape[0])
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=100, max_levels=2, improve_candidates=None)
        change_smoothers(ml, ("zebra", {"axis": 0}), ("zebra", {"axis": 0}))
        res1 = []
        x1 = ml.solve(b, tol=1e-10, maxiter=40, residuals=res1)
        sml = shard_solver(ml, n_devices=8)
        # fine level padded 217 -> 224 (= lcm(8, slab 7) quantum)
        assert sml.sizes[0] == 224
        res2 = []
        x2 = sml.solve(b, tol=1e-10, maxiter=40, residuals=res2)
        assert np.allclose(x1, x2, atol=1e-8)
        assert abs(conv_factor(res1) - conv_factor(res2)) < 1e-6

    def test_sharded_zebra_padded_more_lines_axis1(self):
        """Same, with lines along axis 1: padding appends whole NEW
        identity lines instead of extending each system."""
        from pyamg_tpu.relaxation.smoothing import change_smoothers

        A = poisson((17, 5), format="csr")      # 85 rows, slab = 5
        b = np.random.default_rng(5).standard_normal(A.shape[0])
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=30, max_levels=2, improve_candidates=None)
        change_smoothers(ml, ("zebra", {"axis": 1}), ("zebra", {"axis": 1}))
        res1 = []
        x1 = ml.solve(b, tol=1e-10, maxiter=40, residuals=res1)
        sml = shard_solver(ml, n_devices=8)
        assert sml.sizes[0] == 120              # lcm(8, 5) = 40 -> 120
        res2 = []
        x2 = sml.solve(b, tol=1e-10, maxiter=40, residuals=res2)
        assert np.allclose(x1, x2, atol=1e-8)
        assert abs(conv_factor(res1) - conv_factor(res2)) < 1e-6

    def test_structured_sharded_gmres_and_standalone(self):
        from pyamg_tpu.parallel import shard_structured_solver

        A = poisson((48, 48), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=50, improve_candidates=None)
        b = np.random.default_rng(3).standard_normal(A.shape[0])
        sml = shard_structured_solver(ml, n_devices=8, min_shard_rows=256)
        x1 = sml.solve(b, tol=1e-10, maxiter=50, accel="gmres")
        assert np.linalg.norm(b - A @ x1) < 1e-8 * np.linalg.norm(b)
        x2 = sml.solve(b, tol=1e-8, maxiter=60, accel=None)
        assert np.linalg.norm(b - A @ x2) < 1e-6 * np.linalg.norm(b)
        x3 = sml.solve(b, tol=1e-10, maxiter=50, accel="fgmres")
        assert np.linalg.norm(b - A @ x3) < 1e-8 * np.linalg.norm(b)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestShardedBlockHierarchies:
    """Round-2: BSR/BDIA hierarchies (elasticity RBMs, multi-candidate SA)
    shard faithfully through the padded-ELL path."""

    def test_sharded_elasticity_matches_single(self):
        from pyamg_tpu.gallery import linear_elasticity
        from pyamg_tpu.parallel import shard_solver

        A, B = linear_elasticity((16, 16))
        ml = pyamg_tpu.smoothed_aggregation_solver(A, B=B, max_coarse=40)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        res1 = []
        x1 = ml.solve(b, tol=1e-8, maxiter=40, residuals=res1)
        sml = shard_solver(ml, n_devices=8)
        res2 = []
        x2 = sml.solve(b, tol=1e-8, maxiter=40, residuals=res2)
        assert np.allclose(x1, x2, atol=1e-6)
        assert abs(conv_factor(res1) - conv_factor(res2)) < 1e-5

    def test_sharded_multicandidate_matches_single(self):
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        from pyamg_tpu.parallel import shard_solver

        sten = diffusion_stencil_2d(epsilon=0.01, theta=0.0, type="FD")
        A = stencil_grid(sten, (24, 24), format="csr")
        n = A.shape[0]
        rng = np.random.default_rng(1)
        B = np.stack([np.ones(n), rng.random(n)], axis=1)
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, B=B, max_coarse=30, improve_candidates=None)
        b = rng.standard_normal(n)
        x1 = ml.solve(b, tol=1e-8, maxiter=40)
        sml = shard_solver(ml, n_devices=8)
        x2 = sml.solve(b, tol=1e-8, maxiter=40)
        assert np.allclose(x1, x2, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestDistributedSetup:
    """Round-3: the setup phase itself runs distributed (SURVEY §7 step 8).

    The structured hierarchy is CONSTRUCTED on the mesh — row-sharded
    diagonals, SPMD level builds, sharded comb-probe RAP — and must agree
    with the single-device build to reduction-reassociation accuracy."""

    def test_sharded_setup_matches_single_device(self):
        import jax.numpy as jnp
        from pyamg_tpu.aggregation.device_setup import structured_sa_setup
        from pyamg_tpu.parallel import structured_sa_setup_sharded

        A = poisson((48, 48), format="csr")
        ml_ref = structured_sa_setup(A, (48, 48), dtype=jnp.float64)
        ml_sh = structured_sa_setup_sharded(A, (48, 48), n_devices=8,
                                            dtype=jnp.float64)
        assert len(ml_ref.levels) == len(ml_sh.levels)
        for i, (lr, ls) in enumerate(zip(ml_ref.levels, ml_sh.levels)):
            assert lr.A.offsets == ls.A.offsets, f"level {i} offsets"
            dr = np.asarray(lr.A.diags)
            ds = np.asarray(ls.A.diags)
            err = np.abs(dr - ds).max() / max(np.abs(dr).max(), 1e-300)
            assert err < 1e-12, f"level {i} rel err {err}"
        # divisible levels stay row-sharded on the mesh (not replicated)
        spec0 = ml_sh.levels[0].A.diags.sharding.spec
        assert tuple(spec0) == (None, "rows")

    def test_sharded_setup_solves(self):
        from pyamg_tpu.parallel import structured_sa_setup_sharded

        A = poisson((48, 24), format="csr")
        ml = structured_sa_setup_sharded(A, (48, 24), n_devices=8,
                                         max_coarse=20)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-6, maxiter=40, accel="cg", residuals=res)
        assert res[-1] / res[0] < 1e-6


class TestDistributedGeneralSetup:
    """Round-3: the GENERAL (unstructured) setup's numeric phase runs
    distributed — host keeps the integer graph stages, the mesh runs the
    smoothing/transpose/Galerkin numeric as pattern-masked device SpGEMMs
    (parallel/setup.py general_sa_setup_sharded; role of the reference's
    serial aggregation/aggregation.py:293-430 pipeline)."""

    def _problem(self):
        import scipy.sparse as sp
        A = sp.csr_matrix(poisson((48, 48), format="csr"))  # no grid attr
        return A

    def test_rap_matches_triple_product(self):
        # the sharded coarse operator equals P^T A P of the SAME sharded P
        from pyamg_tpu.parallel import general_sa_setup_sharded, make_mesh

        A = self._problem()
        sol = general_sa_setup_sharded(A, mesh=make_mesh(8),
                                       dtype=np.float64)
        n = A.shape[0]
        nc = sol.levels[1].A_csr.shape[0]
        P_sp = sol.levels[0].P.to_scipy()[:n, :nc]
        ref = (P_sp.T @ A @ P_sp).tocsr()
        d = abs(sol.levels[1].A_csr - ref)
        assert (d.max() if d.nnz else 0.0) < 1e-12

    def test_device_counts_agree(self):
        from pyamg_tpu.parallel import general_sa_setup_sharded, make_mesh

        A = self._problem()
        sol1 = general_sa_setup_sharded(A, mesh=make_mesh(1),
                                        dtype=np.float64)
        sol8 = general_sa_setup_sharded(A, mesh=make_mesh(8),
                                        dtype=np.float64)
        assert len(sol1.levels) == len(sol8.levels)
        for l1, l8 in zip(sol1.levels[1:], sol8.levels[1:]):
            d = abs(l1.A_csr - l8.A_csr)
            m = (d.max() if d.nnz else 0.0) / abs(l1.A_csr).max()
            assert m < 1e-12

    def test_operators_stay_sharded(self):
        from pyamg_tpu.parallel import general_sa_setup_sharded, make_mesh

        A = self._problem()
        sol = general_sa_setup_sharded(A, mesh=make_mesh(8),
                                       dtype=np.float64)
        spec = sol.levels[0].A.data.sharding.spec
        assert tuple(spec)[0] == "rows"
        spec_c = sol.levels[1].A.data.sharding.spec
        assert tuple(spec_c)[0] == "rows"

    def test_solves(self):
        from pyamg_tpu.parallel import general_sa_setup_sharded, make_mesh

        A = self._problem()
        sol = general_sa_setup_sharded(A, mesh=make_mesh(8),
                                       dtype=np.float64)
        b = np.asarray(A @ np.random.default_rng(0).random(A.shape[0]))
        res = []
        x = sol.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res)
        relres = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
        cf = (res[-1] / res[0]) ** (1.0 / (len(res) - 1))
        assert relres < 1e-7
        assert cf < 0.3        # SA on Poisson: well under the 0.9 bound

    def test_row_without_stored_diagonal(self):
        # a row with NO stored diagonal entry must not be silently zeroed
        # in P (the device smoothing kernel places the identity at stored
        # diagonal slots only; setup inserts explicit zero diagonals so
        # dinv=0 rows become identity rows of S, like the serial fallback)
        import scipy.sparse as sp
        from pyamg_tpu.parallel import general_sa_setup_sharded, make_mesh

        A = sp.lil_matrix(poisson((32, 32), format="csr"))
        A[0, 0] = 0.0
        A = A.tocsr()
        A.eliminate_zeros()
        rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
        assert (A.indices == rows).sum() == A.shape[0] - 1  # row 0 diagless
        sol = general_sa_setup_sharded(A, mesh=make_mesh(8),
                                       dtype=np.float64)
        P = sol.levels[0].P.to_scipy()[:A.shape[0]]
        assert abs(P[0]).sum() > 0          # not silently zeroed
        nc = sol.levels[1].A_csr.shape[0]
        ref = (P[:, :nc].T @ A @ P[:, :nc]).tocsr()
        d = abs(sol.levels[1].A_csr - ref)
        assert (d.max() if d.nnz else 0.0) < 1e-12

    def test_elasticity_rbm_candidates(self):
        # blocked (elasticity-class) hierarchy built on the mesh: RBM
        # near-nullspace candidates through the distributed numeric setup
        from pyamg_tpu.gallery import linear_elasticity
        from pyamg_tpu.parallel import general_sa_setup_sharded, make_mesh

        A, B = linear_elasticity((16, 16))
        Ac = A.tocsr()
        sol = general_sa_setup_sharded(Ac, B=B, mesh=make_mesh(8),
                                       dtype=np.float64, max_coarse=40)
        n, nc = Ac.shape[0], sol.levels[1].A_csr.shape[0]
        P = sol.levels[0].P.to_scipy()[:n, :nc]
        ref = (P.T @ Ac @ P).tocsr()
        d = abs(sol.levels[1].A_csr - ref)
        assert (d.max() if d.nnz else 0.0) / abs(ref).max() < 1e-12
        b = np.random.default_rng(0).standard_normal(n)
        res = []
        x = sol.solve(b, tol=1e-8, accel="cg", maxiter=200, residuals=res)
        assert np.linalg.norm(b - Ac @ x) / np.linalg.norm(b) < 1e-7

    def test_multiple_candidates_jacobi_smoother(self):
        # K=2 candidates exercise blocked tentative fitting; jacobi
        # smoother exercises the dinv-only SmootherData path
        from pyamg_tpu.parallel import general_sa_setup_sharded, make_mesh

        A = self._problem()
        n = A.shape[0]
        B = np.ones((n, 2)); B[:, 1] = np.linspace(-1, 1, n)
        sol = general_sa_setup_sharded(
            A, B=B, mesh=make_mesh(8), dtype=np.float64,
            smoother=("jacobi", {"omega": 0.8, "iterations": 2}))
        b = np.asarray(A @ np.random.default_rng(1).random(n))
        res = []
        x = sol.solve(b, tol=1e-8, accel="cg", maxiter=150, residuals=res)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7


class TestDistributedClassicalSetup:
    """The CLASSICAL (Ruge-Stuben) setup's numeric phase runs
    distributed — host keeps strength thresholding / C-F splitting /
    interpolation patterns, the mesh runs the evolution-SOC masked
    SpGEMMs, the interpolation values, P^T and the Galerkin RAP
    (parallel/classical_setup.py; role of the reference's serial
    classical/classical.py:120-187)."""

    def test_direct_matches_host_build(self):
        from pyamg_tpu.parallel import classical_setup_sharded, make_mesh

        A = poisson((48, 48), format="csr")
        ml_ref = pyamg_tpu.ruge_stuben_solver(A, max_coarse=50)
        sol = classical_setup_sharded(A, mesh=make_mesh(8),
                                      dtype=np.float64, max_coarse=50)
        assert len(ml_ref.levels) == len(sol.levels)
        for i, (lr, ls) in enumerate(zip(ml_ref.levels, sol.levels)):
            d = abs(lr.A_csr - ls.A_csr)
            m = (d.max() if d.nnz else 0.0) / abs(lr.A_csr).max()
            assert m < 1e-12, f"level {i} rel err {m}"
        b = np.asarray(A @ np.random.default_rng(0).random(A.shape[0]))
        res = []
        x = sol.solve(b, tol=1e-8, accel="cg", maxiter=60, residuals=res)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7
        assert len(res) - 1 <= 12           # classical AMG on Poisson

    def test_standard_interpolation_matches_host_build(self):
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        from pyamg_tpu.parallel import classical_setup_sharded, make_mesh

        sten = diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 4,
                                    type="FD")
        A = stencil_grid(sten, (48, 48), format="csr")
        ml_ref = pyamg_tpu.ruge_stuben_solver(A, interpolation="standard",
                                              max_coarse=50)
        sol = classical_setup_sharded(A, mesh=make_mesh(8),
                                      dtype=np.float64,
                                      interpolation="standard",
                                      max_coarse=50)
        assert len(ml_ref.levels) == len(sol.levels)
        for i, (lr, ls) in enumerate(zip(ml_ref.levels, sol.levels)):
            d = abs(lr.A_csr - ls.A_csr)
            m = (d.max() if d.nnz else 0.0) / abs(lr.A_csr).max()
            assert m < 1e-12, f"level {i} rel err {m}"

    def test_evolution_strength_matches_host_build(self):
        # config-2 shape: evolution SOC (mesh masked-SpGEMM chain) +
        # standard interpolation; hierarchy must match the host build and
        # the 1-device mesh build machine-exactly
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        from pyamg_tpu.parallel import classical_setup_sharded, make_mesh

        sten = diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 4,
                                    type="FD")
        A = stencil_grid(sten, (48, 48), format="csr")
        kw = dict(strength=("evolution", {"k": 2, "epsilon": 4.0}),
                  interpolation="standard", dtype=np.float64,
                  max_coarse=50)
        sol8 = classical_setup_sharded(A, mesh=make_mesh(8), **kw)
        sol1 = classical_setup_sharded(A, mesh=make_mesh(1), **kw)
        ml_ref = pyamg_tpu.ruge_stuben_solver(
            A, strength=("evolution", {"k": 2, "epsilon": 4.0}),
            interpolation="standard", max_coarse=50)
        assert len(sol8.levels) == len(sol1.levels) == len(ml_ref.levels)
        for i, (l1, l8, lr) in enumerate(zip(sol1.levels, sol8.levels,
                                             ml_ref.levels)):
            d = abs(l1.A_csr - l8.A_csr)
            m = (d.max() if d.nnz else 0.0) / abs(l1.A_csr).max()
            assert m < 1e-12, f"level {i} 1-dev vs 8-dev rel err {m}"
            d = abs(lr.A_csr - l8.A_csr)
            m = (d.max() if d.nnz else 0.0) / abs(lr.A_csr).max()
            assert m < 1e-12, f"level {i} vs host rel err {m}"
        b = np.asarray(A @ np.random.default_rng(0).random(A.shape[0]))
        res = []
        x = sol8.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7

    def test_operators_stay_sharded(self):
        from pyamg_tpu.parallel import classical_setup_sharded, make_mesh

        A = poisson((32, 32), format="csr")
        sol = classical_setup_sharded(A, mesh=make_mesh(8),
                                      dtype=np.float64, max_coarse=50)
        assert tuple(sol.levels[0].A.data.sharding.spec)[0] == "rows"
        assert tuple(sol.levels[1].A.data.sharding.spec)[0] == "rows"


class TestDistributedEnergySetup:
    """SPMD energy-minimization prolongation smoothing (parallel/energy.py,
    role of reference smooth.py:904 / smoothed_aggregation.h:556,797)."""


    def test_energy_P_matches_host_flat_path(self):
        # same T/C/B inputs -> mesh energy CG must reproduce the host
        # _cg_prolongation_flat values up to f64 summation order
        import scipy.sparse as sp
        from pyamg_tpu.aggregation.aggregate import standard_aggregation
        from pyamg_tpu.aggregation.tentative import fit_candidates
        from pyamg_tpu.aggregation.smooth import (
            energy_prolongation_smoother)
        from pyamg_tpu.strength import symmetric_strength_of_connection
        from pyamg_tpu.parallel import make_mesh
        from pyamg_tpu.parallel.energy import energy_smooth_sharded
        from pyamg_tpu.parallel.sharding import _pad_ell, _place_ell, pad_to
        from pyamg_tpu.sparse import SparseELL

        A = poisson((24, 24), format="csr").astype(np.float64)
        C = symmetric_strength_of_connection(A, theta=0.0)
        AggOp, _ = standard_aggregation(sp.csr_matrix(C))
        T, Bc = fit_candidates(AggOp, np.ones((A.shape[0], 1)))
        P_host = energy_prolongation_smoother(
            A, T, C, Bc, None, (False, {}), krylov="cg", maxiter=4,
            tol=1e-8, degree=1, weighting="local")

        mesh = make_mesh(4)
        n_pad = pad_to(A.shape[0], 4)
        A_ell = _place_ell(_pad_ell(SparseELL.from_scipy(
            A, dtype=np.float64), n_pad, n_pad), mesh, "rows")
        P_ell, pattern = energy_smooth_sharded(
            A_ell, sp.csr_matrix(T), sp.csr_matrix(C), Bc, mesh, "rows",
            degree=1, maxiter=4, tol=1e-8, weighting="local",
            dt=np.float64)
        got = P_ell.to_scipy()[:A.shape[0], :T.shape[1]].tocsr()
        got.sort_indices()
        ref = sp.csr_matrix(P_host)
        ref.sort_indices()
        # same pattern (modulo explicit zeros the device slab keeps)
        diff = abs(got - ref)
        assert diff.max() < 1e-9 * max(abs(ref).max(), 1)

    def test_mesh_count_consistency_and_solve(self):
        from pyamg_tpu.parallel import make_mesh, general_sa_setup_sharded

        A = poisson((32, 32), format="csr")
        b = np.ones(A.shape[0])
        Ps = {}
        for nd in (1, 4):
            sol = general_sa_setup_sharded(
                A, mesh=make_mesh(nd), max_coarse=20,
                smooth=("energy", {"maxiter": 4}), dtype=np.float64)
            res = []
            x = sol.solve(b, tol=1e-10, maxiter=100, accel="cg",
                          residuals=res)
            rr = (np.linalg.norm(b - A @ np.asarray(x, dtype=float))
                  / np.linalg.norm(b))
            assert rr < 1e-9
            assert len(res) - 1 <= 14
            Ps[nd] = np.asarray(sol.inner.levels[0].P.data)
        assert np.abs(Ps[1] - Ps[4]).max() < 1e-12


class TestDistributedRootnodeAdaptive:
    """Mesh-constructed rootnode + adaptive legs (parallel/setup.py,
    reference rootnode.py:316 / adaptive.py:363)."""

    def test_rootnode_mesh_consistency_and_quality(self):
        from pyamg_tpu.parallel import make_mesh, rootnode_setup_sharded

        A = poisson((32, 32), format="csr")
        b = np.ones(A.shape[0])
        Ps = {}
        for nd in (1, 4):
            sol = rootnode_setup_sharded(A, mesh=make_mesh(nd),
                                         max_coarse=20, dtype=np.float64)
            res = []
            x = sol.solve(b, tol=1e-10, maxiter=100, accel="cg",
                          residuals=res)
            rr = (np.linalg.norm(b - A @ np.asarray(x, dtype=float))
                  / np.linalg.norm(b))
            assert rr < 1e-9
            assert len(res) - 1 <= 14     # host rootnode: 10
            Ps[nd] = np.asarray(sol.inner.levels[0].P.data)
        assert np.abs(Ps[1] - Ps[4]).max() < 1e-12

    def test_rootnode_rap_is_galerkin(self):
        import scipy.sparse as sp
        from pyamg_tpu.parallel import make_mesh, rootnode_setup_sharded

        A = poisson((24, 24), format="csr")
        sol = rootnode_setup_sharded(A, mesh=make_mesh(4), max_coarse=20,
                                     dtype=np.float64)
        n = A.shape[0]
        nc = sol.inner.levels[1].A_csr.shape[0]
        P = sol.inner.levels[0].P.to_scipy()[:n, :nc]
        Ac = sol.inner.levels[1].A_csr
        d = abs(Ac.astype(np.float64) - (P.T @ sp.csr_matrix(A) @ P))
        assert (d.max() if d.nnz else 0.0) < 1e-11 * abs(Ac).max()

    def test_adaptive_mesh_consistency(self):
        from pyamg_tpu.parallel import make_mesh, adaptive_sa_setup_sharded

        A = poisson((32, 32), format="csr")
        b = np.ones(A.shape[0])
        iters = {}
        for nd in (1, 4):
            sol = adaptive_sa_setup_sharded(
                A, mesh=make_mesh(nd), max_coarse=20, num_candidates=1,
                candidate_iters=10, dtype=np.float64)
            res = []
            x = sol.solve(b, tol=1e-10, maxiter=200, accel="cg",
                          residuals=res)
            rr = (np.linalg.norm(b - A @ np.asarray(x, dtype=float))
                  / np.linalg.norm(b))
            assert rr < 1e-9
            iters[nd] = len(res) - 1
        # identical candidates (same seed, same program) -> same hierarchy
        assert iters[1] == iters[4]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestHaloELL:
    """Halo-compacted sharded SpMV (parallel/halo.py): bitwise parity with
    the full-gather form, and the fine level actually rides the pack."""

    def test_matvec_bitwise_square_and_rect(self):
        from pyamg_tpu.parallel.halo import build_halo_ell
        from pyamg_tpu.parallel.sharding import _pad_ell, _place_ell, pad_to
        from pyamg_tpu.sparse import SparseELL

        A = poisson((40, 37), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=20)
        P = ml.levels[0].P_csr
        mesh = make_mesh(8)
        ax = mesh.axis_names[0]
        rng = np.random.default_rng(3)
        for M, (nr, nc) in [(A, A.shape), (P, P.shape), (P.T.tocsr(),
                                                         P.T.shape)]:
            n_pad, m_pad = pad_to(nr, 8), pad_to(nc, 8)
            E = _pad_ell(SparseELL.from_scipy(M), n_pad, m_pad)
            Hd = build_halo_ell(E, mesh, ax, force=True)
            assert Hd is not None
            G = _place_ell(E, mesh, ax)
            x = np.zeros(m_pad)
            x[:nc] = rng.standard_normal(nc)
            from jax.sharding import NamedSharding, PartitionSpec
            xd = jax.device_put(x, NamedSharding(mesh, PartitionSpec(ax)))
            yh = np.asarray(Hd.matvec(xd))
            yg = np.asarray(G.matvec(xd))
            # the pack reads exactly the values the global gather read;
            # XLA may still schedule the two programs with different
            # FMA/reassociation -> ulp-level tolerance, not bitwise
            assert np.allclose(yh, yg, rtol=1e-13, atol=1e-15)
            ref = M @ x[:nc]
            assert np.allclose(yh[:nr], ref, rtol=1e-12, atol=1e-14)

    def test_solve_pack_vs_gather(self):
        # big enough that the fine levels genuinely ride the pack (see
        # test_fine_level_is_halo); the two solves agree to solver
        # tolerance and take the same iteration count
        A = poisson((96, 96), format="csr")
        b = np.random.default_rng(5).standard_normal(A.shape[0])
        for build in (
                lambda: pyamg_tpu.smoothed_aggregation_solver(
                    A, max_coarse=30),
                lambda: pyamg_tpu.ruge_stuben_solver(A, max_coarse=30)):
            ml = build()
            sp_ = shard_solver(ml, n_devices=8, halo="pack")
            from pyamg_tpu.parallel.halo import HaloELL
            assert isinstance(sp_.levels[0].A, HaloELL)
            sg = shard_solver(ml, n_devices=8, halo="gather")
            rp, rg = [], []
            xp = sp_.solve(b, tol=1e-10, maxiter=40, accel="cg",
                           residuals=rp)
            xg = sg.solve(b, tol=1e-10, maxiter=40, accel="cg",
                          residuals=rg)
            assert len(rp) == len(rg)
            assert np.allclose(xp, xg, atol=1e-8)
            assert np.linalg.norm(b - A @ xp) < 1e-8 * np.linalg.norm(b)

    def test_fine_level_is_halo(self):
        from pyamg_tpu.parallel.halo import HaloELL

        A = poisson((96, 96), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=20)
        sml = shard_solver(ml, n_devices=8)
        assert isinstance(sml.levels[0].A, HaloELL)
        assert isinstance(sml.levels[0].P, HaloELL)
        # 1-D row shards of a 96x96 grid: the halo is a couple of boundary
        # grid rows per shard, far under the 9216-entry vector
        assert sml.levels[0].A.halo_width <= 3 * 96
