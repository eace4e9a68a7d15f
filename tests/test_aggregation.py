"""Aggregation-layer tests: aggregate ops, tentative QR, smoothers,
SA/rootnode/adaptive convergence sweeps (reference oracle style:
test_aggregation.py conv factor < 0.9)."""

import numpy as np
import pytest
import scipy.sparse as sp

import pyamg_tpu
from pyamg_tpu.gallery import poisson, linear_elasticity
from pyamg_tpu.aggregation import (standard_aggregation, naive_aggregation,
                                   lloyd_aggregation, fit_candidates,
                                   smoothed_aggregation_solver,
                                   rootnode_solver, adaptive_sa_solver,
                                   asa_solver, newideal_solver)
from pyamg_tpu.aggregation.aggregate import (parallel_aggregation,
                                             grid_aggregation)
from pyamg_tpu.strength import symmetric_strength_of_connection


def rng():
    return np.random.default_rng(0)


def conv_factor(res):
    res = np.asarray(res)
    return (res[-1] / res[0]) ** (1.0 / max(len(res) - 1, 1))


class TestAggregateOps:
    def _strength(self, n=12):
        A = poisson((n, n), format="csr")
        return symmetric_strength_of_connection(A)

    def test_standard_partitions(self):
        C = self._strength()
        AggOp, roots = standard_aggregation(C)
        counts = np.asarray(AggOp.sum(axis=1)).ravel()
        assert (counts <= 1).all()          # each node in <= 1 aggregate
        assert counts.sum() == C.shape[0]   # connected: full coverage
        assert len(roots) == AggOp.shape[1]

    def test_naive_partitions(self):
        C = self._strength()
        AggOp, roots = naive_aggregation(C)
        counts = np.asarray(AggOp.sum(axis=1)).ravel()
        assert (counts == 1).all()

    def test_lloyd(self):
        C = self._strength()
        AggOp, seeds = lloyd_aggregation(C, ratio=0.1)
        assert AggOp.shape[1] == max(1, int(np.ceil(0.1 * C.shape[0])))

    def test_parallel_matches_semantics(self):
        C = self._strength(20)
        AggOp, roots = parallel_aggregation(C)
        counts = np.asarray(AggOp.sum(axis=1)).ravel()
        assert (counts == 1).all()
        # roots are pairwise non-adjacent (distance >= 2)
        G = C.copy()
        G.setdiag(0)
        G.eliminate_zeros()
        sub = G[roots][:, roots]
        assert sub.nnz == 0

    def test_grid_aggregation(self):
        AggOp, roots, cgrid = grid_aggregation((9, 9), (3, 3))
        assert AggOp.shape == (81, 9)
        assert cgrid == (3, 3)
        counts = np.asarray(AggOp.sum(axis=0)).ravel()
        assert (counts == 9).all()

    def test_isolated_node(self):
        C = sp.csr_matrix(np.array([[1., 1, 0], [1, 1, 0], [0, 0, 1]]))
        C.setdiag(1)
        AggOp, roots = standard_aggregation(C.tocsr())
        assert AggOp.shape[0] == 3


class TestFitCandidates:
    def test_reproduces_B(self):
        AggOp = sp.csr_matrix(
            np.array([[1., 0], [1, 0], [0, 1], [0, 1]]))
        B = np.ones((4, 1))
        T, Bc = fit_candidates(AggOp, B)
        assert np.allclose(T @ Bc, B)

    def test_orthonormal_columns(self):
        C = symmetric_strength_of_connection(poisson((10, 10), format="csr"))
        AggOp, _ = standard_aggregation(C)
        n = C.shape[0]
        B = np.column_stack([np.ones(n), rng().standard_normal(n)])
        T, Bc = fit_candidates(AggOp, B)
        TtT = (T.conjugate().T @ T).toarray()
        assert np.allclose(TtT, np.eye(TtT.shape[0]), atol=1e-10)
        assert np.allclose(T @ Bc, B, atol=1e-10)

    def test_blocksize(self):
        AggOp = sp.csr_matrix(np.array([[1., 0], [1, 0], [0, 1], [0, 1]]))
        B = np.kron(np.ones((4, 1)), np.eye(2))   # 8 dofs, 2 candidates
        T, Bc = fit_candidates(AggOp, B)
        assert T.shape == (8, 4)
        assert np.allclose(T @ Bc, B, atol=1e-12)


class TestSAConvergence:
    @pytest.mark.parametrize("opts", [
        {},
        {"strength": "classical"},
        {"strength": ("symmetric", {"theta": 0.25})},
        {"aggregate": "naive"},
        {"smooth": ("richardson", {"omega": 4.0 / 3.0})},
        {"smooth": ("jacobi", {"filter": True})},
        {"smooth": ("energy", {"krylov": "cg", "maxiter": 3})},
        {"smooth": None},
        {"presmoother": ("jacobi", {"iterations": 2}),
         "postsmoother": ("jacobi", {"iterations": 2})},
        {"presmoother": "chebyshev", "postsmoother": "chebyshev"},
        {"improve_candidates": None},
    ])
    def test_poisson_sweep(self, opts):
        A = poisson((20, 20), format="csr")
        np.random.seed(0)
        ml = smoothed_aggregation_solver(A, max_coarse=10, **opts)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.9, opts   # reference oracle bound

    def test_1d(self):
        A = poisson((120,), format="csr")
        ml = smoothed_aggregation_solver(A, max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.9

    def test_elasticity_with_rbm(self):
        A, B = linear_elasticity((12, 12))
        ml = smoothed_aggregation_solver(A.tocsr(), B=B, max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=80, accel="cg", residuals=res)
        assert np.asarray(res)[-1] / np.asarray(res)[0] < 1e-6

    def test_evolution_strength_solver(self):
        A = poisson((16, 16), format="csr")
        ml = smoothed_aggregation_solver(A, strength="evolution",
                                         max_coarse=10)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.9

    def test_nonsymmetric_mode(self):
        from pyamg_tpu.gallery import load_example

        data = load_example("recirc_flow")
        A = data["A"].tocsr()
        ml = smoothed_aggregation_solver(
            A, symmetry="nonsymmetric",
            smooth=("energy", {"krylov": "gmres", "maxiter": 2}),
            presmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
            postsmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
            max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=100, accel="gmres", residuals=res)
        assert res[-1] / res[0] < 1e-4

    def test_complex_structured_transfers_match_host(self):
        # Complex-symmetric vs hermitian structured hierarchies: the device
        # grid transfer ops must agree with the host P_csr/R_csr (for
        # symmetry='symmetric' the host builds R = P.T with NO conjugation,
        # so GridPoolOp must not conjugate wmap either).
        g = (24, 24)
        A = (poisson(g, format="csr") * (1.0 + 0.3j)).tocsr()
        A.grid = g
        rng_ = rng()
        for sym in ("symmetric", "hermitian"):
            ml = smoothed_aggregation_solver(A, symmetry=sym, max_coarse=20)
            for lvl in ml.levels[:-1]:
                assert getattr(lvl, "struct_meta", None) is not None
                assert np.iscomplexobj(lvl.struct_meta["wmap"])
                n_f, n_c = lvl.P_csr.shape
                xf = (rng_.standard_normal(n_f)
                      + 1j * rng_.standard_normal(n_f))
                xc = (rng_.standard_normal(n_c)
                      + 1j * rng_.standard_normal(n_c))
                np.testing.assert_allclose(
                    np.asarray(lvl.R.matvec(xf)), lvl.R_csr @ xf,
                    rtol=1e-12, atol=1e-12)
                np.testing.assert_allclose(
                    np.asarray(lvl.P.matvec(xc)), lvl.P_csr @ xc,
                    rtol=1e-12, atol=1e-12)

    def test_structured_grid_path(self):
        A = poisson((27, 27), format="csr")
        ml = smoothed_aggregation_solver(A, max_coarse=5)
        from pyamg_tpu.sparse import SparseDIA

        assert isinstance(ml.levels[0].A, (SparseDIA,))
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.6


class TestDeviceSetup:
    def test_matches_host_setup(self):
        import jax.numpy as jnp
        from pyamg_tpu.aggregation import structured_sa_setup

        g = (36, 36)
        A = poisson(g, format="csr")
        ml_dev = structured_sa_setup(A, g, dtype=jnp.float64)
        ml_host = smoothed_aggregation_solver(
            A, max_coarse=200, improve_candidates=None,
            presmoother=("gauss_seidel", {"sweep": "symmetric"}),
            postsmoother=("gauss_seidel", {"sweep": "symmetric"}))
        assert [l.A.shape[0] for l in ml_dev.levels] == \
            [l.A.shape[0] for l in ml_host.levels]
        Ad = ml_dev.levels[1].A.to_scipy().toarray()
        Ah = ml_host.levels[1].A_csr.toarray()
        # only the spectral-radius estimate differs (power vs Arnoldi)
        assert np.abs(Ad - Ah).max() < 0.05 * np.abs(Ah).max()

    def test_device_setup_solves(self):
        import jax.numpy as jnp
        from pyamg_tpu.aggregation import structured_sa_setup

        g = (32, 32)
        A = poisson(g, format="csr")
        ml = structured_sa_setup(A, g, dtype=jnp.float64)
        b = rng().standard_normal(A.shape[0])
        res = []
        x = ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
        assert np.linalg.norm(b - A @ np.asarray(x)) < \
            1e-6 * np.linalg.norm(b)
        assert len(res) - 1 < 25

    def test_3d(self):
        import jax.numpy as jnp
        from pyamg_tpu.aggregation import structured_sa_setup

        g = (12, 12, 12)
        A = poisson(g, format="csr")
        ml = structured_sa_setup(A, g, max_coarse=50, dtype=jnp.float64)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=80, residuals=res)
        assert conv_factor(res) < 0.9


class TestRootnode:
    def test_poisson(self):
        A = poisson((16, 16), format="csr")
        A.grid = None    # force the generic (unstructured) path
        ml = rootnode_solver(A, max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.9

    def test_elasticity(self):
        A, B = linear_elasticity((8, 8))
        ml = rootnode_solver(A.tocsr(), B=B, max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=80, accel="cg", residuals=res)
        assert res[-1] / res[0] < 1e-5

    def test_elasticity_blocked_multilevel(self):
        # regression: blocked (BSR) rootnode used to die in scale_T — the
        # P_I injection aliased every root-node dof onto one coarse column
        # (singular root block), and the coarse blocksize was set to
        # B.shape[1]=3 instead of the constant node blocksize 2, so the
        # 3rd level's root blocks were rank-deficient even with correct
        # injection (reference keeps T.blocksize=(bs,bs) on every level
        # and pinv's the root blocks, rootnode.py:400-414)
        A, B = linear_elasticity((40, 40))
        ml = rootnode_solver(A, B=B, max_coarse=100)
        assert len(ml.levels) >= 3
        assert all(lvl.blocksize == 2 for lvl in ml.levels[:-1])
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=80, accel="cg", residuals=res)
        assert conv_factor(res) < 0.45       # reference oracle: <0.3 @50^2
        assert res[-1] / res[0] < 1e-7


class TestAdaptive:
    def test_adaptive_sa(self):
        A = poisson((16, 16), format="csr")
        ml, work = adaptive_sa_solver(A, num_candidates=2,
                                      candidate_iters=4, max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=60, residuals=res)
        assert conv_factor(res) < 0.9
        assert work > 0

    def test_asa(self):
        A = poisson((16, 16), format="csr")
        ml = asa_solver(A, max_candidates=2, improvement_iters=4,
                        max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=80, residuals=res)
        assert conv_factor(res) < 0.95


class TestNewIdeal:
    def test_newideal_solver(self):
        A = poisson((14, 14), format="csr")
        ml = newideal_solver(A, max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=80, residuals=res)
        assert conv_factor(res) < 0.95


class TestPairwise:
    def test_pairwise_solver(self):
        A = poisson((16, 16), format="csr")
        A.grid = None
        ml = smoothed_aggregation_solver(
            A, aggregate=("pairwise", {"matchings": 2}), max_coarse=20)
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=80, accel="cg", residuals=res)
        assert res[-1] / res[0] < 1e-5

    def test_matchings(self):
        from pyamg_tpu.aggregation.matching import (drake_matching,
                                                    preis_matching,
                                                    notay_matching)

        A = poisson((10, 10), format="csr")
        for fn in (drake_matching, preis_matching, notay_matching):
            m = fn(A)
            # valid matching: symmetric partner assignment
            for i, j in enumerate(m):
                if j >= 0:
                    assert m[j] in (i, -1) or m[j] == i


class TestDeviceSetupValidation:
    """Comb-probe RAP exactness guards."""

    def test_degree_vs_block_guard(self):
        import jax.numpy as jnp
        from pyamg_tpu.aggregation import structured_sa_setup

        A = poisson((27, 27), format="csr")
        with pytest.raises(ValueError, match="2\\*degree"):
            structured_sa_setup(A, (27, 27), block=(2, 2), degree=1,
                                dtype=jnp.float64)
        with pytest.raises(ValueError, match="2\\*degree"):
            structured_sa_setup(A, (27, 27), block=(3, 3), degree=2,
                                dtype=jnp.float64)

    def test_wide_stencil_guard(self):
        import jax.numpy as jnp
        import scipy.sparse as sp
        from pyamg_tpu.aggregation import structured_sa_setup

        # 5-point stencil plus a distance-2 band: outside the 3^2 stencil
        A = poisson((27, 27), format="csr")
        n = A.shape[0]
        A2 = sp.csr_matrix(A + 0.1 * sp.diags(np.ones(n - 54), 54))
        with pytest.raises(ValueError, match="outside"):
            structured_sa_setup(A2, (27, 27), dtype=jnp.float64)

    def test_valid_config_still_exact(self):
        import jax.numpy as jnp
        from pyamg_tpu.aggregation import structured_sa_setup

        A = poisson((27, 27), format="csr")
        ml = structured_sa_setup(A, (27, 27), block=(3, 3), degree=1,
                                 dtype=jnp.float64)
        # device RAP == host R@A@P on every level
        for lvl, nxt in zip(ml.levels[:-1], ml.levels[1:]):
            Ah = lvl.A.to_scipy()
            Ph = lvl.P.to_scipy()
            Rh = lvl.R.to_scipy()
            Ac_host = (Rh @ Ah @ Ph).toarray()
            Ac_dev = nxt.A.to_scipy().toarray()
            assert np.abs(Ac_host - Ac_dev).max() < 1e-10 * \
                max(np.abs(Ac_host).max(), 1)


class TestAdaptiveMultilevel:
    """Round-2: full multi-level αSA (reference adaptive.py:363-766 style
    oracles, test_adaptive.py)."""

    def test_initial_stage_descends_all_levels(self):
        from pyamg_tpu.aggregation.adaptive import initial_setup_stage

        A = poisson((32, 32), format="csr")
        x, agg, strg, work = initial_setup_stage(
            A, "hermitian", True, 4, 0.1, 10, 20, "standard",
            ("gauss_seidel", {"sweep": "symmetric"}), ("jacobi", {}),
            "symmetric")
        # aggregates frozen as predefined per-level options, several levels
        assert isinstance(agg, list) and len(agg) >= 2
        assert all(a[0] == "predefined" for a in agg)
        assert all(s[0] == "predefined" for s in strg)
        assert np.linalg.norm(x) > 0 and work > 0

    def test_adaptive_anisotropic(self):
        from pyamg_tpu.gallery.diffusion import diffusion_stencil_2d
        from pyamg_tpu.gallery import stencil_grid

        S = diffusion_stencil_2d(epsilon=0.001, theta=np.pi / 8, type="FD")
        A = stencil_grid(S, (36, 36), format="csr")
        ml, work = adaptive_sa_solver(A, num_candidates=2,
                                      candidate_iters=6, max_coarse=20)
        b = np.zeros(A.shape[0])
        x0 = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, x0=x0, maxiter=30, tol=1e-300, residuals=res)
        assert conv_factor(res) < 0.8

    def test_adaptive_gauge_laplacian_complex(self):
        from pyamg_tpu.gallery import gauge_laplacian
        import scipy.sparse as sp

        A = sp.csr_matrix(gauge_laplacian(12, beta=0.1))
        ml, _ = adaptive_sa_solver(A, num_candidates=2, candidate_iters=6,
                                   max_coarse=20)
        b = np.zeros(A.shape[0], dtype=complex)
        x0 = rng().standard_normal(A.shape[0]) + \
            1j * rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, x0=x0, maxiter=30, tol=1e-300, residuals=res)
        assert conv_factor(res) < 0.5

    def test_eliminate_local_candidates(self):
        from pyamg_tpu.aggregation.adaptive import eliminate_local_candidates
        from pyamg_tpu.aggregation import standard_aggregation, fit_candidates
        from pyamg_tpu.strength import symmetric_strength_of_connection

        A = poisson((24, 24), format="csr")
        C = symmetric_strength_of_connection(A)
        AggOp, _ = standard_aggregation(C)
        B = np.ones((A.shape[0], 1))
        T, _ = fit_candidates(AggOp, B)
        # constant vector: well represented by T everywhere -> all dropped
        x = np.ones(A.shape[0])
        eliminate_local_candidates(x, AggOp, A, T, Ca=100.0)
        assert np.abs(x).max() == 0.0
        # rough random vector with large threshold disabled -> survives
        x2 = rng().standard_normal(A.shape[0])
        x2c = x2.copy()
        eliminate_local_candidates(x2, AggOp, A, T, Ca=1e-12)
        assert np.abs(x2 - x2c).max() == 0.0

    def test_adaptive_with_elimination_converges(self):
        A = poisson((24, 24), format="csr")
        ml, _ = adaptive_sa_solver(A, num_candidates=2, candidate_iters=4,
                                   max_coarse=20,
                                   eliminate_local=(True, {"Ca": 1.0}))
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=40, residuals=res)
        assert conv_factor(res) < 0.7


class TestRecursiveASA:
    """Round-2: recursive try_solve + Ritz filtering (reference
    new_adaptive.py:523,254)."""

    def test_local_ritz_basis_properties(self):
        from pyamg_tpu.aggregation.new_adaptive import local_ritz_process
        from pyamg_tpu.aggregation import standard_aggregation
        from pyamg_tpu.strength import symmetric_strength_of_connection

        A = poisson((16, 16), format="csr")
        C = symmetric_strength_of_connection(A)
        AggOp, _ = standard_aggregation(C)
        B = np.column_stack([np.ones(A.shape[0]),
                             rng().standard_normal(A.shape[0])])
        T, counts = local_ritz_process(A, AggOp, B, weak_tol=15.0)
        assert T.shape[0] == A.shape[0]
        assert counts.min() >= 1 and counts.max() <= 2
        # per-aggregate columns have unit norm and are orthogonal
        G = (T.conjugate().T @ T).toarray()
        assert np.allclose(np.diag(G), 1.0, atol=1e-8)
        assert np.abs(G - np.diag(np.diag(G))).max() < 1e-8

    def test_recursive_asa_adds_targets_per_level(self):
        from pyamg_tpu.aggregation import asa_solver

        A = poisson((32, 32), format="csr")
        ml = asa_solver(A, conv_tol=0.35, max_coarse=20, max_targets=3)
        # at least one level should have discovered more than one target
        widths = [l.B.shape[1] for l in ml.levels[:-1] if hasattr(l, "B")]
        assert max(widths) >= 2
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-8, maxiter=40, residuals=res)
        assert conv_factor(res) < 0.6


class TestMaskedSpGEMM:
    """Round-2: pattern-restricted product on the energy-min hot path
    (≙ incomplete_mat_mult_bsr, smoothed_aggregation.h:797)."""

    def test_masked_equals_product_then_mask(self):
        import scipy.sparse as sp
        from pyamg_tpu.aggregation.smooth import _masked_product

        X = sp.random(300, 200, 0.05, format="csr", random_state=3)
        X.data += 1.0
        Y = sp.random(200, 80, 0.08, format="csr", random_state=4)
        Y.data += 1.0
        pat = sp.random(300, 80, 0.1, format="csr", random_state=5)
        pat.data[:] = 1.0
        C1 = _masked_product(X, Y, pat)
        C2 = (X @ Y).tocsr().multiply(pat).tocsr()
        assert abs(C1 - C2).max() < 1e-13
        # every output entry lies inside the pattern
        outside = C1.multiply(pat) - C1
        assert abs(outside).max() if outside.nnz else 0.0 == 0.0

    def test_energy_smoothing_on_bsr_elasticity(self):
        """Blocked operators + RBM near-nullspace through the energy path
        (BASELINE config 4 shape)."""
        A, B = linear_elasticity((24, 24))
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, B=B, smooth="energy", max_coarse=30)
        b = rng().standard_normal(A.shape[0])
        res = []
        x = ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
        assert np.linalg.norm(b - A @ x) < 1e-6 * np.linalg.norm(b)
        assert conv_factor(res) < 0.7


class TestBlockedEnergyCG:
    """Round-3: the energy CG on node-blocked operators runs entirely in
    BSR block form (smooth.py _cg_prolongation_bsr; role of the reference's
    incomplete_mat_mult_bsr energy loop, smoothed_aggregation.h:797) —
    must agree with the scalar flat path to machine epsilon."""

    def _pieces(self):
        from pyamg_tpu.aggregation.tentative import fit_candidates

        A, B = linear_elasticity((20, 20))
        Ab = A.tobsr(blocksize=(2, 2)).astype(np.float64)
        C = symmetric_strength_of_connection(Ab, theta=0.0)   # node level
        AggOp, _ = standard_aggregation(C)
        Agg_dof = sp.kron(AggOp, np.ones((2, 1))).tocsr()
        T, Bc = fit_candidates(Agg_dof, np.asarray(B))
        return Ab, sp.csr_matrix(T), C, np.asarray(Bc)

    def test_blocked_matches_scalar_flat(self):
        from pyamg_tpu.aggregation import smooth as SM
        from pyamg_tpu.util.utils import unamal, compute_BtBinv

        Ab, T, C, Bc = self._pieces()
        P_bsr = SM._cg_prolongation_bsr(Ab, T, C, Bc, 3, 1e-8, 1, "local")
        assert P_bsr is not None

        pattern = SM._grow_pattern(unamal(C, 2, 2), T, 1)
        BtBinv = compute_BtBinv(Bc, pattern)
        Acsr = Ab.tocsr()
        Dv = np.asarray(abs(Acsr).sum(axis=1)).ravel()
        Dinv = np.where(Dv != 0, 1.0 / np.where(Dv != 0, Dv, 1), 0.0)
        P_flat = SM._cg_prolongation_flat(Acsr, T, pattern, Bc, BtBinv,
                                          Dinv, None, 3, 1e-8)
        assert P_flat is not None
        assert P_bsr.nnz == P_flat.nnz     # block-dense closure == scalar
        assert abs(P_bsr - P_flat).max() < 1e-12 * abs(P_flat).max()

    def test_diagonal_weighting_matches(self):
        from pyamg_tpu.aggregation import smooth as SM
        from pyamg_tpu.util.utils import unamal, compute_BtBinv
        from pyamg_tpu.util.utils import get_diagonal

        Ab, T, C, Bc = self._pieces()
        P_bsr = SM._cg_prolongation_bsr(Ab, T, C, Bc, 2, 1e-8, 1,
                                        "diagonal")
        pattern = SM._grow_pattern(unamal(C, 2, 2), T, 1)
        BtBinv = compute_BtBinv(Bc, pattern)
        Acsr = Ab.tocsr()
        Dinv = get_diagonal(Acsr, inv=True)
        P_flat = SM._cg_prolongation_flat(Acsr, T, pattern, Bc, BtBinv,
                                          Dinv, None, 2, 1e-8)
        assert abs(P_bsr - P_flat).max() < 1e-12 * abs(P_flat).max()

    def test_hierarchy_quality_pinned(self):
        # BASELINE config-4 shape: opc and iterations must not drift
        A, B = linear_elasticity((50, 50))
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A.tobsr(blocksize=(2, 2)), B=B, max_coarse=100,
            smooth=("energy", {"maxiter": 3}))
        opc = sum(lvl.A_csr.nnz for lvl in ml.levels) / ml.levels[0].A_csr.nnz
        assert opc < 1.4
        b = rng().standard_normal(A.shape[0])
        res = []
        ml.solve(b, tol=1e-10, accel="cg", maxiter=40, residuals=res)
        assert len(res) - 1 <= 14


class TestNativeBlockGS:
    def test_native_matches_python_block_gs(self):
        import scipy.sparse as sp
        from pyamg_tpu.relaxation.relaxation import block_gauss_seidel
        from pyamg_tpu.util.utils import get_block_diag

        A, _ = linear_elasticity((10, 10))
        A = A.tocsr()
        b = rng().standard_normal(A.shape[0])
        Dinv = get_block_diag(A, 2, inv_flag=True)
        x1 = rng().standard_normal(A.shape[0])
        x2 = x1.copy()
        block_gauss_seidel(A, x1, b, Dinv=Dinv, blocksize=2, iterations=2,
                           sweep="symmetric")
        # force the python fallback via complex copy
        Ac = sp.csr_matrix(A, dtype=complex)
        x2c = x2.astype(complex)
        block_gauss_seidel(Ac, x2c, b.astype(complex),
                           blocksize=2, iterations=2, sweep="symmetric")
        assert np.allclose(x1, x2c.real, atol=1e-10)
        assert np.abs(x2c.imag).max() < 1e-12


class TestStructuredMultiCandidate:
    """K>1 structured fast path: K-channel grid transfers + banded coarse
    operators must match the host CSR hierarchy exactly.

    Blocked banded levels prefer the FLATTENED scalar-DIA form (a
    uniform-block banded operator is a scalar DIA with n_off*(2q-1)
    diagonals): a streamed shift-multiply-add instead of the BDIA
    einsum's block gathers; BDIA remains the fallback only."""

    def test_device_ops_match_host(self):
        rng = np.random.default_rng(0)
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        from pyamg_tpu.sparse import SparseBDIA, SparseDIA
        from pyamg_tpu.sparse.device_op import DenseOp
        sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
        A = stencil_grid(sten, (32, 32), format="csr")
        n = A.shape[0]
        B = np.stack([np.ones(n), rng.random(n)], axis=1)
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, B=B, max_coarse=30, improve_candidates=None)
        # blocked (q>1) grid levels come out in the flattened scalar
        # form, not the gather/einsum forms
        assert all(isinstance(l.A, (SparseDIA, SparseBDIA, DenseOp))
                   for l in ml.levels)
        assert any(max(getattr(l, "blocksize", 1), 1) > 1
                   and isinstance(l.A, (SparseDIA, DenseOp))
                   for l in ml.levels[1:])
        for i, l in enumerate(ml.levels[:-1]):
            x = rng.standard_normal(l.P_csr.shape[1])
            assert np.allclose(np.asarray(l.P @ x), l.P_csr @ x,
                               atol=1e-10), f"P{i}"
            y = rng.standard_normal(l.R_csr.shape[1])
            assert np.allclose(np.asarray(l.R @ y), l.R_csr @ y,
                               atol=1e-10), f"R{i}"
            z = rng.standard_normal(l.A_csr.shape[1])
            assert np.allclose(np.asarray(l.A @ z), l.A_csr @ z,
                               atol=1e-10), f"A{i}"

    def test_solves(self):
        rng = np.random.default_rng(1)
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
        A = stencil_grid(sten, (64, 64), format="csr")
        n = A.shape[0]
        B = np.stack([np.ones(n), rng.random(n)], axis=1)
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, B=B, max_coarse=100, improve_candidates=None,
            presmoother="zebra", postsmoother="zebra")
        b = np.asarray(A @ rng.random(n))
        res = []
        x = ml.solve(b, tol=1e-8, maxiter=30, accel="cg", residuals=res)
        assert len(res) - 1 <= 10      # zebra + structured: fast on aniso
        assert np.linalg.norm(b - A @ x) < 1e-7 * np.linalg.norm(b)

    def test_adaptive_on_grid_uses_fast_path(self):
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        from pyamg_tpu.sparse import SparseDIA, SparseBDIA
        sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
        A = stencil_grid(sten, (64, 64), format="csr")
        ml, _work = pyamg_tpu.adaptive_sa_solver(
            A, num_candidates=2, max_coarse=50, prepostsmoother="zebra")
        assert isinstance(ml.levels[0].A, SparseDIA)
        assert all(isinstance(l.A, (SparseDIA, SparseBDIA))
                   for l in ml.levels)

    def test_single_candidate_on_blocked_fine_level(self):
        """K=1 with a BSR (q>1) fine level: the grid transfers must use the
        2-D wmap form (regression: 1-D wmap shape mismatch)."""
        from pyamg_tpu.gallery import linear_elasticity
        rng = np.random.default_rng(2)
        A, _B = linear_elasticity((12, 12))
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, B=np.ones((A.shape[0], 1)), max_coarse=30)
        b = rng.standard_normal(A.shape[0])
        Ac = A.tocsr()
        x = ml.solve(b, tol=1e-7, maxiter=60, accel="cg")
        assert np.linalg.norm(b - Ac @ x) < 1e-5 * np.linalg.norm(b)
        for i, l in enumerate(ml.levels[:-1]):
            z = rng.standard_normal(l.P_csr.shape[1])
            assert np.allclose(np.asarray(l.P @ z), l.P_csr @ z,
                               atol=1e-8), f"P{i}"


class TestAutoSemicoarsening:
    """Under strong grid-aligned anisotropy with a line smoother, the
    structured path semicoarsens the weak axis (tentative-only P) and the
    cycle becomes nearly mesh-independent."""

    def test_weak_axis_blocks_and_convergence(self):
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        rng = np.random.default_rng(0)
        sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
        A = stencil_grid(sten, (96, 96), format="csr")
        b = np.asarray(A @ rng.random(A.shape[0]))
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=60, improve_candidates=None,
            presmoother="zebra", postsmoother="zebra")
        # semicoarsening: first coarse level shrinks ~3x (one axis), not 9x
        n0, n1 = ml.levels[0].A_csr.shape[0], ml.levels[1].A_csr.shape[0]
        assert n1 > n0 // 5          # would be ~n0/9 with (3, 3) blocks
        res = []
        x = ml.solve(b, tol=1e-8, maxiter=30, accel="cg", residuals=res)
        assert len(res) - 1 <= 12
        assert np.linalg.norm(b - A @ x) < 1e-6 * np.linalg.norm(b)

    def test_isotropic_unaffected(self):
        A = poisson((32, 32), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=50, improve_candidates=None,
            presmoother="zebra", postsmoother="zebra")
        n0, n1 = ml.levels[0].A_csr.shape[0], ml.levels[1].A_csr.shape[0]
        assert n1 <= n0 // 8         # full (3, 3) coarsening

    def test_point_smoothers_unaffected(self):
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d
        sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
        A = stencil_grid(sten, (48, 48), format="csr")
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, max_coarse=50, improve_candidates=None)
        n0, n1 = ml.levels[0].A_csr.shape[0], ml.levels[1].A_csr.shape[0]
        assert n1 <= n0 // 8         # no line smoother -> no semicoarsening


class TestAdaptiveRegressions:
    """Regressions from the round-2 code review."""

    def test_k2_aniso_quality(self):
        """K=2 candidates must not DEGRADE the semicoarsened hierarchy:
        weak-axis aggregates stay 3 grid nodes wide for every K (width 3K
        coarsened the weak axis 3K-x per level and lost mesh independence —
        24+ iterations at 512^2), and the general setup stage rebuilds
        enlarged levels with the structured (weak-axis) smoother so the
        candidate is polished in the hierarchy it ends up in (measured 4
        here, 8 at 512^2, 11 at 1024^2; was 6/13/19 with the generic
        full-Jacobi re-smooth)."""
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d

        sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
        A = stencil_grid(sten, (128, 128), format="csr")
        ml, _w = pyamg_tpu.adaptive_sa_solver(
            A, num_candidates=2, candidate_iters=5,
            prepostsmoother="zebra", max_coarse=100)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        res = []
        x = ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
        assert len(res) - 1 <= 7
        assert np.linalg.norm(b - A @ x) < 1e-6 * np.linalg.norm(b)

    def test_k2_full_coarsening_cuts_opc(self):
        """With zebra line relaxation
        carrying the strong axis, FULL (3, 3) grid aggregation holds the
        K=2 iteration count (6 at 256^2, 10 vs 11 at 1024^2) while
        cutting opc 4.55 -> 1.90 — below the reference's 2.35 on the
        aniso-1024 column (benchmarks/reference_harness/our_k2.py)."""
        from pyamg_tpu.gallery import stencil_grid, diffusion_stencil_2d

        sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
        A = stencil_grid(sten, (128, 128), format="csr")
        ml, _w = pyamg_tpu.adaptive_sa_solver(
            A, num_candidates=2, candidate_iters=5,
            prepostsmoother="zebra",
            aggregate=("grid", {"block": (3, 3)}), max_coarse=100)
        assert float(ml.operator_complexity()) < 2.1
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        res = []
        x = ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
        assert len(res) - 1 <= 7
        assert np.linalg.norm(b - A @ x) < 1e-6 * np.linalg.norm(b)

    def test_improvement_iters_multicandidate_returns_device_solver(self):
        A = poisson((20, 20), format="csr")
        ml, _w = pyamg_tpu.adaptive_sa_solver(
            A, num_candidates=2, improvement_iters=1, max_coarse=40)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        x = ml.solve(b, tol=1e-7, maxiter=40)
        assert np.linalg.norm(b - A @ x) < 1e-5 * np.linalg.norm(b)

    def test_sweepless_prepostsmoother(self):
        A = poisson((20, 20), format="csr")
        ml, _w = pyamg_tpu.adaptive_sa_solver(
            A, prepostsmoother="jacobi", max_coarse=40)
        b = np.random.default_rng(1).standard_normal(A.shape[0])
        x = ml.solve(b, tol=1e-6, maxiter=40)
        assert np.linalg.norm(b - A @ x) < 1e-4 * np.linalg.norm(b)


class TestRootEmbeddedTransfers:
    """Aggregate-root DIA embedding of general-path SA/rootnode transfers
    (sparse/embed.py): coarse dof agg*K+k is re-indexed to fine dof
    roots[agg]*q+k, turning P/R into banded (n x n) stencil operators plus
    an n_c scatter/gather — no per-entry gathers in the cycle."""

    def _check_level(self, lvl, rng_seed=0, tol=1e-12):
        x = np.random.default_rng(rng_seed).standard_normal(
            lvl.P_csr.shape[1])
        if np.iscomplexobj(lvl.P_csr.data):
            x = x + 1j * np.random.default_rng(rng_seed + 7).\
                standard_normal(lvl.P_csr.shape[1])
        r = np.random.default_rng(rng_seed + 1).standard_normal(
            lvl.R_csr.shape[1])
        if np.iscomplexobj(lvl.R_csr.data):
            r = r + 1j * np.random.default_rng(rng_seed + 8).\
                standard_normal(lvl.R_csr.shape[1])
        errP = np.abs(np.asarray(lvl.P @ x) - lvl.P_csr @ x).max()
        errR = np.abs(np.asarray(lvl.R @ r) - lvl.R_csr @ r).max()
        assert errP < tol
        assert errR < tol

    def test_sa_general_path_embeds(self):
        from pyamg_tpu.sparse.linop import CptProlongOp, CptRestrictOp
        # 17^3 = 4913 > DENSE_MAX so level 0 embeds (3D -> general path)
        A = poisson((17, 17, 17), format="csr")
        ml = smoothed_aggregation_solver(A)
        lvl = ml.levels[0]
        assert isinstance(lvl.P, CptProlongOp)
        assert isinstance(lvl.R, CptRestrictOp)
        for lv in ml.levels[:-1]:
            self._check_level(lv)
        b = np.asarray(A @ rng().random(A.shape[0]))
        res = []
        x = ml.solve(b, tol=1e-8, residuals=res)
        assert conv_factor(res) < 0.35

    def test_sa_complex_hermitian_embed(self):
        A = sp.csr_matrix(poisson((10, 10, 10), format="csr")).astype(complex)
        ml = smoothed_aggregation_solver(A, symmetry="hermitian")
        for lv in ml.levels[:-1]:
            self._check_level(lv)

    def test_sa_nonsymmetric_explicit_R_embed(self):
        A = sp.csr_matrix(poisson((24, 24), format="csr"))
        A = (A + sp.diags(0.05 * np.random.default_rng(5)
                          .standard_normal(A.shape[0]))).tocsr()
        ml = smoothed_aggregation_solver(A, symmetry="nonsymmetric",
                                         smooth="jacobi")
        for lv in ml.levels[:-1]:
            self._check_level(lv, tol=1e-11)

    def test_rootnode_embeds(self):
        from pyamg_tpu.sparse.linop import CptProlongOp
        # 72^2 = 5184 > DENSE_MAX so level 0 embeds
        A = sp.csr_matrix(poisson((72, 72), format="csr"))
        ml = rootnode_solver(A)
        assert isinstance(ml.levels[0].P, CptProlongOp)

    def test_tiny_levels_stay_dense(self):
        # below DENSE_MAX a single matmul beats the DIA scatter form,
        # so root embedding must decline and leave device_operator's choice
        from pyamg_tpu.sparse.linop import DenseOp
        A = poisson((12, 12, 12), format="csr")
        ml = smoothed_aggregation_solver(A)
        assert isinstance(ml.levels[0].P, DenseOp)
        for lv in ml.levels[:-1]:
            self._check_level(lv, tol=1e-10)
        b = np.asarray(A @ rng().random(A.shape[0]))
        res = []
        ml.solve(b, tol=1e-8, residuals=res)
        assert conv_factor(res) < 0.3

    def test_blocked_coarse_levels_embed_when_K_matches(self):
        # K=2 candidates on a scalar fine level: level 0 (q=1, K=2) cannot
        # embed; coarse levels (q=K=2) can when banded enough
        A = poisson((48, 48), format="csr")
        A = sp.csr_matrix(A)                  # strip grid metadata
        B = np.ones((A.shape[0], 2)); B[:, 1] = np.arange(A.shape[0]) % 7
        ml = smoothed_aggregation_solver(A, B=B, improve_candidates=None)
        assert not hasattr(ml.levels[0], "root_dofs")
        for lv in ml.levels[:-1]:
            self._check_level(lv, tol=1e-11)
