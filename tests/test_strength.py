"""Strength-of-connection tests vs directly-computed references."""

import numpy as np
import pytest
import scipy.sparse as sp

from pyamg_tpu.gallery import poisson, stencil_grid, diffusion_stencil_2d
from pyamg_tpu import strength


def rng():
    return np.random.default_rng(0)


class TestClassical:
    def test_theta_zero_keeps_pattern(self):
        A = poisson((8, 8), format="csr")
        S = strength.classical_strength_of_connection(A, 0.0)
        assert (S.indptr == A.indptr).all()

    def test_threshold_reference(self):
        """Direct check of |A_ij| >= theta*max_{k!=i}|A_ik| row by row."""
        A = stencil_grid(
            diffusion_stencil_2d(epsilon=0.01, theta=0.4, type="FD"),
            (10, 10), format="csr")
        theta = 0.25
        S = strength.classical_strength_of_connection(A, theta)
        Ad = A.toarray()
        Sd = S.toarray()
        n = A.shape[0]
        for i in range(n):
            off = np.abs(np.delete(Ad[i], i))
            m = off.max()
            for j in range(n):
                if i == j:
                    continue
                if Ad[i, j] != 0 and np.abs(Ad[i, j]) >= theta * m:
                    assert Sd[i, j] != 0, (i, j)
                else:
                    assert Sd[i, j] == 0, (i, j)

    def test_rows_scaled_to_one(self):
        A = poisson((10, 10), format="csr")
        S = strength.classical_strength_of_connection(A, 0.1)
        mx = np.zeros(S.shape[0])
        rows = np.repeat(np.arange(S.shape[0]), np.diff(S.indptr))
        np.maximum.at(mx, rows, np.abs(S.data))
        assert np.allclose(mx[mx > 0], 1.0)

    def test_invalid_theta(self):
        A = poisson((5, 5), format="csr")
        with pytest.raises(ValueError):
            strength.classical_strength_of_connection(A, -1)


class TestSymmetric:
    def test_threshold_reference(self):
        A = stencil_grid(
            diffusion_stencil_2d(epsilon=0.01, theta=0.0, type="FD"),
            (10, 10), format="csr")
        theta = 0.5
        S = strength.symmetric_strength_of_connection(A, theta)
        Ad = A.toarray()
        Sd = S.toarray()
        d = np.abs(np.diag(Ad))
        n = A.shape[0]
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                expect = (Ad[i, j] != 0 and
                          np.abs(Ad[i, j]) >= theta * np.sqrt(d[i] * d[j]))
                assert (Sd[i, j] != 0) == expect, (i, j)

    def test_bsr_amalgamation(self):
        from pyamg_tpu.gallery import linear_elasticity

        A, B = linear_elasticity((6, 6))
        S = strength.symmetric_strength_of_connection(A, 0.1)
        assert S.shape[0] == A.shape[0] // 2


class TestEvolution:
    def test_poisson_scalar(self):
        A = poisson((10, 10), format="csr")
        S = strength.evolution_strength_of_connection(
            A, np.ones((A.shape[0], 1)))
        assert S.shape == A.shape
        assert (S.diagonal() > 0).all()
        # strength on Poisson should connect grid neighbors
        assert S.nnz >= A.nnz // 2

    def test_anisotropic_prefers_strong_direction(self):
        sten = diffusion_stencil_2d(epsilon=1e-4, theta=0.0, type="FD")
        A = stencil_grid(sten, (12, 12), format="csr")
        S = strength.evolution_strength_of_connection(
            A, np.ones((A.shape[0], 1)), epsilon=4.0)
        Sd = S.toarray()
        # interior node: the -1 couplings sit on axis 0 (offset ±12);
        # the 1e-4 couplings (offset ±1) must be dropped
        i = 5 * 12 + 5
        assert Sd[i, i - 12] > 0 and Sd[i, i + 12] > 0
        assert Sd[i, i - 1] == pytest.approx(0.0, abs=1e-8)
        assert Sd[i, i + 1] == pytest.approx(0.0, abs=1e-8)

    def test_multivector_B(self):
        A = poisson((8, 8), format="csr")
        n = A.shape[0]
        B = np.ones((n, 2))
        B[:, 1] = rng().standard_normal(n)
        S = strength.evolution_strength_of_connection(A, B)
        assert S.shape == A.shape
        assert np.isfinite(S.data).all()

    def test_invalid_args(self):
        A = poisson((5, 5), format="csr")
        with pytest.raises(ValueError):
            strength.evolution_strength_of_connection(A, epsilon=0.5)
        with pytest.raises(ValueError):
            strength.evolution_strength_of_connection(A, k=0)


class TestDistanceMeasures:
    def test_distance_strength(self):
        from pyamg_tpu.gallery import regular_triangle_mesh, load_example

        data = load_example("unit_square")
        A = data["A"].tocsr()
        V = data["vertices"]
        S = strength.distance_strength_of_connection(A, V)
        assert S.shape == A.shape
        assert (S.diagonal() != 0).all()

    def test_affinity_and_algebraic(self):
        A = poisson((12, 12), format="csr")
        for fn in (strength.affinity_distance, strength.algebraic_distance):
            S = fn(A, seed=0)
            assert S.shape == A.shape
            assert np.isfinite(S.data).all()
            assert (S.diagonal() != 0).all()

    def test_energy_based(self):
        A = poisson((8, 8), format="csr")
        S = strength.energy_based_strength_of_connection(A, theta=0.0, k=2)
        assert S.shape == A.shape
        assert np.isfinite(S.data).all()


class TestSetupNativeKernels:
    """Native host-setup kernels must be bit-identical to the scipy/numpy
    idioms they replace (hierarchy fingerprints depend on them)."""

    def test_pattern_values_matches_multiply(self):
        rng = np.random.default_rng(3)
        from pyamg_tpu.amg_core import pattern_values_native

        A = sp.random(150, 150, density=0.06, format="csr", random_state=5)
        A.sort_indices()
        C = A.copy()
        C.data = np.where(rng.random(C.nnz) < 0.5, 1.0, 0.0)
        C.eliminate_zeros()
        C.sort_indices()
        got = pattern_values_native(C, A)
        if got is None:
            pytest.skip("native library unavailable")
        ref = C.copy()
        ref.data = np.ones_like(ref.data)
        ref = ref.multiply(A).tocsr()
        ref.sort_indices()
        S = sp.csr_matrix((got, C.indices, C.indptr), shape=C.shape)
        assert np.array_equal(S.indices, ref.indices)
        assert np.array_equal(S.data, ref.data)

    def test_pattern_values_missing_entry_falls_back(self):
        from pyamg_tpu.amg_core import pattern_values_native

        A = sp.csr_matrix(np.diag([1.0, 2.0, 3.0]))
        C = sp.csr_matrix(np.array([[1.0, 1.0, 0.0],
                                    [0.0, 1.0, 0.0],
                                    [0.0, 0.0, 1.0]]))
        A.sort_indices()
        C.sort_indices()
        assert pattern_values_native(C, A) is None

    def test_preprocess_strength_structure_matches_reference_idiom(self):
        from pyamg_tpu.classical.split import preprocess_strength

        A = stencil_grid(
            diffusion_stencil_2d(epsilon=0.01, theta=0.3, type="FD"),
            (12, 14), format="csr")
        S2, T2 = preprocess_strength(A)
        ref = A.copy()
        ref.data = np.ones_like(ref.data, dtype=np.float64)
        ref.setdiag(0)
        ref.eliminate_zeros()
        refT = ref.T.tocsr()
        assert np.array_equal(S2.indptr, ref.indptr)
        assert np.array_equal(S2.indices, ref.indices)
        assert np.array_equal(T2.indptr, refT.indptr)
        assert np.array_equal(T2.indices, refT.indices)

    def test_identity_minus_rowscaled_bitwise(self):
        from pyamg_tpu.amg_core import identity_minus_rowscaled_native

        A = poisson((9, 9), format="csr").astype(np.float64)
        A.sort_indices()
        n = A.shape[0]
        Dinv = 1.0 / A.diagonal()
        c = 0.73214
        got = identity_minus_rowscaled_native(A, Dinv, c)
        if got is None:
            pytest.skip("native library unavailable")
        want = (-c) * np.repeat(Dinv, np.diff(A.indptr)) * A.data
        diag_mask = A.indices == np.repeat(np.arange(n), np.diff(A.indptr))
        want[diag_mask] += 1.0
        assert np.array_equal(got, want)

    def test_weak_axis_filter_matches_numpy_decomposition(self):
        from pyamg_tpu.amg_core import weak_axis_filter_native

        for grid, q, block in (((10, 16), 1, (1, 3)),
                               ((16, 10), 1, (3, 1)),
                               ((8, 6), 2, (1, 3))):
            A = stencil_grid(
                diffusion_stencil_2d(epsilon=0.002, theta=0.0, type="FD"),
                grid, format="csr")
            if q > 1:
                A = sp.kron(A, np.eye(q), format="csr")
            A.sort_indices()
            n = A.shape[0]
            strides = [int(np.prod(grid[k + 1:])) for k in range(len(grid))]
            got = weak_axis_filter_native(A, q, strides, block)
            if got is None:
                pytest.skip("native library unavailable")
            rows = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(A.indptr))
            rem = A.indices.astype(np.int64) // q - rows // q
            keep = np.ones(A.nnz, dtype=bool)
            for k in np.argsort(strides)[::-1]:
                s = strides[k]
                dk = np.rint(rem / s).astype(np.int64)
                rem = rem - dk * s
                if block[k] == 1:
                    keep &= dk == 0
            ref = sp.csr_matrix((np.where(keep, A.data, 0),
                                 A.indices.copy(), A.indptr.copy()),
                                shape=A.shape)
            ref.eliminate_zeros()
            if got.nnz and not got.data.all():
                got.eliminate_zeros()
            assert np.array_equal(got.indptr, ref.indptr), (grid, q)
            assert np.array_equal(got.indices, ref.indices), (grid, q)
            assert np.array_equal(got.data, ref.data), (grid, q)
