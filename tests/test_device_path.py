"""Operators, products and scripts of the device path, checked on the CPU.

* ``SparseDIA.matvec`` and ``masked_spgemm_ell`` against scipy in float64;
* every float32 contraction of the solve path pins ``HIGHEST`` precision
  (a GPU otherwise runs float32 ``dot_general`` in TF32);
* the compile-cache helper leaves ``JAX_COMPILATION_CACHE_DIR`` alone;
* ``chip_smoke.py`` refuses a CPU-only process, and its phases pass at
  tiny sizes here.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from pyamg_tpu.gallery import poisson
from pyamg_tpu.sparse import SparseDIA
from pyamg_tpu.sparse.ell import SparseELL
from pyamg_tpu.sparse.spgemm_device import (masked_spgemm_ell,
                                            pattern_spgemm, rap_pattern)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_from_repo(name):
    """A script-side module from the checkout's root (not the library)."""
    import importlib

    sys.path.insert(0, REPO)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(REPO)


# ---------------------------------------------------------------------------
# DIA SpMV
# ---------------------------------------------------------------------------

def _dia_cases():
    rng = np.random.default_rng(0)
    A1 = poisson((512, 512), format="csr")
    A2 = poisson((300, 257), format="csr")
    n2 = A2.shape[0]
    A2 = sp.csr_matrix(A2
                       + 0.3 * sp.diags(rng.random(n2 - 258), 258)
                       + 0.2 * sp.diags(rng.random(n2 - 127), -127)
                       + 0.1 * sp.diags(rng.random(n2 - 5), 5))
    A3 = poisson((70001,), format="csr")
    return [A1, A2, A3]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("idx", [0, 1, 2])
def test_dia_matvec_matches_scipy(idx, dtype):
    A = _dia_cases()[idx]
    D = SparseDIA.from_scipy(A, dtype=dtype)
    x = np.random.default_rng(1).random(A.shape[0]).astype(dtype)
    y = np.asarray(jax.jit(lambda D, x: D.matvec(x))(D, jnp.asarray(x)),
                   dtype=np.float64)
    y_ref = A.astype(np.float64) @ x.astype(np.float64)
    # a float32 sum of k <= 8 products: a few ulps of the largest term
    tol = 1e-6 if dtype == np.float32 else 1e-14
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < tol


# ---------------------------------------------------------------------------
# masked SpGEMM
# ---------------------------------------------------------------------------

def _banded_random(n, m, bw, nnz_per_row=5, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = np.clip((rows * m) // n
                   + rng.integers(-bw, bw + 1, size=rows.size), 0, m - 1)
    A = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(n, m)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


def _banded_square(n, offsets, drop=0.1, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        keep = rng.random(i.size) > drop
        rows.append(i[keep])
        cols.append((i + off)[keep])
        vals.append(rng.standard_normal(keep.sum()))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    A.sort_indices()
    return A


def _spgemm_operands(case):
    if case == "5pt":
        return (_banded_square(3000, [-50, -1, 0, 1, 50], seed=1),
                _banded_random(3000, 900, 3, nnz_per_row=3, seed=2))
    if case == "9pt":
        return (_banded_square(2000, [-45, -44, -43, -1, 0, 1, 43, 44, 45],
                               seed=3),
                _banded_random(2000, 2000, 5, seed=4))
    if case == "wideA":
        # A wider than tall: B rows beyond A's row count are still read
        return (_banded_square(2200, [-2, 0, 2, 700], seed=5).tocsr()[:1500],
                _banded_random(2200, 500, 4, nnz_per_row=4, seed=6))
    if case == "multitile":
        return (_banded_square(30000, [-1500, -1, 0, 1, 1500], seed=7),
                _banded_random(30000, 10000, 6, seed=8))
    if case == "chain_rect":
        return (_banded_random(300, 200, 8, seed=1),
                _banded_random(200, 150, 5, seed=2))
    assert case == "chain_wide"
    return (_banded_random(700, 700, 40, seed=1),
            _banded_random(700, 300, 20, seed=2))


def _assert_product(C, A_csr, B_csr, tol=1e-5):
    C_true = A_csr.astype(np.float32).astype(np.float64) @ \
        B_csr.astype(np.float32).astype(np.float64)
    got = C.to_scipy().astype(np.float64)
    scale = abs(C_true).max()
    assert abs(got - C_true).max() / scale < tol


@pytest.mark.parametrize("case", ["5pt", "9pt", "wideA", "multitile",
                                  "chain_rect", "chain_wide"])
def test_masked_spgemm_matches_scipy(case):
    A_csr, B_csr = _spgemm_operands(case)
    A = SparseELL.from_scipy(A_csr, dtype=np.float32)
    B = SparseELL.from_scipy(B_csr, dtype=np.float32)
    pat = pattern_spgemm(A_csr, B_csr, dtype=np.float32)
    _assert_product(masked_spgemm_ell(A, B, pat), A_csr, B_csr)


def test_masked_spgemm_pattern_reuse_fresh_values():
    # same structure, new values: the host pattern is reused unchanged
    A_csr = _banded_square(1000, [-30, 0, 30], seed=9)
    B_csr = _banded_random(1000, 400, 4, seed=10)
    pat = pattern_spgemm(A_csr, B_csr, dtype=np.float32)
    B = SparseELL.from_scipy(B_csr, dtype=np.float32)
    masked_spgemm_ell(SparseELL.from_scipy(A_csr, dtype=np.float32), B, pat)
    A2_csr = A_csr.copy()
    A2_csr.data = np.random.default_rng(11).standard_normal(A_csr.nnz)
    out = masked_spgemm_ell(SparseELL.from_scipy(A2_csr, dtype=np.float32),
                            B, pat)
    _assert_product(out, A2_csr, B_csr)


def test_masked_spgemm_rap_on_rs_hierarchy():
    # the Galerkin use: R (A P) over host-symbolic patterns on a real
    # Ruge-Stuben level
    from pyamg_tpu.classical.classical import ruge_stuben_solver

    A_csr = sp.csr_matrix(poisson((24, 24), format="csr"))
    ml = ruge_stuben_solver(A_csr, max_levels=2, max_coarse=10)
    P_csr = sp.csr_matrix(ml.levels[0].P_csr)
    R_csr = sp.csr_matrix(P_csr.T)
    R_csr.sort_indices()
    pat_AP, pat_RAP = rap_pattern(R_csr, A_csr, P_csr, dtype=np.float32)
    A = SparseELL.from_scipy(A_csr, dtype=np.float32)
    P = SparseELL.from_scipy(P_csr, dtype=np.float32)
    R = SparseELL.from_scipy(R_csr, dtype=np.float32)
    RAP = masked_spgemm_ell(R, masked_spgemm_ell(A, P, pat_AP), pat_RAP)
    RAP_true = (R_csr.astype(np.float64) @ A_csr.astype(np.float64)
                @ P_csr.astype(np.float64))
    got = RAP.to_scipy().astype(np.float64)
    assert abs(got - RAP_true).max() / abs(RAP_true).max() < 1e-5


# ---------------------------------------------------------------------------
# float32 contractions carry HIGHEST precision
# ---------------------------------------------------------------------------

def _elasticity_bsr(nb=12, K=2):
    from pyamg_tpu.gallery import linear_elasticity

    A, _ = linear_elasticity((nb, nb))
    return sp.bsr_matrix(A, blocksize=(K, K))


def _f32_operator(kind):
    from pyamg_tpu.sparse import BlockELL, SparseBDIA
    from pyamg_tpu.sparse.linop import DenseOp, GridRepeatOp

    rng = np.random.default_rng(0)
    if kind == "dense":
        M = rng.standard_normal((64, 64)).astype(np.float32)
        return DenseOp(jnp.asarray(M), M.shape)
    if kind == "bdia":
        return SparseBDIA.from_scipy_bsr(_elasticity_bsr(), dtype=np.float32)
    if kind == "block_ell":
        return BlockELL.from_scipy(_elasticity_bsr(), blocksize=2,
                                   dtype=np.float32)
    assert kind == "grid_repeat_k"
    fine, block, K = (8, 8), (2, 2), 3
    n_f = int(np.prod(fine))
    n_c = int(np.prod([-(-g // b) for g, b in zip(fine, block)])) * K
    wmap = jnp.asarray(rng.standard_normal((n_f, K)).astype(np.float32))
    return GridRepeatOp(wmap=wmap, fine_grid=fine, block=block,
                        shape=(n_f, n_c))


@pytest.mark.parametrize("kind", ["dense", "bdia", "block_ell",
                                  "grid_repeat_k"])
def test_f32_matvec_pins_highest_precision(kind):
    op = _f32_operator(kind)
    x = jnp.ones(op.shape[1], dtype=jnp.float32)
    text = jax.jit(lambda op, x: op.matvec(x)).lower(op, x).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, "expected a dot_general in the lowered matvec"
    for ln in dots:
        assert "HIGHEST" in ln, ln
    y = np.asarray(op.matvec(x), dtype=np.float64)
    y_ref = op.to_scipy().astype(np.float64) @ np.ones(op.shape[1])
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


def _f32_dots_with_free_dims(text):
    """(line, pinned) for every float32 ``dot_general`` of a lowered program
    that has a free (non-contracting) dimension: the result has more
    dimensions than the dot has batch dimensions.  Vector-vector dots are
    left out; a GPU compiler turns them into a multiply and a reduction."""
    import re

    found = []
    for ln in text.splitlines():
        if "stablehlo.dot_general" not in ln:
            continue
        result = ln.rsplit("->", 1)[1]
        if "f32>" not in result:
            continue
        rank = len(re.search(r"tensor<([^>]*)>", result).group(1)
                   .split("x")) - 1
        batch = re.search(r"batching_dims = \[([^\]]*)\]", ln)
        n_batch = len(batch.group(1).split(",")) if batch else 0
        if rank > n_batch:
            found.append((ln, "HIGHEST" in ln))
    return found


@pytest.mark.parametrize("program", ["solve_mp_defect", "amli_cycle"])
def test_f32_solve_programs_pin_highest_precision(program):
    import pyamg_tpu

    A = poisson((32, 32), format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, max_coarse=40, op_dtype=jnp.float32)
    if program == "solve_mp_defect":
        x = ml.solve_mp(b, tol=1e-10, method="defect")
        assert np.linalg.norm(b - A @ np.asarray(x)) <= \
            1e-10 * np.linalg.norm(b)
        one_round = next(f for k, f in ml._solve_cache.items()
                         if k[0] == "mp_round")
        b64 = jnp.asarray(b)
        lowered = one_round.lower(ml._dev(), ml._A64_dev, b64,
                                  jnp.zeros_like(b64))
    else:
        b32 = jnp.asarray(b, dtype=jnp.float32)
        lowered = ml._raw_cycle("AMLI").lower(ml._dev(), jnp.zeros_like(b32),
                                              b32)
    dots = _f32_dots_with_free_dims(lowered.as_text())
    assert dots, "expected the dense coarse solve's matvec"
    for ln, pinned in dots:
        assert pinned, ln


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_respects_env(monkeypatch, tmp_path,
                                    restore_cache_config):
    harness = _import_from_repo("_harness")

    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    monkeypatch.setattr(harness, "_CHECKOUT", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert harness.use_compile_cache() == env_dir
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / ".jax_cache").exists()


def test_compile_cache_default_under_root(monkeypatch, tmp_path,
                                          restore_cache_config):
    harness = _import_from_repo("_harness")

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(harness, "_CHECKOUT", str(tmp_path))
    path = harness.use_compile_cache()
    assert path == str(tmp_path / ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------

def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_phases_tiny():
    cs = _import_from_repo("chip_smoke")
    for res in (cs.phase_flagship(grid=(48, 48)),
                cs.phase_classical(grid=(32, 32)),
                cs.phase_blocked(grid=(12, 12))):
        assert res["relres"] <= cs.TOL
        assert res["iterations"] > 0
    k = cs.phase_kernels(grid=(48, 48), dense_n=128, block_grid=(12, 12))
    assert {"dia_5pt", "dia_9pt", "dense", "bdia", "block_ell"} <= set(k)
