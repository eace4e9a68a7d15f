"""Smoke run of the AMG setup + solve path on one NVIDIA GPU.

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # phase 5 only: sharded solvers on 4

Phases, each printing one JSON line:

0. device: a GPU is required (no CPU fallback); the card's name and power
   limit as nvidia-smi reports them; the native host core must have built.
1. flagship: 2048^2 5-point Poisson (4,194,304 rows), structured smoothed
   aggregation with an f32 device hierarchy, ``solve_mp`` to 1e-10.
2. classical: Ruge-Stuben on 1024^2 Poisson, ``solve_mp`` to 1e-10.
3. blocked: 2D linear elasticity (100x100 nodes, rigid-body modes),
   energy-min SA, ``solve_mp`` to 1e-10.
4. kernels: the DIA SpMV at 4.2M rows, the dense coarse-operator matvec
   and the 2x2-block operators (SparseBDIA, BlockELL) of a 1M-DoF
   elasticity problem against numpy in float64.
5. four cards (only with ``--four-cards``): the phase-1 problem with an
   f64 hierarchy, solved by ``shard_structured_solver`` and ``shard_solver``
   over a 4-device mesh and by the distributed setup
   ``structured_sa_setup_sharded``, each against its one-card solve.

Every solve is checked on the host: ``||b - A x|| / ||b||`` in float64 with
scipy, the library's plain reference.  Any failed phase makes the script
exit 1 without the final line; on success the last line is
``{"ok": true, "device": {...}}``.  Everything runs in this one process.
"""

import argparse
import json
import sys
import time
import traceback

import numpy as np

TOL = 1e-10


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def host_relres(A, b, x):
    x = np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def check_relres(A, b, x, tol=TOL):
    rr = host_relres(A, b, x)
    if not rr <= tol:
        raise AssertionError(f"host f64 relres {rr:.3e} > {tol:.0e}")
    return rr


def level_formats(ml):
    return [type(lvl.A).__name__ for lvl in ml.levels]


def timed_solve_mp(ml, A, b, **kw):
    """Cold then warm ``solve_mp``, each timed to ``block_until_ready``;
    the warm solution is checked on the host."""
    import jax

    t0 = time.perf_counter()
    x, _ = ml.solve_mp(b, tol=TOL, return_info=True, **kw)
    jax.block_until_ready(x)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = ml.solve_mp(b, tol=TOL, return_info=True, **kw)
    jax.block_until_ready(x)
    warm = time.perf_counter() - t0
    return {"first_solve_s": cold, "compile_s": max(cold - warm, 0.0),
            "warm_solve_s": warm, "iterations": info["inner_iterations"],
            "rounds": info["rounds"], "relres": check_relres(A, b, x)}


# -- phase 0 -----------------------------------------------------------------

def phase_device(count):
    import jax
    from _harness import card_info, require_gpu

    device = require_gpu("chip_smoke", count)
    cards = card_info()
    for line in cards:
        print(line, flush=True)

    from pyamg_tpu.amg_core import have_native

    if not have_native():
        raise RuntimeError("native amg_core did not build; setup would "
                           "silently run the numpy fallbacks")
    return {**device, "nvidia_smi": cards, "jax": jax.__version__}


# -- phases 1-3: the public constructors and solve_mp ----------------------

def phase_flagship(grid=(2048, 2048), seed=0):
    import jax.numpy as jnp
    import pyamg_tpu
    from pyamg_tpu.gallery import poisson

    A = poisson(grid, format="csr")
    b = A @ np.random.default_rng(seed).random(A.shape[0])
    t0 = time.perf_counter()
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, max_coarse=500, presmoother="chebyshev",
        postsmoother="chebyshev", improve_candidates=None,
        op_dtype=jnp.float32)
    setup = time.perf_counter() - t0
    return {"n": A.shape[0], "setup_s": setup, **timed_solve_mp(ml, A, b),
            "levels": level_formats(ml)}


def phase_classical(grid=(1024, 1024), seed=0):
    import jax.numpy as jnp
    import pyamg_tpu
    from pyamg_tpu.gallery import poisson

    A = poisson(grid, format="csr")
    b = A @ np.random.default_rng(seed).random(A.shape[0])
    t0 = time.perf_counter()
    ml = pyamg_tpu.ruge_stuben_solver(A, CF="RS", op_dtype=jnp.float32)
    setup = time.perf_counter() - t0
    return {"n": A.shape[0], "setup_s": setup, **timed_solve_mp(ml, A, b),
            "levels": level_formats(ml)}


def phase_blocked(grid=(100, 100), seed=0):
    """The ``elasticity_rbm_sa`` configuration of benchmarks/suite.py."""
    import jax.numpy as jnp
    import pyamg_tpu
    from pyamg_tpu.gallery import linear_elasticity

    A, B = linear_elasticity(grid)
    b = np.random.default_rng(seed).standard_normal(A.shape[0])
    t0 = time.perf_counter()
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, B=B, max_coarse=100, smooth=("energy", {"maxiter": 2}),
        op_dtype=jnp.float32)
    setup = time.perf_counter() - t0
    res = timed_solve_mp(ml, A.tocsr(), b, inner_maxiter=80, max_rounds=8)
    return {"n": A.shape[0], "setup_s": setup, **res,
            "levels": level_formats(ml)}


# -- phase 4: operator kernels at real widths -----------------------------

def _max_rel(y, yref):
    yref = np.asarray(yref, dtype=np.float64)
    return float(np.abs(np.asarray(y, dtype=np.float64) - yref).max()
                 / np.abs(yref).max())


def phase_kernels(grid=(2048, 2048), dense_n=4096, block_grid=(724, 724),
                  seed=0):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from pyamg_tpu.gallery import linear_elasticity, poisson, stencil_grid
    from pyamg_tpu.sparse import BlockELL, SparseBDIA, SparseDIA
    from pyamg_tpu.sparse.linop import DenseOp

    rng = np.random.default_rng(seed)
    matvec = jax.jit(lambda op, x: op.matvec(x))
    out = {}
    # a sum of k float32 products rounds each product and each partial sum
    # once: the error stays within ~k * 2^-24 of the largest term, far
    # below 1e-5 of max|y| for k <= 9 zero-mean terms
    for name, A in (("dia_5pt", poisson(grid, format="csr")),
                    ("dia_9pt", stencil_grid(np.ones((3, 3)), grid,
                                             format="csr"))):
        A = sp.csr_matrix(A, dtype=np.float64)
        A.data = rng.standard_normal(A.nnz).astype(np.float32)
        x = rng.standard_normal(A.shape[0]).astype(np.float32)
        D = SparseDIA.from_scipy(A, dtype=np.float32)
        y = matvec(D, jnp.asarray(x))
        rel = _max_rel(y, A @ x.astype(np.float64))
        if not rel <= 1e-5:
            raise AssertionError(f"{name}: max rel err {rel:.3e} > 1e-5")
        out[name] = {"n": A.shape[0], "offsets": len(D.offsets),
                     "max_rel_err": rel}
    # f32 at HIGHEST precision keeps ~1e-7; a TF32 product (10-bit
    # mantissa) would land near 1e-3 on zero-mean data
    M = rng.standard_normal((dense_n, dense_n)).astype(np.float32)
    x = rng.standard_normal(dense_n).astype(np.float32)
    y = matvec(DenseOp(jnp.asarray(M), M.shape), jnp.asarray(x))
    rel = _max_rel(y, M.astype(np.float64) @ x.astype(np.float64))
    if not rel <= 1e-5:
        raise AssertionError(f"dense: max rel err {rel:.3e} > 1e-5")
    out["dense"] = {"n": dense_n, "max_rel_err": rel}
    # 2x2-block operators: sums of at most 18 float32 products per row,
    # the same bound as the DIA check; TF32 block products would not hold
    A_bsr, _ = linear_elasticity(block_grid)
    A_bsr = sp.bsr_matrix(A_bsr, dtype=np.float32)
    A64 = A_bsr.astype(np.float64)
    x = rng.standard_normal(A_bsr.shape[0]).astype(np.float32)
    y_ref = A64 @ x.astype(np.float64)
    for name, op in (("bdia", SparseBDIA.from_scipy_bsr(A_bsr)),
                     ("block_ell", BlockELL.from_scipy(A_bsr, blocksize=2))):
        rel = _max_rel(matvec(op, jnp.asarray(x)), y_ref)
        if not rel <= 1e-5:
            raise AssertionError(f"{name}: max rel err {rel:.3e} > 1e-5")
        out[name] = {"n": A_bsr.shape[0], "max_rel_err": rel}
    return out


# -- phase 5: four cards ------------------------------------------------------

def _timed_solve(solver, A, b, maxiter=200):
    """Cold then warm f64 PCG solve of a (possibly sharded) solver."""
    t0 = time.perf_counter()
    solver.solve(b, tol=TOL, maxiter=maxiter, accel="cg")
    cold = time.perf_counter() - t0
    res = []
    t0 = time.perf_counter()
    x = np.asarray(solver.solve(b, tol=TOL, maxiter=maxiter, accel="cg",
                                residuals=res), dtype=np.float64)
    warm = time.perf_counter() - t0
    return x, {"first_solve_s": cold, "warm_solve_s": warm,
               "iterations": len(res) - 1, "relres": check_relres(A, b, x)}


def _compare(name, ref, x_ref, got, x_got):
    """Sharded against one-card: both converge, iteration counts within
    one, solutions within 1e-6 relative.  Collective reductions sum in
    another order than one card does, so bitwise equality is not asked."""
    diff = float(np.linalg.norm(x_got - x_ref) / np.linalg.norm(x_ref))
    if abs(got["iterations"] - ref["iterations"]) > 1:
        raise AssertionError(f"{name}: {got['iterations']} iterations vs "
                             f"{ref['iterations']} on one card")
    if not diff <= 1e-6:
        raise AssertionError(f"{name}: ||x4 - x1||/||x1|| = {diff:.3e}")
    return {"one_card": ref, "sharded": got, "rel_diff_x": diff}


def phase_four_cards(grid=(2048, 2048), n_devices=4, seed=0):
    import jax.numpy as jnp
    import pyamg_tpu
    from pyamg_tpu.aggregation.device_setup import structured_sa_setup
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.parallel import (make_mesh, shard_solver,
                                    shard_structured_solver,
                                    structured_sa_setup_sharded)

    mesh = make_mesh(n_devices)
    A = poisson(grid, format="csr")
    b = A @ np.random.default_rng(seed).random(A.shape[0])
    out = {"n": A.shape[0], "n_devices": n_devices}

    # the phase-1 hierarchy in f64: the sharded solvers run plain PCG in
    # the hierarchy's dtype, and 1e-10 needs f64
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, max_coarse=500, presmoother="chebyshev",
        postsmoother="chebyshev", improve_candidates=None)
    x1, r1 = _timed_solve(ml, A, b)
    for name, make in (("shard_structured_solver", shard_structured_solver),
                       ("shard_solver", shard_solver)):
        t0 = time.perf_counter()
        sml = make(ml, mesh=mesh)
        setup = time.perf_counter() - t0
        x4, r4 = _timed_solve(sml, A, b)
        out[name] = {"shard_s": setup, **_compare(name, r1, x1, r4, x4)}

    t0 = time.perf_counter()
    ml_r = structured_sa_setup(A, grid, max_coarse=500, dtype=jnp.float64)
    setup_r = time.perf_counter() - t0
    t0 = time.perf_counter()
    ml_s = structured_sa_setup_sharded(A, grid, mesh=mesh, max_coarse=500,
                                       dtype=jnp.float64)
    setup_s = time.perf_counter() - t0
    x1, r1 = _timed_solve(ml_r, A, b)
    x4, r4 = _timed_solve(ml_s, A, b)
    r1["setup_s"], r4["setup_s"] = setup_r, setup_s
    out["structured_sa_setup_sharded"] = _compare(
        "structured_sa_setup_sharded", r1, x1, r4, x4)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)       # solve_mp needs f64
    count = 4 if args.four_cards else 1
    device = phase_device(count)
    emit("device", **device)

    from _harness import use_compile_cache

    use_compile_cache()
    phases = ([("four_cards", phase_four_cards)] if args.four_cards else
              [("flagship_sa_2048", phase_flagship),
               ("classical_rs_1024", phase_classical),
               ("blocked_elasticity_100", phase_blocked),
               ("kernels", phase_kernels)])
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            emit(name, ok=True, **fn(), phase_s=time.perf_counter() - t0)
        except Exception as e:
            traceback.print_exc()
            emit(name, ok=False, error=f"{type(e).__name__}: {e}",
                 phase_s=time.perf_counter() - t0)
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
