"""Headline benchmark: 1M-unknown 2D Poisson solved to 1e-10 rel. residual.

Matches BASELINE.json's metric ("V-cycle ms and DoFs/sec at 1M-unknown
Poisson"): smoothed aggregation (structured grid fast path, DIA operators),
CG-preconditioned, float32 V-cycles inside a float64 defect-correction outer
loop — all device-resident (mixed precision: the f32 hierarchy is a
preconditioner; accuracy comes from the f64 outer residual).

vs_baseline: the same hierarchy applied on CPU via scipy CSR ops (the
reference's substrate) preconditioning scipy CG — a host-vs-device
throughput ratio.

Prints ONE JSON line, naming the device it ran on.
"""

import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from _harness import card_info, require_gpu, use_compile_cache

# f64 on device for the outer defect-correction
jax.config.update("jax_enable_x64", True)

GRID = (1024, 1024)
TOL = 1e-10
INNER_MAXITER = 40


def build_problem():
    from pyamg_tpu.gallery import poisson

    A = poisson(GRID, format="csr")
    n = A.shape[0]
    rng = np.random.default_rng(0)
    b = A @ rng.random(n)          # consistent RHS
    return A, b


def build_solver(A):
    import pyamg_tpu

    # chebyshev smoothing: no per-color masked matvecs, at the same
    # preconditioner quality as symmetric multicolor GS on Poisson
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, max_coarse=500,
        presmoother="chebyshev",
        postsmoother="chebyshev",
        improve_candidates=None,
        op_dtype=jnp.float32)      # f32 device hierarchy (preconditioner)
    return ml


def make_device_solver(ml, A):
    """Fully-fused mixed-precision solve: the f64 defect-correction outer
    loop AND the f32 PCG inner loop compile into ONE XLA program — a single
    device dispatch and a single host fetch per solve."""
    from pyamg_tpu.sparse import SparseDIA
    from pyamg_tpu.krylov._cg import cg_core

    A64 = SparseDIA.from_scipy(A)          # f64 on device (outer residual)
    raw_cyc = ml._raw_cycle("V")
    hier = ml._dev()
    MAX_ROUNDS = 4

    # NOTE: the hierarchy and A64 are ARGUMENTS, not closure constants —
    # closure-captured arrays would be embedded into the serialized HLO.
    @jax.jit
    def full_solve(hier, A64, b64):
        normb = jnp.linalg.norm(b64)
        tol_abs = TOL * normb

        def mv32(v):
            return hier["As"][0].matvec(v)

        def pre(r):
            return raw_cyc(hier, jnp.zeros_like(r), r)

        def body(carry):
            x64, _nr_est, rounds, iters = carry
            r64 = b64 - A64.matvec(x64)          # one f64 matvec per round
            nr = jnp.linalg.norm(r64)
            r32 = r64.astype(jnp.float32)
            tol_t = (1e-6 * nr).astype(jnp.float32)
            dx32, it, res_buf = cg_core(mv32, pre, jnp.zeros_like(r32),
                                        r32, tol_t, INNER_MAXITER)
            x64 = x64 + dx32.astype(jnp.float64)
            # post-update residual estimate from the inner solve
            nr_est = res_buf[it].astype(jnp.float64)
            return (x64, nr_est, rounds + 1, iters + it)

        def cond(carry):
            _x64, nr_est, rounds, _iters = carry
            return (nr_est > 0.5 * tol_abs) & (rounds < MAX_ROUNDS)

        x0 = jnp.zeros_like(b64)
        carry = (x0, normb, 0, 0)
        x64, nr_est, rounds, iters = jax.lax.while_loop(cond, body, carry)
        return x64, rounds, iters

    def solve(b64):
        x64, rounds, iters = jax.block_until_ready(
            full_solve(hier, A64, b64))
        return x64, int(iters)

    return solve


def cpu_reference_solve(ml, A, b):
    """Same hierarchy, applied with scipy CSR ops on the CPU (float64):
    stand-in for the reference's C++/scipy execution path."""
    from scipy.sparse.linalg import cg as scipy_cg, LinearOperator

    levels = []
    for lvl in ml.levels:
        levels.append({
            "A": lvl.A_csr,
            "P": lvl.P_csr if hasattr(lvl, "P_csr") else None,
            "R": lvl.R_csr if hasattr(lvl, "R_csr") else None,
            "dinv": 1.0 / lvl.A_csr.diagonal(),
        })
    coarse_inv = np.linalg.pinv(levels[-1]["A"].toarray())

    def jacobi_sweeps(lv, x, b, it=2, omega=0.7):
        for _ in range(it):
            x = x + omega * lv["dinv"] * (b - lv["A"] @ x)
        return x

    def vcycle(k, b):
        lv = levels[k]
        if k == len(levels) - 1:
            return coarse_inv @ b
        x = jacobi_sweeps(lv, np.zeros_like(b), b)
        r = b - lv["A"] @ x
        xc = vcycle(k + 1, lv["R"] @ r)
        x = x + lv["P"] @ xc
        return jacobi_sweeps(lv, x, b)

    M = LinearOperator(A.shape, matvec=lambda r: vcycle(0, r))
    t0 = time.perf_counter()
    x, info = scipy_cg(A, b, M=M, rtol=TOL, maxiter=100)
    return x, time.perf_counter() - t0


def main():
    device = require_gpu("bench.py")
    use_compile_cache()

    A, b = build_problem()
    n = A.shape[0]
    ml = build_solver(A)
    solve = make_device_solver(ml, A)

    b64 = jax.device_put(jnp.asarray(b, dtype=jnp.float64))

    # warm-up: compile once (excluded from timing)
    _ = solve(b64)

    # device-resident solve time to block_until_ready, best of 3
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        x_dev, inner_iters = solve(b64)
        runs.append(time.perf_counter() - t0)
    t_solve = min(runs)

    t0 = time.perf_counter()
    x = np.asarray(x_dev)
    t_xfer = time.perf_counter() - t0

    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    assert relres < 5 * TOL, f"did not converge: {relres}"

    x_cpu, t_cpu = cpu_reference_solve(ml, A, b)

    dofs_per_sec = n / t_solve
    per_iter_ms = t_solve / max(inner_iters, 1) * 1000.0

    print(json.dumps({
        "metric": "poisson_1M_SA_PCG_to_1e-10_dofs_per_sec",
        "value": round(dofs_per_sec, 1),
        "unit": "DoF/s",
        "vs_baseline": round(t_cpu / t_solve, 2),
        "device": {**device, "cards": card_info()},
        "detail": {
            "n": n,
            "solve_s": round(t_solve, 4),
            "result_transfer_s": round(t_xfer, 4),
            "cpu_scipy_solve_s": round(t_cpu, 3),
            "pcg_iterations": inner_iters,
            "per_iteration_ms": round(per_iter_ms, 2),
            "final_relres": relres,
            "levels": len(ml.levels),
            "operator_complexity": round(ml.operator_complexity(), 3),
            "solve_s_runs": [round(r, 4) for r in runs],
        },
    }))


if __name__ == "__main__":
    main()
