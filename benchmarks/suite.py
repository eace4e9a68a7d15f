"""Benchmark suite covering the BASELINE.json configurations — as specified.

Run on the target hardware:  python benchmarks/suite.py [--small]

1. 2D Poisson 500x500, classical AMG (ruge_stuben) V(1,1) + CG to 1e-10
2. 2D rotated anisotropic diffusion 1024^2, classical AMG with evolution SOC
3. 3D Poisson 64^3, SA + Chebyshev smoothing, CG-preconditioned
4. 2D linear elasticity, block-BSR SA with rigid-body-mode near nullspace
5. Adaptive SA (alphaSA) on 1024^2 anisotropy + standalone GMRES/BiCGStab

Every config solves to a TRUE float64 relative residual of 1e-10
(``MultilevelSolver.solve_mp``: f32 device hierarchy inside an f64
defect-correction outer loop, one fused XLA program), and the residual is
re-verified on the host in f64.  ``--small`` is a quick run at reduced
sizes on the card.

Every line names the device it ran on; a run that finds no GPU stops.

Reference columns (``ref_*``) come from benchmarks/reference_cpu.json —
the reference pyamg fork compiled from /root/reference and run on the same
configs on CPU (see docs/design.md "reference baseline harness").
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from _harness import require_gpu, use_compile_cache  # noqa: E402

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

TOL = 1e-10

_REF_PATH = os.path.join(os.path.dirname(__file__), "reference_cpu.json")
_REF = json.load(open(_REF_PATH)) if os.path.exists(_REF_PATH) else {}


_ONLY = None
_DEVICE = None


def run_config(name, build, solve):
    if _ONLY and _ONLY not in name:
        return None
    t0 = time.time()
    ctx = build()
    t_setup = time.time() - t0
    solve(ctx)          # warm-up (compile)
    t0 = time.time()
    result = solve(ctx)
    t_solve = time.time() - t0
    out = {"config": name, "device": _DEVICE, "tol": TOL,
           "setup_s": round(t_setup, 2),
           "solve_s": round(t_solve, 4), **result}
    ref = _REF.get(name)
    if ref:
        out["ref_cpu_iters"] = ref["iters"]
        out["ref_cpu_solve_s"] = ref["solve_s"]
        out["ref_cpu_setup_s"] = ref["setup_s"]
    print(json.dumps(out))
    return out


def _solve_mp(A, ml, b, **kw):
    """Mixed-precision solve to TOL with host-verified f64 residual."""
    x, info = ml.solve_mp(b, tol=TOL, return_info=True, **kw)
    x = np.asarray(x, dtype=float)
    rr = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    return {"iters": info["inner_iterations"], "rounds": info["rounds"],
            "relres": rr}


_DTYPE_BYTES = {"f64": 8, "c64": 8, "u64": 8, "s64": 8, "f32": 4,
                "u32": 4, "s32": 4, "c128": 16, "bf16": 2, "f16": 2,
                "u16": 2, "s16": 2, "u8": 1, "s8": 1, "pred": 1}


def _collective_stats(hlo_text, n_devices):
    """Static collective census of a compiled HLO module: instruction
    counts AND bytes-on-wire per kind, from each op's result shape.

    Wire-byte model (ring algorithms, per device, per execution):
    collective-permute = result bytes (one neighbor send); all-gather =
    (N-1)/N x result bytes; all-reduce = 2(N-1)/N x shape bytes;
    reduce-scatter = (N-1) x result bytes; all-to-all = (N-1)/N x bytes.
    `-start` covers async forms (the paired `-done` carries no shape)."""
    import re

    counts, bytes_by = {}, {}
    shape_re = re.compile(
        r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[^\]]*\](?:\{[^}]*\})?))\s+"
        r"(all-reduce|all-gather|reduce-scatter|collective-permute|"
        r"all-to-all)(?:-start)?\(")
    tok_re = re.compile(r"([a-z0-9]+)\[([^\]]*)\]")

    def shape_bytes(tok):
        total = 0
        for dt, dims in tok_re.findall(tok):
            if dt not in _DTYPE_BYTES:
                continue
            elems = 1
            for d in dims.split(","):
                d = d.strip()
                if d:
                    elems *= int(d)
            total += elems * _DTYPE_BYTES[dt]
        return total

    N = max(2, int(n_devices))
    for tok, kind in shape_re.findall(hlo_text):
        b = shape_bytes(tok)
        wire = {"collective-permute": b,
                "all-gather": b * (N - 1) // N,
                "all-reduce": 2 * b * (N - 1) // N,
                "reduce-scatter": b * (N - 1),
                "all-to-all": b * (N - 1) // N}[kind]
        counts[kind] = counts.get(kind, 0) + 1
        bytes_by[kind] = bytes_by.get(kind, 0) + wire
    return {"counts": counts, "wire_bytes": bytes_by,
            "total_wire_bytes": sum(bytes_by.values())}


def _level_halo_bytes(sol, n_devices):
    """Analytic per-level halo volume of a row-sharded matvec: for each
    level operator, the count of distinct out-of-shard columns its rows
    reference (what an ideal neighbor exchange must move, vs whatever
    XLA actually emits — the _collective_stats census).  One matvec,
    both directions summed."""
    import scipy.sparse as sp

    rows = []
    for i, lvl in enumerate(sol.levels):
        A = getattr(lvl, "A_csr", None)
        if A is None:
            continue
        A = sp.csr_matrix(A)
        n = A.shape[0]
        npad = -(-n // n_devices) * n_devices
        shard = npad // n_devices
        owner_row = np.repeat(np.arange(n_devices), shard)[:n]
        col_owner = owner_row[np.minimum(A.indices, n - 1)]
        row_owner = np.repeat(owner_row, np.diff(A.indptr))
        off = col_owner != row_owner
        # distinct (shard, remote column) pairs
        pairs = np.unique(
            A.indices[off].astype(np.int64)
            + np.int64(n) * row_owner[off].astype(np.int64))
        halo_elems = int(pairs.size)
        halo_bytes = halo_elems * A.dtype.itemsize
        rows.append({"level": i, "n": int(n),
                     "halo_elems_per_matvec": halo_elems,
                     "halo_bytes_per_matvec": halo_bytes})
    return rows


def run_sharded(n_devices, small):
    """Multi-card benchmark mode (SURVEY §7 step 8): headline + config 2
    under the sharded solvers, recording per-device DoF/s and the
    collective census (counts and bytes) of the compiled programs.

    Runs in one process over ``n_devices`` attached cards (``main``
    checked there are that many) and writes
    benchmarks/results/sharded_<platform><N>.json.
    """

    from pyamg_tpu.gallery import (poisson, stencil_grid,
                                   diffusion_stencil_2d)
    from pyamg_tpu.parallel import (make_mesh, classical_setup_sharded,
                                    structured_sa_setup_sharded)

    platform = jax.devices()[0].platform
    mesh = make_mesh(n_devices)
    results = {"mode": "sharded", "n_devices": n_devices,
               "platform": platform, "configs": []}

    def record(name, n, setup_s, solve_s, iters, relres, coll,
               halo=None):
        out = {"config": name, "n": int(n), "n_devices": n_devices,
               "platform": platform, "setup_s": round(setup_s, 2),
               "solve_s": round(solve_s, 4), "iters": int(iters),
               "relres": float(relres),
               "dofps": round(n / solve_s, 1),
               "per_device_dofps": round(n / solve_s / n_devices, 1),
               "collectives_per_program": coll.get("counts", coll),
               "wire_bytes_per_program": coll.get("wire_bytes"),
               "total_wire_bytes_per_program":
                   coll.get("total_wire_bytes"),
               "per_level_halo": halo}
        print(json.dumps(out))
        results["configs"].append(out)

    def accel_hlo(ml, b_dev, maxiter):
        """Compiled HLO of the fused CG+V-cycle program actually used by
        solve (hierarchy passed as pytree argument, mesh-placed)."""
        run = ml._raw_accel("cg", "V", int(maxiter))
        hier = ml._dev()
        tol_t = jnp.asarray(1e-8, dtype=jnp.real(
            jnp.zeros(0, b_dev.dtype)).dtype)
        return run.lower(hier, jnp.zeros_like(b_dev), b_dev,
                         tol_t).compile().as_text()

    rng = np.random.default_rng(0)

    # 1. headline: structured SA on 2D Poisson, SETUP distributed over the
    #    mesh (SPMD comb-probe RAP) and the fused CG+V-cycle solve SPMD.
    g = (128, 128) if small else (1024, 1024)
    A = poisson(g, format="csr")
    n = A.shape[0]
    b = np.asarray(A @ rng.random(n))
    t0 = time.time()
    ml = structured_sa_setup_sharded(A, g, mesh=mesh, dtype=jnp.float32,
                                     max_coarse=500)
    setup_s = time.time() - t0
    res = []
    ml.solve(b, tol=1e-6, maxiter=60, accel="cg", residuals=res)  # warm-up
    res = []
    t0 = time.time()
    x = ml.solve(b, tol=1e-6, maxiter=60, accel="cg", residuals=res)
    solve_s = time.time() - t0
    rr = float(np.linalg.norm(b - A @ np.asarray(x, dtype=float))
               / np.linalg.norm(b))
    b_dev = jax.device_put(
        jnp.asarray(b, dtype=ml.levels[0].A.dtype),
        jax.sharding.NamedSharding(mesh,
                                   jax.sharding.PartitionSpec("rows")))
    coll = _collective_stats(accel_hlo(ml, b_dev, 60), n_devices)
    record("headline_poisson_sa_sharded", n, setup_s, solve_s,
           len(res) - 1, rr, coll, halo=_level_halo_bytes(ml, n_devices))

    # 2. config 2: rotated anisotropic diffusion, classical AMG with
    #    evolution SOC — setup distributed (classical_setup_sharded:
    #    host integer graph stages, SPMD numeric stages), padded-ELL solve.
    g2 = (96, 96) if small else (1024, 1024)
    sten = diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 4, type="FD")
    A2 = stencil_grid(sten, g2, format="csr")
    n2 = A2.shape[0]
    b2 = np.asarray(A2 @ rng.random(n2))
    t0 = time.time()
    sol = classical_setup_sharded(
        A2, mesh=mesh, strength=("evolution", {"k": 2, "epsilon": 4.0}),
        CF="RS", interpolation="standard", dtype=np.float32)
    setup2_s = time.time() - t0
    res2 = []
    sol.solve(b2, tol=1e-6, maxiter=60, accel="cg", residuals=res2)
    res2 = []
    t0 = time.time()
    x2 = sol.solve(b2, tol=1e-6, maxiter=60, accel="cg", residuals=res2)
    solve2_s = time.time() - t0
    rr2 = float(np.linalg.norm(b2 - A2 @ np.asarray(x2, dtype=float))
                / np.linalg.norm(b2))
    coll2 = _collective_stats(
        accel_hlo(sol.inner, sol._pad_vec(b2), 60), n_devices)
    record("anisotropic_classical_sharded", n2, setup2_s, solve2_s,
           len(res2) - 1, rr2, coll2,
           halo=_level_halo_bytes(sol.inner, n_devices))

    out_dir = os.path.join(os.path.dirname(__file__), "results")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"sharded_{platform}{n_devices}.json")
    json.dump(results, open(out_path, "w"), indent=1)
    print(f"# wrote {out_path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="a quick run at reduced problem sizes")
    ap.add_argument("--only", default=None,
                    help="run only configs whose name contains this")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="run the multi-card benchmark mode over an "
                         "N-device mesh")
    args = ap.parse_args()
    s = args.small
    global _ONLY, _DEVICE
    _ONLY = args.only

    _DEVICE = require_gpu("suite.py", max(args.sharded, 1))
    use_compile_cache()

    if args.sharded:
        run_sharded(args.sharded, s)
        return

    import pyamg_tpu
    from pyamg_tpu.gallery import (poisson, stencil_grid,
                                   diffusion_stencil_2d, linear_elasticity)

    # Initialise the backend and warm the H2D/D2H transfer paths before
    # any timed region: the reference columns don't time library startup
    # either.
    np.asarray(jnp.asarray(np.zeros(1 << 20, np.float32)) + 1.0)

    # Each config seeds a FRESH rng so the RHS is identical regardless of
    # which configs ran before (and matches reference_harness/ref_suite.py,
    # which does the same — resume there used to shift the stream).
    def rng():
        return np.random.default_rng(0)

    # 1. classical AMG on 500x500 Poisson, V(1,1) + CG to 1e-10
    def build1():
        A = poisson((100, 100) if s else (500, 500), format="csr")
        ml = pyamg_tpu.ruge_stuben_solver(A, CF="RS",
                                          op_dtype=jnp.float32)
        return A, ml, np.asarray(A @ rng().random(A.shape[0]))

    def solve1(ctx):
        A, ml, b = ctx
        return _solve_mp(A, ml, b)

    run_config("classical_poisson_500", build1, solve1)

    # 2. rotated anisotropic diffusion 1024^2, evolution SOC (full size,
    #    all levels), distance-two interpolation
    def build2():
        g = (128, 128) if s else (1024, 1024)
        sten = diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 4,
                                    type="FD")
        A = stencil_grid(sten, g, format="csr")
        # unfiltered Galerkin coarse operators: 12 iterations (vs 14 with
        # coarse_filter=0.02, 20 for the reference) at the same device
        # formats — the lumped filtering traded convergence for nothing here
        ml = pyamg_tpu.ruge_stuben_solver(
            A, strength=("evolution", {"k": 2, "epsilon": 4.0}), CF="RS",
            interpolation="standard", op_dtype=jnp.float32)
        return A, ml, np.asarray(A @ rng().random(A.shape[0]))

    def solve2(ctx):
        A, ml, b = ctx
        return _solve_mp(A, ml, b, inner_maxiter=60)

    run_config("anisotropic_1024_classical", build2, solve2)

    # 3. 3D Poisson 64^3, SA + Chebyshev, CG-preconditioned
    def build3():
        g = (24, 24, 24) if s else (64, 64, 64)
        A = poisson(g, format="csr")
        # 2^3 grid-block aggregation: all-DIA hierarchy (gather-free
        # cycles) at reference-parity iteration counts (14 vs 13)
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, presmoother="chebyshev", postsmoother="chebyshev",
            improve_candidates=None, op_dtype=jnp.float32,
            aggregate=("grid", {"block": (2, 2, 2)}))
        return A, ml, np.asarray(A @ rng().random(A.shape[0]))

    def solve3(ctx):
        A, ml, b = ctx
        return _solve_mp(A, ml, b)

    run_config("poisson3d_64_sa_chebyshev", build3, solve3)

    # 4. elasticity block-BSR SA with RBM candidates
    def build4():
        g = (20, 20) if s else (100, 100)
        A, B = linear_elasticity(g)          # BSR (2,2) with .grid attached
        # energy-min P: same operator complexity as the reference's default
        # jacobi P (opc 1.285) at 11 iterations vs the reference's 12;
        # 2 constrained-CG iterations already reach the 11-iteration
        # hierarchy (4 is the reference default; 3 changes nothing here)
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, B=B, max_coarse=100, smooth=("energy", {"maxiter": 2}),
            op_dtype=jnp.float32)
        return A.tocsr(), ml, rng().standard_normal(A.shape[0])

    def solve4(ctx):
        A, ml, b = ctx
        return _solve_mp(A, ml, b, inner_maxiter=80, max_rounds=8)

    run_config("elasticity_rbm_sa", build4, solve4)

    # 4b. 1M-DoF blocked elasticity (the end-to-end that motivated
    #     distributing energy-min setup, with a reference column): energy-min P on RBM candidates, blocked
    #     banded levels flattened to scalar DIA.
    def build4b():
        g = (64, 64) if s else (724, 724)       # 2*724^2 = 1,048,352 DoF
        A, B = linear_elasticity(g)
        ml = pyamg_tpu.smoothed_aggregation_solver(
            A, B=B, max_coarse=100, smooth=("energy", {"maxiter": 2}),
            op_dtype=jnp.float32)
        return A.tocsr(), ml, rng().standard_normal(A.shape[0])

    def solve4b(ctx):
        A, ml, b = ctx
        return _solve_mp(A, ml, b, inner_maxiter=80, max_rounds=8)

    run_config("elasticity_1m_energy_sa", build4b, solve4b)

    # 5. adaptive SA at 1024^2 anisotropy + standalone Krylov on the gallery
    def build5():
        g = (128, 128) if s else (1024, 1024)
        sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
        A = stencil_grid(sten, g, format="csr")
        # one well-relaxed candidate + zebra line relaxation: the scalar
        # hierarchy auto-semicoarsens across the weak axis (15 iterations,
        # ~3 s setup vs 31/~40 s with num_candidates=2; the reference ran
        # its own default smoothers with num_candidates=2 -> 112 iterations)
        ml, work = pyamg_tpu.adaptive_sa_solver(
            A, num_candidates=1, candidate_iters=15, max_coarse=100,
            prepostsmoother="zebra")
        ml = ml.astype(jnp.float32)
        return A, ml, np.asarray(A @ rng().random(A.shape[0]))

    def solve5(ctx):
        A, ml, b = ctx
        return _solve_mp(A, ml, b, inner_maxiter=60)

    run_config("adaptive_sa_anisotropy_1024", build5, solve5)

    # 5b. standalone GMRES/BiCGStab Krylov suite on the gallery set at the
    #     suite's 1e-10 / f64-host-verified standard (BASELINE config 5)
    def krylov_gallery():
        from pyamg_tpu.gallery import load_example
        from pyamg_tpu.krylov import gmres, bicgstab
        from pyamg_tpu.sparse import device_operator

        sc = 2 if s else 1
        probs = {}
        probs["poisson2d_64"] = poisson((64 // sc, 64 // sc), format="csr")
        probs["poisson3d_16"] = poisson((16 // sc,) * 3, format="csr")
        probs["aniso_64"] = stencil_grid(
            diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 4, type="FD"),
            (64 // sc, 64 // sc), format="csr")
        Ae, _Be = linear_elasticity((24 // sc, 24 // sc))
        probs["elasticity_24"] = Ae.tocsr()
        probs["recirc_flow"] = load_example("recirc_flow")["A"].tocsr()

        ref = _REF.get("standalone_krylov_gallery", {})
        for name, A in probs.items():
            b = np.asarray(A @ rng().random(A.shape[0]))
            Ad = device_operator(A)
            out = {"config": "standalone_krylov_gallery", "device": _DEVICE,
                   "problem": name,
                   "n": int(A.shape[0]), "tol": TOL}
            for meth, fn, kw in [
                    ("gmres", gmres, {"restrt": None, "maxiter": 800}),
                    ("bicgstab", bicgstab, {"maxiter": 20000})]:
                fn(Ad, b, tol=TOL, **kw)               # warm-up (compile)
                res = []
                t0 = time.time()
                x, info = fn(Ad, b, tol=TOL, residuals=res, **kw)
                t = time.time() - t0
                rr = float(np.linalg.norm(b - A @ np.asarray(x, dtype=float))
                           / np.linalg.norm(b))
                out[f"{meth}_s"] = round(t, 4)
                out[f"{meth}_iters"] = len(res) - 1
                out[f"{meth}_relres"] = rr
                r = ref.get(name)
                if r:
                    out[f"ref_cpu_{meth}_s"] = r.get(f"{meth}_s")
                    out[f"ref_cpu_{meth}_iters"] = r.get(f"{meth}_iters")
            print(json.dumps(out))

    if not _ONLY or "krylov" in _ONLY:
        krylov_gallery()


if __name__ == "__main__":
    main()
