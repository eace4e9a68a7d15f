"""Device-true per-iteration cost for the standalone Krylov cores.

Protocol (a two-point slope produces NEGATIVE dispatch floors for
GMRES): GMRES cost is superlinear in the
iteration count — the progressive Krylov buffer grows 256 → 512 → m, and
per-iteration cost scales with the CURRENT buffer width — so a two-point
secant between tolerance targets mixes buffer stages and is meaningless.

Here every method runs ONE fixed program shape (fixed ``maxiter``, hence a
fixed buffer schedule) and iteration counts are steered by TOLERANCE
targets picked from the converged run's own residual history:

1. run to the cap (tol=1e-300) -> residual history + cap wall;
2. pick >=3 target iteration counts INSIDE the first buffer stage (where
   cost-per-iteration is constant) and set tol to the geometric mean of
   the bracketing residuals, so the device program stops at exactly that
   count;
3. least-squares fit  t(k) = floor + slope_1 * k  over those points ->
   a per-iteration cost AT THAT BUFFER WIDTH and a NON-NEGATIVE dispatch
   floor;
4. report later buffer stages' marginal cost from stage-crossing
   differences (cap run vs the last stage-1 point), labeled by width.

Wall times are best-of-N fresh dispatches.  Run on the GPU:

    python benchmarks/krylov_slope.py [--repeat 3]

Writes benchmarks/results/krylov_slope.json.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

from _harness import require_gpu, use_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)

TOL = 1e-10


def _problems():
    from pyamg_tpu.gallery import (poisson, stencil_grid,
                                   diffusion_stencil_2d, linear_elasticity,
                                   load_example)

    probs = {}
    probs["poisson2d_64"] = poisson((64, 64), format="csr")
    probs["poisson3d_16"] = poisson((16, 16, 16), format="csr")
    probs["aniso_64"] = stencil_grid(
        diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 4, type="FD"),
        (64, 64), format="csr")
    A, _B = linear_elasticity((24, 24))
    probs["elasticity_24"] = A.tocsr()
    probs["recirc_flow"] = load_example("recirc_flow")["A"].tocsr()
    return probs


def _gmres_stages(m):
    """The fused-path buffer schedule for restrt=m (krylov/_gmres.py)."""
    if m <= 384:
        return [m]
    stages, cur = [256], 256
    while cur < m:
        cur = min(2 * cur, m)
        stages.append(cur)
    return stages


def _best_of(fn, repeat):
    best, iters = np.inf, None
    for _ in range(repeat):
        res = []
        t0 = time.time()
        fn(res)
        t = time.time() - t0
        if t < best:
            best, iters = t, len(res) - 1
    return best, iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    device = require_gpu("krylov_slope.py")
    use_compile_cache()

    from pyamg_tpu.krylov import bicgstab, gmres
    from pyamg_tpu.sparse import device_operator

    rng = np.random.default_rng(0)
    rows = []
    for name, A in _problems().items():
        b = np.asarray(A @ rng.random(A.shape[0]))
        normb = float(np.linalg.norm(b))
        Ad = device_operator(A)
        row = {"problem": name, "n": int(A.shape[0])}

        for meth, fn, kw, cap in [
                ("gmres", gmres, {"restrt": None}, 800),
                ("bicgstab", bicgstab, {}, 2000)]:
            def run(res, tol, fn=fn, kw=kw, cap=cap):
                return fn(Ad, b, tol=tol, maxiter=cap, residuals=res, **kw)

            # cap run: fixed program, full residual history
            run([], 1e-300)                       # warm-up / compile
            res_full = []
            run(res_full, 1e-300)
            t_cap, k_cap = _best_of(lambda r: run(r, 1e-300), args.repeat)
            res_full = np.asarray(res_full)

            # the headline wall at the suite tolerance
            run([], TOL)
            t_conv, k_conv = _best_of(lambda r: run(r, TOL), args.repeat)

            # >=3 tolerance-targeted points inside the first buffer stage
            s1 = (_gmres_stages(min(cap, A.shape[0]))[0]
                  if meth == "gmres" else k_cap)
            # usable ks: residual still strictly decreasing (pre-floor)
            dec = np.flatnonzero(res_full[1:] < 0.7 * res_full[:-1]) + 1
            dec = dec[dec <= s1]
            kmax = int(dec.max()) if dec.size else 0
            targets = sorted({max(2, kmax // 4), max(3, kmax // 2),
                              max(4, (3 * kmax) // 4), max(5, kmax)})
            pts = []
            for kt in targets:
                if kt >= len(res_full):
                    continue
                tol_k = float(np.sqrt(res_full[kt - 1] * res_full[kt])
                              / normb)
                t_k, k_k = _best_of(lambda r: run(r, tol_k), args.repeat)
                pts.append((k_k, t_k))
            pts = sorted(set(pts))
            if len(pts) >= 3:
                ks = np.array([p[0] for p in pts], dtype=float)
                ts = np.array([p[1] for p in pts], dtype=float)
                slope1, floor = np.polyfit(ks, ts, 1)
            else:
                slope1, floor = float("nan"), float("nan")

            row[f"{meth}_wall_s"] = round(t_conv, 4)
            row[f"{meth}_iters"] = k_conv
            row[f"{meth}_fit_points"] = [[int(k), round(t, 4)]
                                         for k, t in pts]
            row[f"{meth}_slope_stage1_us_per_iter"] = round(slope1 * 1e6, 2)
            row[f"{meth}_dispatch_floor_ms"] = round(floor * 1e3, 2)
            row[f"{meth}_cap_wall_s"] = round(t_cap, 4)
            row[f"{meth}_cap_iters"] = k_cap
            if meth == "gmres":
                stages = _gmres_stages(min(cap, A.shape[0]))
                row["gmres_buffer_stages"] = stages
                if len(pts) >= 3 and k_cap > stages[0] and pts:
                    k_last, t_last = pts[-1]
                    # marginal cost beyond stage 1 (mixes later widths +
                    # one growth dispatch per stage — labeled, not a floor)
                    row["gmres_slope_later_stages_us_per_iter"] = round(
                        (t_cap - t_last) / max(k_cap - k_last, 1) * 1e6, 2)
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {"protocol": "fixed maxiter (fixed buffer schedule); >=3 "
                       "tolerance-targeted points inside buffer stage 1; "
                       "least-squares t(k)=floor+slope*k; best-of-"
                       f"{args.repeat} fresh dispatches",
           "tol": TOL, "rows": rows,
           "device": device}
    out_dir = os.path.join(os.path.dirname(__file__), "results")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "krylov_slope.json")
    json.dump(out, open(path, "w"), indent=1)
    print(f"# wrote {path}")


if __name__ == "__main__":
    main()
