"""Reference pyamg adaptive SA with num_candidates=2 on aniso-1024.

Produces the reference setup/solve/iters column for the K=2
semicoarsening comparison (our side: adaptive_sa_solver with
num_candidates=2, candidate_iters=5, zebra smoothing — see
benchmarks/reference_harness/our_k2.py).  Writes /tmp/ref_k2.json.

Run:  python benchmarks/reference_harness/ref_k2.py [grid]
"""
import json
import sys
import time

import numpy as np

import ref_harness  # noqa: F401
import pyamg
from pyamg.gallery import stencil_grid
from pyamg.gallery.diffusion import diffusion_stencil_2d

g = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
sten = diffusion_stencil_2d(epsilon=0.001, theta=0.0, type="FD")
A = stencil_grid(sten, (g, g), format="csr")
rng = np.random.default_rng(0)
b = np.asarray(A @ rng.random(A.shape[0])).ravel()

t0 = time.time()
ml, work = pyamg.aggregation.adaptive.adaptive_sa_solver(
    A, num_candidates=2, candidate_iters=5, max_coarse=100)
ts = time.time() - t0

res = []
t0 = time.time()
x = ml.solve(b, tol=1e-10, accel="cg", maxiter=400, residuals=res)
tsol = time.time() - t0
rr = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))

out = {
    "config": "adaptive_sa_anisotropy_K2",
    "grid": g,
    "n": int(A.shape[0]),
    "num_candidates": 2,
    "candidate_iters": 5,
    "setup_s": round(ts, 2),
    "solve_s": round(tsol, 3),
    "iters": len(res) - 1,
    "relres": rr,
    "opc": round(float(ml.operator_complexity()), 3),
}
print(out, flush=True)
json.dump(out, open("/tmp/ref_k2.json", "w"), indent=1)
