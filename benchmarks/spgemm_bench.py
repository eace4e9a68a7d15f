"""Device masked-SpGEMM benchmark (the XLA gather formulation).

Measures the numeric Galerkin stage (role of the reference's serial
``R*A*P``, classical/classical.py:187) on the attached device at 1M rows:
``AP = masked(A @ P)`` and ``RAP = masked(R @ AP)`` over host-symbolic
patterns, reporting warm per-product seconds timed to
``block_until_ready``.

Usage: python benchmarks/spgemm_bench.py [--side 1024] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def build_operands(n_side):
    """Level-0 classical operands: A (5-pt Poisson), P (direct interp)."""
    import scipy.sparse as sp

    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.classical.classical import ruge_stuben_solver

    A = poisson((n_side, n_side), format="csr")
    ml = ruge_stuben_solver(A, max_levels=2, max_coarse=10)
    P = sp.csr_matrix(ml.levels[0].P_csr if hasattr(ml.levels[0], "P_csr")
                      else ml.levels[0].P)
    R = sp.csr_matrix(P.T)
    R.sort_indices()
    return sp.csr_matrix(A), P, R


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    from _harness import require_gpu, use_compile_cache
    from pyamg_tpu.sparse.ell import SparseELL
    from pyamg_tpu.sparse.spgemm_device import (
        masked_spgemm_ell, rap_pattern, sentinel_cols)

    device = require_gpu("spgemm_bench.py")
    use_compile_cache()
    A_csr, P_csr, R_csr = build_operands(args.side)
    n = A_csr.shape[0]
    print(f"n={n} nnz(A)={A_csr.nnz} nnz(P)={P_csr.nnz}", flush=True)

    t0 = time.perf_counter()
    A = SparseELL.from_scipy(A_csr, dtype=np.float32)
    P = SparseELL.from_scipy(P_csr, dtype=np.float32)
    R = SparseELL.from_scipy(R_csr, dtype=np.float32)
    pat_AP, pat_RAP = rap_pattern(R_csr, A_csr, P_csr, dtype=np.float32)
    oc_AP = jax.device_put(sentinel_cols(pat_AP))
    oc_RAP = jax.device_put(sentinel_cols(pat_RAP))
    print(f"staging+patterns: {time.perf_counter()-t0:.1f}s "
          f"w_A={A.width} w_P={P.width} w_R={R.width} "
          f"w_AP={pat_AP.width} w_RAP={pat_RAP.width}", flush=True)

    result = {"device": device, "n": n, "nnz_A": int(A_csr.nnz),
              "widths": {
        "A": A.width, "P": P.width, "R": R.width,
        "AP": pat_AP.width, "RAP": pat_RAP.width}}

    # ---- reference numeric values (host f32 masked product) ----
    import scipy.sparse as sp
    AP_ref = sp.csr_matrix((A_csr.astype(np.float32) @
                            P_csr.astype(np.float32)))

    def run_impl(name, fn_ap, fn_rap):
        # warm (compile)
        t0 = time.perf_counter()
        AP = fn_ap()
        jax.block_until_ready(AP.data)
        print(f"[{name}] AP compile+run: {time.perf_counter()-t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        RAP = fn_rap(AP)
        jax.block_until_ready(RAP.data)
        print(f"[{name}] RAP compile+run: {time.perf_counter()-t0:.1f}s", flush=True)
        # correctness vs host product
        err = abs(AP.to_scipy().astype(np.float64)
                  - AP_ref.astype(np.float64)).max()
        scale = abs(AP_ref).max()
        rel = float(err / scale)
        print(f"[{name}] AP rel err vs host: {rel:.2e}", flush=True)
        times_ap, times_rap = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            AP = fn_ap()
            jax.block_until_ready(AP.data)
            times_ap.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            RAP = fn_rap(AP)
            jax.block_until_ready(RAP.data)
            times_rap.append(time.perf_counter() - t0)
        result[name] = {"ap_s": min(times_ap), "rap_s": min(times_rap),
                        "ap_runs": times_ap, "rap_runs": times_rap,
                        "ap_rel_err": rel}
        print(f"[{name}] warm best: AP {min(times_ap):.3f}s "
              f"RAP {min(times_rap):.3f}s", flush=True)

    run_impl(
        "xla_gather",
        lambda: masked_spgemm_ell(A, P, pat_AP, out_cols=oc_AP),
        lambda AP: masked_spgemm_ell(R, AP, pat_RAP, out_cols=oc_RAP),
    )

    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
