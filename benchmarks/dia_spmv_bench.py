"""DIA SpMV bandwidth probe on the GPU: what XLA makes of ``SparseDIA.matvec``.

    python benchmarks/dia_spmv_bench.py > dia.jsonl

For each size (1M, 4.2M and 16.8M rows) and stencil (5 and 9 offsets) in
float32, 100 matvecs run inside one ``lax.fori_loop`` and the program is
timed to ``block_until_ready`` (best of 3, compiled beforehand).  A matvec
needs at least ``4 * n * (k + 2)`` bytes: the k diagonals, x and y, each
once.  That figure over the time per matvec is the achieved bandwidth,
reported as a share of the H100 SXM's published HBM3 bandwidth and beside a
plain copy (``y = a * x`` in the same kind of loop, 8n bytes) measured in
the same run.

Prints one JSON line per case and a summary line; needs an H100.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

# published HBM3 bandwidth of the H100 SXM (NVIDIA data sheet)
H100_HBM_BYTES_PER_S = 3.35e12
REPS = 100

GRIDS = ((1024, 1024), (2048, 2048), (4096, 4096))


def _stencils():
    five = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], dtype=np.float64)
    return (("5pt", five / 8.0), ("9pt", np.ones((3, 3)) / 9.0))


def _time(run, *args, repeats=3):
    import jax

    jax.block_until_ready(run(*args))          # compile and warm
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def probe(grids=GRIDS, reps=REPS):
    """Yield one result dict per (grid, stencil) case plus a copy baseline;
    stencils are scaled to norm <= 1 so the chained matvecs stay finite."""
    import jax
    import jax.numpy as jnp
    from pyamg_tpu.gallery import stencil_grid
    from pyamg_tpu.sparse import SparseDIA

    @jax.jit
    def chain(D, x):
        return jax.lax.fori_loop(0, reps, lambda i, v: D.matvec(v), x)

    @jax.jit
    def copy_chain(x):
        return jax.lax.fori_loop(0, reps, lambda i, v: v * 0.999, x)

    for grid in grids:
        n = int(np.prod(grid))
        x = jnp.asarray(np.random.default_rng(0).random(n, dtype=np.float32))
        t = _time(copy_chain, x) / reps
        yield {"case": "copy", "n": n, "us_per_app": t * 1e6,
               "bytes_per_app": 8 * n, "bytes_per_s": 8 * n / t}
        for name, sten in _stencils():
            D = SparseDIA.from_scipy(stencil_grid(sten, grid, format="csr"),
                                     dtype=np.float32)
            k = len(D.offsets)
            nbytes = 4 * n * (k + 2)
            t = _time(chain, D, x) / reps
            yield {"case": f"dia_{name}", "n": n, "offsets": k,
                   "us_per_app": t * 1e6, "bytes_per_app": nbytes,
                   "bytes_per_s": nbytes / t}


def main():
    from _harness import card_info, require_gpu, use_compile_cache

    device = require_gpu("dia_spmv_bench.py")
    if "H100" not in device["kind"]:
        raise SystemExit(f"dia_spmv_bench.py rates bandwidth against the "
                         f"H100's; JAX found {device['kind']!r}")
    use_compile_cache()
    for row in probe():
        row["peak_share"] = row["bytes_per_s"] / H100_HBM_BYTES_PER_S
        print(json.dumps(row), flush=True)
    print(json.dumps({"device_kind": device["kind"], "cards": card_info(),
                      "peak_bytes_per_s": H100_HBM_BYTES_PER_S,
                      "reps": REPS}))


if __name__ == "__main__":
    main()
