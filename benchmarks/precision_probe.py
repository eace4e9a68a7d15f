"""Which float32 contractions of the solve path reach a GEMM on the GPU, and
at what precision.

    python benchmarks/precision_probe.py > precision.jsonl

At DEFAULT precision a GPU may run a float32 GEMM in TF32 (a 10-bit
mantissa).  XLA's GPU compiler rewrites some dots into a multiply and a
reduction before it picks a GEMM, and those never see TF32.  The script
compiles the programs below with XLA's HLO dump on, then prints, for every
optimized module, each float32 dot or cuBLAS call that survived with its
operand precision, and for the two micro cases the error against numpy f64:

* ``vdot_default`` / ``vdot_highest``: ``jnp.vdot`` of two f32 vectors of
  4,194,304 entries;
* ``matvec_default`` / ``matvec_highest``: a 4096x4096 f32 matrix times a
  vector (the size of the dense coarse operator phase 4 of chip_smoke.py
  checks);
* the f32 programs of ``solve_mp`` on 512^2 Poisson (the flagship's
  solver settings), with ``method="pcg"`` and V-cycles and with
  ``method="defect"`` and AMLI cycles.

Needs a GPU.
"""

import glob
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

_OP = re.compile(r"^\s*(?:ROOT\s+)?\S+\s*=\s*(.*?)\s+(dot|custom-call)\(")
_CUBLAS = re.compile(r"custom_call_target=\"(__cublas[^\"]*)\"")
_HLO_PREC = re.compile(r"operand_precision=\{([^}]*)\}")
_CFG_PREC = re.compile(r"\"operand_precision\":\[([^\]]*)\]")
_ALGO = re.compile(r"algorithm[\"=:]+\"?(\w+)")


def contractions(hlo_text):
    """Every dot and cuBLAS GEMM call with a float32 result in an optimized
    HLO module: ``{"op", "result", "precision", "algorithm"}``."""
    found = []
    for line in hlo_text.splitlines():
        m = _OP.search(line)
        if not m or re.match(r"\(?f32\[", m.group(1)) is None:
            continue
        if m.group(2) == "dot":
            op, prec = "dot", _HLO_PREC.search(line)
        else:
            target = _CUBLAS.search(line)
            if not target:
                continue
            op, prec = target.group(1), _CFG_PREC.search(line)
        algo = _ALGO.search(line)
        found.append({
            "op": op, "result": m.group(1),
            "precision": (prec.group(1).replace('"', "").lower()
                          if prec else "default"),
            "algorithm": algo.group(1) if algo else None})
    return found


def _max_rel(y, yref):
    yref = np.asarray(yref, dtype=np.float64)
    return float(np.abs(np.asarray(y, dtype=np.float64) - yref).max()
                 / np.abs(yref).max())


def run(n_vec=4194304, n_mat=4096, grid=(512, 512), seed=0):
    """Run every case; return ``{case: max rel err}`` for the micro cases
    and the relres of the solves."""
    import jax
    import jax.numpy as jnp
    import pyamg_tpu
    from pyamg_tpu.gallery import poisson

    rng = np.random.default_rng(seed)
    hi = jax.lax.Precision.HIGHEST
    u = rng.standard_normal(n_vec).astype(np.float32)
    v = rng.standard_normal(n_vec).astype(np.float32)
    M = rng.standard_normal((n_mat, n_mat)).astype(np.float32)
    x = rng.standard_normal(n_mat).astype(np.float32)

    def vdot_default(a, b):
        return jnp.vdot(a, b)

    def vdot_highest(a, b):
        return jnp.vdot(a, b, precision=hi)

    def matvec_default(m, y):
        return m @ y

    def matvec_highest(m, y):
        return jnp.matmul(m, y, precision=hi)

    err = {}
    uv = u.astype(np.float64) * v.astype(np.float64)
    for f in (vdot_default, vdot_highest):
        # error relative to sum |u_i v_i|, the scale of rounding in a sum
        err[f.__name__] = float(abs(float(jax.jit(f)(u, v)) - uv.sum())
                                / np.abs(uv).sum())
    ref = M.astype(np.float64) @ x.astype(np.float64)
    for f in (matvec_default, matvec_highest):
        err[f.__name__] = _max_rel(jax.jit(f)(M, x), ref)

    A = poisson(grid, format="csr")
    b = A @ rng.random(A.shape[0])
    ml = pyamg_tpu.smoothed_aggregation_solver(
        A, max_coarse=500, presmoother="chebyshev",
        postsmoother="chebyshev", improve_candidates=None,
        op_dtype=jnp.float32)
    for name, kw in (("solve_mp_pcg_V", {}),
                     ("solve_mp_defect_AMLI", {"method": "defect",
                                               "cycle": "AMLI"})):
        xs = ml.solve_mp(b, tol=1e-10, **kw)
        err[name] = float(np.linalg.norm(b - A @ np.asarray(xs))
                          / np.linalg.norm(b))
    return err


def main():
    dump = tempfile.mkdtemp(prefix="hlo_dump_")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={dump}"
                               " --xla_dump_hlo_as_text")
    import jax

    from _harness import card_info, require_gpu

    device = require_gpu("precision_probe.py")
    jax.config.update("jax_enable_x64", True)        # solve_mp needs f64
    err = run()
    n_f32_default = 0
    for path in sorted(glob.glob(os.path.join(
            dump, "*after_optimizations.txt"))):
        found = contractions(open(path).read())
        if not found:
            continue
        module = os.path.basename(path).split(".")[1]
        n_f32_default += sum(c["precision"] != "highest,highest"
                             for c in found)
        print(json.dumps({"module": module, "f32_contractions": found}),
              flush=True)
    print(json.dumps({"errors": err}))
    print(json.dumps({"device_kind": device["kind"], "cards": card_info(),
                      "f32_contractions_not_highest": n_f32_default}))


if __name__ == "__main__":
    main()
