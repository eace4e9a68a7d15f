"""Multigrid hierarchy runtime: levels, cycles, coarse solves.

Reference parity: pyamg/multilevel.py (``multilevel_solver`` :14, ``solve``
:316, ``aspreconditioner`` :274, ``coarse_grid_solver`` :554,
``multilevel_solver_set`` :723).

Device design (SURVEY.md §7.4): the whole V/W/F cycle is *one compiled
XLA program* — the level list is static, so the recursion unrolls at trace
time into a flat chain of SpMVs, smoother sweeps and one dense coarse solve;
no host round-trips inside a cycle.  The compiled cycle is cached per
(cycle type, dtype) on the solver object.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .sparse import SparseELL
from .relaxation.device import apply_smoother
from .util.utils import unpack_arg

__all__ = ["Level", "MultilevelSolver", "multilevel_solver",
           "coarse_grid_solver", "MultilevelSolverSet",
           "multilevel_solver_set"]


class Level:
    """One level of the hierarchy.

    Holds the device operators (DIA / dense / padded-ELL / composed grid
    ops) used by the compiled cycle, the host CSR twin used by the
    (host-staged) setup phase, and any setup byproducts (``B``, ``C``,
    ``AggOp``, ``T``, ``splitting``) kept for inspection, mirroring the
    reference's ``level`` struct (multilevel.py:45-68).
    """

    A: SparseELL
    P: Optional[SparseELL]
    R: Optional[SparseELL]

    def __init__(self, **kw):
        self.presmoother = None
        self.postsmoother = None
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def nnz(self):
        if hasattr(self, "A_csr"):
            return self.A_csr.nnz
        if getattr(self, "_nnz_cache", None) is None:
            self._nnz_cache = self.A.nnz     # may transfer once (lazy)
        return self._nnz_cache


_DENSE_COARSE_NAMES = ("pinv", "pinv2", "cholesky", "lu", "splu")


def _build_coarse_state(A_csr, name, kwargs=None, dtype=None):
    """Host-factorize the coarsest operator once; return ``(kind, state)``
    where ``state`` is a tuple of (small) device arrays consumed by
    :func:`_apply_coarse` inside the compiled cycle.

    Each name keeps its reference semantics (reference multilevel.py:554-720):
    ``pinv``/``pinv2`` are dense pseudoinverses, ``lu`` is a dense LU
    factorization, ``cholesky`` a dense Cholesky factorization (raises on a
    non-SPD coarse grid, as the reference's ``cho_factor`` does), and
    ``splu`` removes exactly-zero columns/rows first (reference
    multilevel.py:629-641) and then solves through the sparse-LU triangular
    factors.
    """
    import scipy.linalg as sla
    import scipy.sparse.linalg as spla

    kwargs = kwargs or {}

    def dev(a):
        a = np.asarray(a)
        if dtype is not None and np.issubdtype(a.dtype, np.inexact):
            tgt = np.dtype(str(jnp.dtype(dtype)))
            if np.iscomplexobj(a) and not np.issubdtype(tgt,
                                                        np.complexfloating):
                tgt = np.dtype({"float32": "complex64",
                                "float64": "complex128"}[tgt.name])
            a = a.astype(tgt)
        from .util.staging import stage_array
        return stage_array(a)

    if name in ("pinv", "pinv2"):
        return "dense", (dev(np.linalg.pinv(A_csr.toarray())),)
    if name == "lu":
        lu, piv = sla.lu_factor(A_csr.toarray(), **kwargs)
        return "lu", (dev(lu), dev(piv.astype(np.int32)))
    if name == "cholesky":
        c, _low = sla.cho_factor(A_csr.toarray(), lower=True, **kwargs)
        return "chol", (dev(np.tril(c)),)
    if name == "splu":
        Acsc = A_csr.tocsc().copy()
        Acsc.eliminate_zeros()
        keep = np.flatnonzero(np.diff(Acsc.indptr))   # columns with entries
        if keep.size < Acsc.shape[0]:
            Ared = Acsc[keep][:, keep].tocsc()
        else:
            Ared = Acsc
        f = spla.splu(Ared, **kwargs)
        pr_inv = np.argsort(f.perm_r).astype(np.int32)
        return "splu", (dev(f.L.toarray()), dev(f.U.toarray()),
                        dev(pr_inv),
                        dev(f.perm_c.astype(np.int32)),
                        dev(keep.astype(np.int32)))
    raise ValueError(f"not a dense/factorized coarse solver: {name!r}")


def _apply_coarse(kind, state, b):
    """Traceable coarse solve from a host-built factorization state."""
    if kind == "dense":
        return jnp.matmul(state[0], b, precision=jax.lax.Precision.HIGHEST
                          ).astype(b.dtype)
    if kind == "lu":
        lu, piv = state
        return jax.scipy.linalg.lu_solve(
            (lu.astype(b.dtype), piv), b).astype(b.dtype)
    if kind == "chol":
        return jax.scipy.linalg.cho_solve(
            (state[0].astype(b.dtype), True), b).astype(b.dtype)
    if kind == "splu":
        L, U, pr_inv, pc, keep = state
        br = b[keep]
        y = jax.scipy.linalg.solve_triangular(
            L.astype(b.dtype), br[pr_inv], lower=True, unit_diagonal=True)
        w = jax.scipy.linalg.solve_triangular(
            U.astype(b.dtype), y, lower=False)
        return jnp.zeros(b.shape, b.dtype).at[keep].set(w[pc])
    raise ValueError(f"unknown coarse state kind {kind!r}")


def coarse_grid_solver(solver):
    """Return a coarse-grid solver callable factory (reference
    multilevel.py:554-720).

    The returned object has ``__call__(A_csr, b)`` semantics on host and a
    ``prepare(A_csr) -> device_fn`` method producing a traceable solver for
    the compiled cycle.  Supported: pinv, pinv2, lu, cholesky, splu, cg,
    gmres, jacobi, gauss_seidel, and any callable.
    """
    solver, kwargs = unpack_arg(solver) if not callable(solver) else (solver, {})

    class _Coarse:
        name = solver if isinstance(solver, str) else "callable"

        def prepare(self, A_csr):
            """Build a device function b -> x solving A x = b."""
            import scipy.sparse as sp

            n = A_csr.shape[0]
            if callable(solver):
                def dev(b):
                    return jnp.asarray(
                        solver(A_csr, np.asarray(b), **kwargs))
                return dev, False       # not traceable
            if self.name in _DENSE_COARSE_NAMES:
                kind, state = _build_coarse_state(A_csr, self.name, kwargs)

                def dev(b):
                    return _apply_coarse(kind, state, b)
                return dev, True
            if self.name in ("jacobi", "gauss_seidel", "block_jacobi"):
                from .relaxation import relaxation as rel

                fn = getattr(rel, self.name)

                def dev(b):
                    x = np.zeros_like(np.asarray(b))
                    fn(A_csr, x, np.asarray(b),
                       iterations=kwargs.get("iterations", 10))
                    return jnp.asarray(x)
                return dev, False
            if self.name in ("cg", "gmres", "bicgstab"):
                import scipy.sparse.linalg as spla

                def dev(b):
                    x, _ = getattr(spla, self.name)(
                        A_csr, np.asarray(b),
                        rtol=kwargs.get("tol", 1e-12),
                        maxiter=kwargs.get("maxiter", None))
                    return jnp.asarray(x)
                return dev, False
            raise ValueError(f"unknown coarse solver {self.name!r}")

        def __call__(self, A_csr, b):
            fn, _ = self.prepare(A_csr)
            return np.asarray(fn(jnp.asarray(b)))

    return _Coarse()


class MultilevelSolver:
    """Multigrid hierarchy + compiled cycle executor.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu.gallery import poisson
    >>> from pyamg_tpu import ruge_stuben_solver
    >>> A = poisson((32, 32), format='csr')
    >>> ml = ruge_stuben_solver(A)
    >>> b = np.ones(A.shape[0])
    >>> res = []
    >>> x = ml.solve(b, tol=1e-8, residuals=res)
    >>> res[-1] < 1e-8 * res[0]
    True
    >>> len(ml.levels) > 1
    True
    """

    def __init__(self, levels: List[Level], coarse_solver="pinv"):
        self.levels = levels
        self.coarse_solver_spec = coarse_solver
        self._coarse = coarse_grid_solver(coarse_solver)
        self._coarse_fn = None
        self._coarse_traceable = False
        self._coarse_kind = None
        self._A64_dev = None
        self._cycle_cache = {}
        self._solve_cache = {}
        self._devh = None
        self.symmetry = getattr(levels[0], "symmetry", "hermitian") \
            if levels else "hermitian"

    # -- introspection ----------------------------------------------------
    def __repr__(self):
        output = f"{type(self).__name__}\n"
        output += f"Number of Levels:     {len(self.levels)}\n"
        output += f"Operator Complexity: {self.operator_complexity():6.3f}\n"
        output += f"Grid Complexity:     {self.grid_complexity():6.3f}\n"
        total_nnz = sum(lvl.nnz for lvl in self.levels)
        output += "level   unknowns     nonzeros\n"
        for n, lvl in enumerate(self.levels):
            output += (f"  {n:2d}   {lvl.A.shape[0]:10d}   {lvl.nnz:10d} "
                       f"[{100.0 * lvl.nnz / max(total_nnz, 1):2.2f}%]\n")
        return output

    def operator_complexity(self):
        """sum(nnz_l) / nnz_0 (reference multilevel.py:178)."""
        return sum(lvl.nnz for lvl in self.levels) / self.levels[0].nnz

    def grid_complexity(self):
        """sum(n_l) / n_0 (reference multilevel.py:197)."""
        return (sum(lvl.A.shape[0] for lvl in self.levels)
                / self.levels[0].A.shape[0])

    def cycle_complexity(self, cycle="V"):
        """Approximate work per cycle in units of fine-grid nnz
        (reference multilevel.py:205-269)."""
        cycle = str(cycle).upper()
        nnz = [lvl.nnz for lvl in self.levels]

        def V(level):
            if len(self.levels) == 1:
                return nnz[0]
            if level == len(self.levels) - 2:
                return 2 * nnz[level] + nnz[level + 1]
            return 2 * nnz[level] + V(level + 1)

        def W(level):
            if len(self.levels) == 1:
                return nnz[0]
            if level == len(self.levels) - 2:
                return 2 * nnz[level] + nnz[level + 1]
            return 2 * nnz[level] + 2 * W(level + 1)

        def F(level):
            if len(self.levels) == 1:
                return nnz[0]
            if level == len(self.levels) - 2:
                return 2 * nnz[level] + nnz[level + 1]
            return 2 * nnz[level] + F(level + 1) + V(level + 1)

        if cycle == "V":
            flops = V(0)
        elif cycle in ("W", "AMLI"):
            flops = W(0)
        elif cycle == "F":
            flops = F(0)
        else:
            raise TypeError(f"unrecognized cycle type {cycle!r}")
        return float(flops) / float(nnz[0])

    # -- compiled cycle ---------------------------------------------------
    def _get_coarse_fn(self):
        if self._coarse_fn is None:
            A_c = self.levels[-1].A_csr
            raw, traceable = self._coarse.prepare(A_c)

            def fn(b):
                out = raw(b)
                return out.astype(b.dtype)      # keep the carry dtype stable

            self._coarse_fn, self._coarse_traceable = fn, traceable
        return self._coarse_fn

    def _dev(self):
        """The hierarchy as ONE pytree, passed as an *argument* to every
        compiled program (never closed over: large closure constants would
        be embedded into the serialized HLO)."""
        if getattr(self, "_devh", None) is None:
            from .util.staging import staging, batch_device_put

            override = getattr(self, "_coarse_mat_override", None)
            coarse_mat, traceable = None, False
            if override is not None:
                coarse_mat, traceable = (override,), True
                self._coarse_kind = "dense"
            else:
                spec = self.coarse_solver_spec
                name, ckw = unpack_arg(spec) if not callable(spec) \
                    else (spec, {})
                if isinstance(name, str) and name in _DENSE_COARSE_NAMES:
                    with staging():
                        kind, state = _build_coarse_state(
                            self.levels[-1].A_csr, name, ckw,
                            dtype=getattr(self, "_op_dtype", None))
                    coarse_mat, traceable = state, True
                    self._coarse_kind = kind
            devh = {
                "As": tuple(l.A for l in self.levels),
                "Ps": tuple(getattr(l, "P", None) for l in self.levels[:-1]),
                "Rs": tuple(getattr(l, "R", None) for l in self.levels[:-1]),
                "pres": tuple(l.presmoother for l in self.levels),
                "posts": tuple(l.postsmoother for l in self.levels),
                "coarse": coarse_mat,
            }
            # Finalize/change_smoothers stage their arrays host-side; one
            # batched device_put here ships the whole hierarchy in a single
            # transfer instead of one per array.  Leaves that are already
            # device arrays pass through unchanged.
            devh = batch_device_put(devh)
            # Write the device versions back so later eager access (tests,
            # shard_solver re-placement) sees device arrays, not the staged
            # numpy twins.
            for i, lvl in enumerate(self.levels):
                lvl.A = devh["As"][i]
                lvl.presmoother = devh["pres"][i]
                lvl.postsmoother = devh["posts"][i]
                if i < len(self.levels) - 1:
                    if devh["Ps"][i] is not None:
                        lvl.P = devh["Ps"][i]
                    if devh["Rs"][i] is not None:
                        lvl.R = devh["Rs"][i]
            self._devh = devh
            self._coarse_mat_traceable = traceable
        return self._devh

    def _raw_cycle(self, cycle: str):
        """Jitted ``f(hier, x, b)`` for one cycle; hier is the pytree arg."""
        cycle = str(cycle).upper()
        key = ("raw", cycle)
        if key in self._cycle_cache:
            return self._cycle_cache[key]

        self._dev()                       # sets _coarse_mat_traceable
        nlev = len(self.levels)
        if self._coarse_mat_traceable:
            kind = self._coarse_kind

            def solve_coarse(hier, b):
                return _apply_coarse(kind, hier["coarse"], b)
        else:
            coarse_fn = self._get_coarse_fn()

            def solve_coarse(hier, b):
                return jax.pure_callback(
                    lambda bb: np.asarray(coarse_fn(bb), dtype=bb.dtype),
                    jax.ShapeDtypeStruct(b.shape, b.dtype), b)

        def recurse(hier, lvl: int, x, b, kind: str):
            A = hier["As"][lvl]
            if lvl == nlev - 1:
                return solve_coarse(hier, b)
            x = apply_smoother(hier["pres"][lvl], A, x, b)
            r = b - A.matvec(x)
            bc = hier["Rs"][lvl].matvec(r)
            xc = jnp.zeros(hier["As"][lvl + 1].shape[0], dtype=b.dtype)
            if lvl + 1 == nlev - 1:
                xc = solve_coarse(hier, bc)
            elif kind == "V":
                xc = recurse(hier, lvl + 1, xc, bc, "V")
            elif kind == "W":
                xc = recurse(hier, lvl + 1, xc, bc, "W")
                xc = recurse(hier, lvl + 1, xc, bc, "W")
            elif kind == "F":
                xc = recurse(hier, lvl + 1, xc, bc, "F")
                xc = recurse(hier, lvl + 1, xc, bc, "V")
            elif kind == "AMLI":
                # AMLI: 2 coarse iterations, A-conjugate directions
                # (reference multilevel.py:520-539)
                Ac = hier["As"][lvl + 1]
                p0 = recurse(hier, lvl + 1, jnp.zeros_like(bc), bc, "AMLI")
                Ap0 = Ac.matvec(p0)
                alpha0 = jnp.vdot(p0, bc) / jnp.where(
                    jnp.vdot(p0, Ap0) == 0, 1, jnp.vdot(p0, Ap0))
                xc = alpha0 * p0
                rc = bc - alpha0 * Ap0
                p1 = recurse(hier, lvl + 1, jnp.zeros_like(bc), rc, "AMLI")
                Ap1 = Ac.matvec(p1)
                beta = jnp.vdot(p0, Ap1) / jnp.where(
                    jnp.vdot(p0, Ap0) == 0, 1, jnp.vdot(p0, Ap0))
                p1 = p1 - beta * p0
                Ap1 = Ac.matvec(p1)
                denom = jnp.where(jnp.vdot(p1, Ap1) == 0, 1,
                                  jnp.vdot(p1, Ap1))
                alpha1 = jnp.vdot(p1, rc) / denom
                xc = xc + alpha1 * p1
            else:
                raise TypeError(f"unrecognized cycle type {kind!r}")
            x = x + hier["Ps"][lvl].matvec(xc)
            x = apply_smoother(hier["posts"][lvl], A, x, b)
            return x

        def one_cycle(hier, x, b):
            return recurse(hier, 0, x, b, cycle)

        fn = jax.jit(one_cycle)
        self._cycle_cache[key] = fn
        return fn

    def _build_cycle(self, cycle: str):
        raw = self._raw_cycle(cycle)

        def bound(x, b):
            return raw(self._dev(), x, b)

        return bound

    def astype(self, dtype):
        """Cast every device operator and smoother to ``dtype`` in place
        (mixed-precision hierarchies: e.g. an f32 preconditioner built from
        an f64 setup).  Host CSR twins keep their original dtype."""
        for lvl in self.levels:
            lvl.A = lvl.A.astype(dtype)
            if hasattr(lvl, "P") and lvl.P is not None:
                lvl.P = lvl.P.astype(dtype)
                lvl.R = lvl.R.astype(dtype)
            if lvl.presmoother is not None:
                lvl.presmoother = lvl.presmoother.astype(dtype)
            if lvl.postsmoother is not None:
                lvl.postsmoother = lvl.postsmoother.astype(dtype)
        self._cycle_cache = {}
        self._solve_cache = {}
        self._coarse_fn = None
        self._devh = None
        self._A64_dev = None
        self._op_dtype = dtype
        return self

    def cycle_fn(self, cycle="V"):
        cycle = str(cycle).upper()
        if cycle not in self._cycle_cache:
            self._cycle_cache[cycle] = self._build_cycle(cycle)
        return self._cycle_cache[cycle]

    def _raw_accel(self, accel, cycle, maxiter):
        """Jitted ``run(hier, x0, b, tol_t)`` Krylov program; the hierarchy
        is an argument (no large closure constants in the HLO)."""
        key = (accel, str(cycle).upper(), maxiter)
        if key not in self._solve_cache:
            import functools

            from .krylov._cg import cg_core
            from .krylov._cgs_family import (bicgstab_core, cr_core,
                                             steepest_descent_core,
                                             minimal_residual_core)
            from .krylov._gmres import gmres_core

            cores = {
                "cg": cg_core,
                "bicgstab": bicgstab_core,
                "cr": cr_core,
                "steepest_descent": steepest_descent_core,
                "minimal_residual": minimal_residual_core,
                "gmres": functools.partial(gmres_core,
                                           restrt=min(30, maxiter)),
                "fgmres": functools.partial(gmres_core,
                                            restrt=min(30, maxiter),
                                            flexible=True),
            }
            core = cores[accel]
            raw_cyc = self._raw_cycle(cycle)

            @jax.jit
            def run(hier, x0, b, tol_t):
                def mv(v):
                    return hier["As"][0].matvec(v)

                def pre(r):
                    return raw_cyc(hier, jnp.zeros_like(r), r)

                return core(mv, pre, x0, b, tol_t, maxiter)

            self._solve_cache[key] = run
        return self._solve_cache[key]

    def _get_cached_accel(self, accel, cycle, maxiter):
        run = self._raw_accel(accel, cycle, maxiter)
        hier = self._dev()

        def bound(x0, b, tol_t):
            return run(hier, x0, b, tol_t)

        return bound

    def _get_cached_standalone(self, cycle, maxiter):
        """Standalone cycling as dispatch-bounded chunks (same rationale as
        the chunked PCG: no single program runs unboundedly long; the carry
        makes chunking exact)."""
        key = ("standalone", str(cycle).upper(), maxiter)
        if key not in self._solve_cache:
            raw_cyc = self._raw_cycle(cycle)

            @jax.jit
            def init(hier, x0, b):
                A = hier["As"][0]
                r0 = b - A.matvec(x0)
                res_buf = jnp.zeros(
                    maxiter + 1,
                    dtype=jnp.real(jnp.zeros(0, b.dtype)).dtype)
                res_buf = res_buf.at[0].set(jnp.linalg.norm(r0))
                return (x0, 0, res_buf)

            @jax.jit
            def chunk(hier, b, carry, tol_t, it_cap):
                A = hier["As"][0]

                def body(c):
                    x, it, res_buf = c
                    x = raw_cyc(hier, x, b)
                    r = b - A.matvec(x)
                    it = it + 1
                    res_buf = res_buf.at[it].set(jnp.linalg.norm(r))
                    return (x, it, res_buf)

                def cond(c):
                    return (c[2][c[1]] > tol_t) & (c[1] < it_cap)

                out = jax.lax.while_loop(cond, body, carry)
                stat = jnp.stack([out[2][out[1]],
                                  out[1].astype(out[2].dtype)])
                return out, stat

            self._solve_cache[key] = (init, chunk)
        init, chunk = self._solve_cache[key]
        hier = self._dev()

        def bound(x0, b, tol_t):
            carry = init(hier, x0, b)
            carry, _it, _rounds, _stat = self._drive_chunks(
                lambda c, cap: chunk(hier, b, c, tol_t, cap),
                carry, float(tol_t), maxiter,
                first_chunk=self._first_chunk_guess(maxiter))
            return carry

        return bound

    def _solve_mp_pcg(self, A64, b, tol, accel, cycle, maxiter,
                      return_info):
        """f64 Krylov with the f32 hierarchy as preconditioner (see
        :meth:`solve_mp`, method='pcg').

        accel='cg' runs in dispatch-bounded CHUNKS: some device runtimes
        cap how long a single program may run, so the CG while_loop is
        re-dispatched with its carry every ``_CHUNK_TARGET_S`` of measured
        wall time.  Whether a GPU needs the bound at all is unmeasured.
        The chunk cap is a traced scalar — one compile serves every chunk
        length — and the iterate sequence is identical to a single fused
        loop."""
        if accel == "cg":
            return self._solve_mp_pcg_cg_chunked(A64, b, tol, cycle,
                                                 maxiter, return_info)
        # bicgstab/gmres/fgmres run through the SAME dispatch-bounded chunk
        # driver as cg: a per-dispatch time cap does not care which Krylov
        # method is in the program.  gmres/fgmres
        # chunk at restart boundaries (the basis is discarded there anyway).
        key = ("mp_pcg_chunk", accel, str(cycle).upper(), int(maxiter))
        if key not in self._solve_cache:
            from .krylov._cgs_family import bicgstab_init, bicgstab_chunk
            from .krylov._gmres import gmres_init, gmres_chunk

            raw_cyc = self._raw_cycle(cycle)

            def _ops(hier, A64, dt64):
                f32 = hier["As"][0].dtype

                def mv(v):
                    return A64.matvec(v)

                def pre(r64):
                    # scale to O(1) before the f32 cast: late-stage
                    # residuals (~1e-10*||b||) underflow f32 otherwise
                    s = jnp.linalg.norm(r64)
                    s = jnp.where(s == 0, 1.0, s)
                    r32 = (r64 / s).astype(f32)
                    z32 = raw_cyc(hier, jnp.zeros_like(r32), r32)
                    return z32.astype(dt64) * s

                return mv, pre

            if accel == "bicgstab":
                @jax.jit
                def init(hier, A64, b64):
                    mv, pre = _ops(hier, A64, b64.dtype)
                    return bicgstab_init(mv, pre, jnp.zeros_like(b64), b64,
                                         int(maxiter))

                piggy = self.levels[0].A.shape[0] <= self._PIGGYBACK_N

                @jax.jit
                def chunk(hier, A64, b64, carry, tol_abs, it_cap):
                    mv, pre = _ops(hier, A64, carry[0].dtype)
                    out = bicgstab_chunk(mv, pre, carry, tol_abs, it_cap)
                    stat = jnp.stack([out[-1][out[-2]].astype(jnp.float64),
                                      out[-2].astype(jnp.float64)])
                    return out, self._stat_x(stat, out[0], piggy)
            else:
                flexible = accel == "fgmres"
                restrt = min(30, int(maxiter))

                @jax.jit
                def init(hier, A64, b64):
                    mv, pre = _ops(hier, A64, b64.dtype)
                    return gmres_init(mv, pre, jnp.zeros_like(b64), b64,
                                      int(maxiter))

                piggy = self.levels[0].A.shape[0] <= self._PIGGYBACK_N

                @jax.jit
                def chunk(hier, A64, b64, carry, tol_abs, it_cap):
                    mv, pre = _ops(hier, A64, carry[0].dtype)
                    out = gmres_chunk(mv, pre, b64, carry, tol_abs, it_cap,
                                      int(maxiter), restrt=restrt,
                                      flexible=flexible)
                    # carry: (x, it, res_buf, outer, last)
                    stat = jnp.stack([out[-1].astype(jnp.float64),
                                      out[1].astype(jnp.float64)])
                    return out, self._stat_x(stat, out[0], piggy)

            self._solve_cache[key] = (init, chunk)
        init, chunk = self._solve_cache[key]

        op_dt = jnp.dtype(self.levels[0].A.dtype)
        dt64 = jnp.complex128 if np.iscomplexobj(np.zeros(0, op_dt)) \
            else jnp.float64
        b_host = np.ravel(np.asarray(b))
        b64 = jnp.asarray(b_host, dtype=dt64)
        # host norm: np.asarray(b64) here would copy the whole vector back
        # to the host (a sync) before the solve starts
        normb = float(np.linalg.norm(
            b_host.astype(np.dtype(str(jnp.dtype(dt64))), copy=False)))
        tol_abs_f = tol * (normb if normb != 0 else 1.0)
        tol_abs = jnp.asarray(tol_abs_f, dtype=jnp.float64)

        hier = self._dev()
        carry = init(hier, A64, b64)
        carry, it, rounds, stat_np = self._drive_chunks(
            lambda c, cap: chunk(hier, A64, b64, c, tol_abs, cap),
            carry, tol_abs_f, maxiter,
            first_chunk=self._first_chunk_guess(maxiter))
        if accel == "gmres":
            # left-preconditioned GMRES tracks ||M r|| (reference
            # _gmres_mgs.py semantics); with an AMG cycle as M that can be
            # orders below the TRUE residual.  solve_mp promises a true
            # f64 relative residual, so verify and, if short, tighten the
            # tracked tolerance by the observed ratio and continue (restart
            # boundaries make continuation exact).
            for _ in range(4):
                if it >= maxiter:
                    break
                r_true = float(jnp.linalg.norm(b64 - A64.matvec(carry[0])))
                if r_true <= tol_abs_f or r_true == 0:
                    break
                tracked = float(np.asarray(carry[-1]))
                ratio = max(tracked / r_true, 1e-12)
                tol_t2 = tol_abs_f * ratio * 0.3
                carry, it, r2, stat_np = self._drive_chunks(
                    lambda c, cap: chunk(hier, A64, b64, c,
                                         jnp.asarray(tol_t2,
                                                     dtype=jnp.float64),
                                         cap),
                    carry, tol_t2, maxiter, it0=it)
                rounds += r2
        x64 = (stat_np[2:] if stat_np is not None and stat_np.shape[0] > 2
               else carry[0])
        if return_info:
            return x64, {"rounds": rounds, "inner_iterations": it}
        return x64

    _CHUNK_TARGET_S = 20.0       # wall-time budget per device dispatch

    def _first_chunk_guess(self, maxiter):
        """Initial chunk length from a conservative per-iteration wall
        estimate (20M effective nnz/s through cycle + f64 matvec, an
        unmeasured heuristic): small problems converge inside the FIRST
        dispatch instead of paying a second stat round-trip; big problems
        still start small enough that a bad estimate stays far below a
        per-dispatch time cap."""
        lvl0 = self.levels[0]
        nnz = None
        A_csr = getattr(lvl0, "A_csr", None)
        if A_csr is not None:
            nnz = A_csr.nnz
        else:
            A0 = getattr(lvl0, "A", None)
            if A0 is not None and hasattr(A0, "shape"):
                nnz = 9 * A0.shape[0]          # stencil-ish guess
        if not nnz:
            return 6
        t_guess = 5e-8 * float(nnz)            # seconds per iteration
        return int(np.clip(self._CHUNK_TARGET_S / max(t_guess, 1e-4),
                           6, min(256, maxiter)))

    _PIGGYBACK_N = 1 << 18       # piggyback x onto the stat D2H below this n

    @staticmethod
    def _stat_x(stat2, x, piggyback):
        """Append the iterate to the stat vector for small real-f64 solves:
        the solution rides the same D2H transfer as the convergence check
        (one device-to-host round-trip per solve instead of two)."""
        if piggyback and x.dtype == jnp.dtype(jnp.float64):
            return jnp.concatenate([stat2, x])
        return stat2

    def _drive_chunks(self, chunk_call, carry, tol_abs_f, maxiter,
                      first_chunk=6, it0=0):
        """Drive a dispatch-bounded device loop with depth-1 speculation.

        ``chunk_call(carry, it_cap) -> (carry, stat)`` continues the loop on
        device until ``res <= tol`` or ``it >= it_cap``; ``stat`` is a
        2-vector ``[res, it]``.  A converged carry passes through any
        further chunk as a no-op (the while_loop condition fails on entry),
        so the NEXT chunk can be enqueued before the previous chunk's stat
        arrives — the D2H stat fetch overlaps with device execution
        instead of stalling it.  The iterate
        sequence is identical to a single fused loop.

        ``stat`` may carry MORE than the 2 leading entries: small solves
        append the iterate x to the stat vector so the solution rides the
        same D2H transfer as the convergence check (one round-trip per
        solve instead of two).

        Returns ``(carry, it, rounds, last_stat)`` with ``last_stat`` the
        final fetched numpy stat vector.
        """
        import time as _time
        from collections import deque

        it, rounds = int(it0), 0
        chunk_n = int(first_chunk)
        caps_planned = int(it0)
        inflight = deque()
        last_fetch_t = _time.time()

        def enqueue():
            nonlocal carry, caps_planned
            cap = min(caps_planned + chunk_n, maxiter)
            carry, stat = chunk_call(carry, cap)
            inflight.append((stat, _time.time()))
            caps_planned = cap

        enqueue()
        if caps_planned < maxiter:
            enqueue()                        # speculative
        stat_np = None
        while inflight:
            stat, t_enq = inflight.popleft()
            stat_np = np.asarray(stat)       # ordered D2H; forces completion
            stat = stat_np
            now = _time.time()
            res, it_new = float(stat[0]), int(stat[1])
            advanced = it_new - it
            it = it_new
            rounds += 1
            if res <= tol_abs_f or advanced == 0 or it >= maxiter:
                break
            # per-iteration wall estimate: chunks execute serially on
            # device, so this chunk effectively started when the previous
            # fetch returned (minus one RTT) — use the later of enqueue
            # time and previous fetch time.  Overestimating shrinks chunks
            # (safe direction for a per-dispatch time cap).
            t_iter = (now - max(t_enq, last_fetch_t)) / max(advanced, 1)
            last_fetch_t = now
            chunk_n = int(np.clip(
                self._CHUNK_TARGET_S / max(t_iter, 1e-4), 4, maxiter))
            while caps_planned < maxiter and len(inflight) < 2:
                enqueue()
        return carry, it, rounds, stat_np

    def _solve_mp_pcg_cg_chunked(self, A64, b, tol, cycle, maxiter,
                                 return_info):
        key = ("mp_pcg_chunk", str(cycle).upper(), int(maxiter))
        if key not in self._solve_cache:
            from .krylov._cg import cg_init, cg_chunk

            raw_cyc = self._raw_cycle(cycle)

            def _ops(hier, A64, dt64):
                f32 = hier["As"][0].dtype

                def mv(v):
                    return A64.matvec(v)

                def pre(r64):
                    # scale to O(1) before the f32 cast: late-stage
                    # residuals (~1e-10*||b||) underflow f32 otherwise
                    s = jnp.linalg.norm(r64)
                    s = jnp.where(s == 0, 1.0, s)
                    r32 = (r64 / s).astype(f32)
                    z32 = raw_cyc(hier, jnp.zeros_like(r32), r32)
                    return z32.astype(dt64) * s

                return mv, pre

            @jax.jit
            def init(hier, A64, b64):
                mv, pre = _ops(hier, A64, b64.dtype)
                return cg_init(mv, pre, jnp.zeros_like(b64), b64,
                               int(maxiter))

            piggy = self.levels[0].A.shape[0] <= self._PIGGYBACK_N

            @jax.jit
            def chunk(hier, A64, carry, tol_abs, it_cap):
                mv, pre = _ops(hier, A64, carry[0].dtype)
                out = cg_chunk(mv, pre, carry, tol_abs, it_cap)
                stat = jnp.stack([out[-1][out[-2]].astype(jnp.float64),
                                  out[-2].astype(jnp.float64)])
                return out, self._stat_x(stat, out[0], piggy)

            self._solve_cache[key] = (init, chunk)
        init, chunk = self._solve_cache[key]

        op_dt = jnp.dtype(self.levels[0].A.dtype)
        dt64 = jnp.complex128 if np.iscomplexobj(np.zeros(0, op_dt)) \
            else jnp.float64
        b_host = np.ravel(np.asarray(b))
        b64 = jnp.asarray(b_host, dtype=dt64)
        # host norm: np.asarray(b64) here would copy the whole vector back
        # to the host (a sync) before the solve starts
        normb = float(np.linalg.norm(
            b_host.astype(np.dtype(str(jnp.dtype(dt64))), copy=False)))
        tol_abs_f = tol * (normb if normb != 0 else 1.0)
        tol_abs = jnp.asarray(tol_abs_f, dtype=jnp.float64)

        hier = self._dev()
        carry = init(hier, A64, b64)
        carry, it, rounds, stat_np = self._drive_chunks(
            lambda c, cap: chunk(hier, A64, c, tol_abs, cap),
            carry, tol_abs_f, maxiter,
            first_chunk=self._first_chunk_guess(maxiter))
        x64 = (stat_np[2:] if stat_np is not None and stat_np.shape[0] > 2
               else carry[0])
        if return_info:
            return x64, {"rounds": rounds, "inner_iterations": it}
        return x64

    # -- mixed-precision solve (f64 defect correction over f32 cycles) -----
    def solve_mp(self, b, tol=1e-10, accel="cg", cycle="V",
                 inner_maxiter=40, max_rounds=6, inner_tol_factor=1e-6,
                 return_info=False, method="pcg"):
        """Solve A x = b to an f64 relative residual ``tol`` using the f32
        device hierarchy as preconditioner.

        The reference solves in f64 end-to-end on the CPU
        (multilevel.py:316-471); on an accelerator the natural
        equivalents are

        ``method="pcg"`` (default): f64 preconditioned CG where each
        preconditioner application is one f32 cycle (r cast down, cycle,
        correction cast up).  Iteration counts match the reference's f64
        PCG (same preconditioner quality, no restart momentum loss); only
        the fine-level matvec and vector updates run in f64.

        ``method="defect"``: iterative refinement — f32 Krylov+cycles
        inside, one f64 fine-grid residual per round outside.  Cheaper per
        iteration, but each round restarts the Krylov space (~2x the
        reference iteration count to 1e-10).

        Either way the whole loop compiles into ONE XLA program (single
        device dispatch per solve).

        Requires ``jax_enable_x64``.  For an f64 hierarchy this just
        forwards to :meth:`solve`.

        Returns ``x`` (f64), or ``(x, info)`` with
        ``info = {"rounds": r, "inner_iterations": k}`` when
        ``return_info`` is set.
        """
        if not jax.config.jax_enable_x64:
            raise ValueError("solve_mp needs jax_enable_x64 for the f64 "
                             "outer residual; enable it or use solve()")
        op_dt = jnp.dtype(self.levels[0].A.dtype)
        if op_dt in (jnp.dtype(jnp.float64), jnp.dtype(jnp.complex128)):
            res = []
            x = self.solve(b, tol=tol, accel=accel, cycle=cycle,
                           maxiter=inner_maxiter * max_rounds,
                           residuals=res)
            if return_info:
                return x, {"rounds": 1,
                           "inner_iterations": max(len(res) - 1, 0)}
            return x

        if self._A64_dev is None:
            from .sparse.device_op import device_operator

            lvl0 = self.levels[0]
            A_csr = getattr(lvl0, "A_csr", None)
            if A_csr is None:
                A_csr = lvl0.A.to_scipy()
            self._A64_dev = device_operator(A_csr, dtype=jnp.float64)
        A64 = self._A64_dev

        if method == "pcg":
            return self._solve_mp_pcg(A64, b, tol, accel, cycle,
                                      int(inner_maxiter) * int(max_rounds),
                                      return_info)
        if method != "defect":
            raise ValueError(f"unknown solve_mp method {method!r}")

        # each refinement round is its own device dispatch (bounded: a
        # round is one inner Krylov solve, bounded by inner_maxiter; very
        # slow hierarchies should lower inner_maxiter rather than rely on a
        # single multi-round program)
        key = ("mp_round", accel, cycle, int(inner_maxiter),
               float(inner_tol_factor))
        if key not in self._solve_cache:
            run_inner = self._raw_accel(accel, cycle, int(inner_maxiter))
            ifac = float(inner_tol_factor)

            @jax.jit
            def one_round(hier, A64, b64, x64):
                f32 = hier["As"][0].dtype
                r64 = b64 - A64.matvec(x64)
                nr = jnp.linalg.norm(r64)
                r32 = r64.astype(f32)
                tol_t = (ifac * nr).astype(jnp.real(r32).dtype)
                dx32, it, res_buf = run_inner(
                    hier, jnp.zeros_like(r32), r32, tol_t)
                x64 = x64 + dx32.astype(b64.dtype)
                nr_est = jnp.abs(res_buf[it]).astype(jnp.float64)
                return x64, jnp.stack([nr_est, it.astype(jnp.float64)])

            self._solve_cache[key] = one_round
        one_round = self._solve_cache[key]

        dt64 = jnp.complex128 if np.iscomplexobj(np.zeros(0, op_dt)) \
            else jnp.float64
        b_host = np.ravel(np.asarray(b))
        b64 = jnp.asarray(b_host, dtype=dt64)
        # host norm: np.asarray(b64) here would copy the whole vector back
        # to the host (a sync) before the solve starts
        normb = float(np.linalg.norm(
            b_host.astype(np.dtype(str(jnp.dtype(dt64))), copy=False)))
        tol_abs = tol * (normb if normb != 0 else 1.0)
        hier = self._dev()
        x64 = jnp.zeros_like(b64)
        rounds, iters = 0, 0
        while rounds < int(max_rounds):
            x64, stat = one_round(hier, A64, b64, x64)
            stat = np.asarray(stat)          # small D2H per round
            rounds += 1
            iters += int(stat[1]) + 1
            if float(stat[0]) <= 0.5 * tol_abs:
                break
        if return_info:
            return x64, {"rounds": rounds, "inner_iterations": iters}
        return x64

    # -- public solve API -------------------------------------------------
    def aspreconditioner(self, cycle="V"):
        """Return a LinearOperator applying one cycle from x=0
        (reference multilevel.py:274-314).

        The operator is dual-natured: scipy solvers get the usual
        numpy-in/numpy-out matvec, while a traced jax array (e.g. inside
        one of this package's compiled Krylov cores, where scipy's
        ``LinearOperator.matvec`` would call ``np.asanyarray`` on the
        tracer and fail) flows through the cycle function symbolically."""
        from scipy.sparse.linalg import LinearOperator

        fn = self.cycle_fn(cycle)
        shape = self.levels[0].A.shape
        op_dtype = self.levels[0].A.dtype
        dtype = np.dtype(str(op_dtype))

        class _CyclePreconditioner(LinearOperator):
            def _matvec(self, b):
                b_d = jnp.asarray(np.ravel(np.asarray(b)), dtype=op_dtype)
                return np.asarray(fn(jnp.zeros_like(b_d), b_d))

            def matvec(self, b):
                if isinstance(b, jax.Array):      # tracers included
                    b_d = b.reshape(-1).astype(op_dtype)
                    return fn(jnp.zeros_like(b_d), b_d)
                return super().matvec(b)

        return _CyclePreconditioner(dtype=dtype, shape=shape)

    def psolve(self, b):
        return np.asarray(self.aspreconditioner().matvec(b))

    def solve(self, b, x0=None, tol=1e-5, maxiter=100, cycle="V",
              accel=None, callback=None, residuals=None,
              return_residuals=False, return_info=False):
        """Solve A x = b to relative residual ``tol``
        (reference multilevel.py:316-471).

        ``accel``: None for standalone cycling, or a Krylov method name
        ('cg', 'gmres', 'bicgstab', 'fgmres', ...) preconditioned by one
        cycle per iteration.
        """
        A = self.levels[0].A
        dtype = A.dtype

        def _to_dev(v):
            if isinstance(v, jnp.ndarray):
                return v.reshape(-1).astype(dtype)
            return jnp.asarray(np.ravel(np.asarray(v)), dtype=dtype)

        b_d = _to_dev(b)
        x = jnp.zeros_like(b_d) if x0 is None else _to_dev(x0)

        if maxiter is None:
            maxiter = 100

        if accel is not None:
            from . import krylov
            from .krylov._common import finalize

            # fused-and-cached path: one jitted program per
            # (accel, cycle, maxiter), reused across solves (tolerance is a
            # traced argument — no recompile when it changes)
            if isinstance(accel, str) \
                    and accel in ("cg", "bicgstab", "gmres", "fgmres",
                                  "cr", "steepest_descent",
                                  "minimal_residual") \
                    and callback is None:
                run = self._get_cached_accel(accel, cycle, int(maxiter))
                normb = jnp.linalg.norm(b_d)
                tol_t = tol * jnp.where(normb == 0, 1.0, normb)
                xk, it, res_buf = run(x, b_d, tol_t)
                if return_residuals and residuals is None:
                    residuals = []
                xk, info = finalize(xk, res_buf, int(it) + 1, float(tol_t),
                                    None, residuals)
                if return_residuals:
                    return xk, np.asarray(residuals)
                if return_info:
                    return xk, info
                return xk

            if callable(accel):
                kfn = accel
            else:
                kfn = getattr(krylov, accel)
            if isinstance(accel, str) and accel in ("cgnr", "cgne") \
                    and not hasattr(A, "rmatvec"):
                # normal-equation methods need A^H v: hermitian/symmetric-
                # real hierarchies reuse the device matvec; nonsymmetric
                # ones get a device conj-transpose operator (the cores are
                # fused while_loops — a host product would numpy-convert a
                # tracer and crash)
                sym = getattr(self.levels[0], "symmetry", "hermitian")
                if sym == "hermitian" or (sym == "symmetric"
                                          and not np.iscomplexobj(
                                              np.zeros(0, dtype=dtype))):
                    rmv = A.matvec
                else:
                    from .sparse import device_operator
                    AH = self.levels[0].A_csr.conjugate().T.tocsr()
                    rmv = device_operator(AH, dtype=dtype).matvec

                class _WithRmatvec:
                    def __init__(self, op, rmatvec):
                        self._op = op
                        self.matvec = op.matvec
                        self.rmatvec = rmatvec
                        self.shape = op.shape
                        self.dtype = op.dtype

                A = _WithRmatvec(A, rmv)
            cyc = self.cycle_fn(cycle)

            def M(r):
                return cyc(jnp.zeros_like(r), r)

            res_list = []
            xk, info = kfn(A, b_d, x0=x, tol=tol, maxiter=maxiter, M=M,
                           callback=callback, residuals=res_list)
            if residuals is not None:
                residuals.extend(res_list)
            xk = np.asarray(xk)
            if return_residuals:
                return xk, np.asarray(res_list)
            if return_info:
                return xk, info
            return xk

        fn = self.cycle_fn(cycle)
        normb = float(jnp.linalg.norm(b_d))
        if normb == 0.0:
            normb = 1.0
        tol_t = tol * normb

        if callback is not None:
            # host-paced loop (callback needs x each iteration)
            r = b_d - A.matvec(x)
            normr = float(jnp.linalg.norm(r))
            if residuals is not None:
                residuals.append(normr)
            it = 0
            while normr > tol_t and it < maxiter:
                x = fn(x, b_d)
                r = b_d - A.matvec(x)
                normr = float(jnp.linalg.norm(r))
                it += 1
                if residuals is not None:
                    residuals.append(normr)
                callback(np.asarray(x))
            x_np = np.asarray(x)
            n_res = it + 1
            res_np = np.asarray(residuals if residuals is not None else [])
        else:
            # fused-and-cached device loop: zero host round-trips per cycle
            run = self._get_cached_standalone(cycle, int(maxiter))
            rdt = jnp.real(jnp.zeros(0, b_d.dtype)).dtype
            x, it, res_buf = run(x, b_d, jnp.asarray(tol_t, dtype=rdt))
            it = int(it)
            res_np = np.asarray(res_buf)[:it + 1]
            if residuals is not None:
                residuals.extend([float(v) for v in res_np])
            x_np = np.asarray(x)

        final = res_np[-1] if len(res_np) else np.inf
        if return_residuals:
            return x_np, res_np
        if return_info:
            return x_np, (0 if final <= tol_t else it)
        return x_np


# reference-compatible lowercase aliases
multilevel_solver = MultilevelSolver


class MultilevelSolverSet:
    """Additive/multiplicative combination of several hierarchies —
    the fork's ``multilevel_solver_set`` (reference multilevel.py:723-925)."""

    def __init__(self, solvers: List[MultilevelSolver], mode="multiplicative"):
        if not solvers:
            raise ValueError("need at least one solver")
        self.solvers = list(solvers)
        self.mode = mode

    def add_hierarchy(self, solver):
        self.solvers.append(solver)

    def remove_hierarchy(self, index):
        del self.solvers[index]

    def replace_hierarchy(self, solver, index):
        self.solvers[index] = solver

    def aspreconditioner(self, cycle="V"):
        from scipy.sparse.linalg import LinearOperator

        shape = self.solvers[0].levels[0].A.shape
        dtype = np.dtype(str(self.solvers[0].levels[0].A.dtype))
        fns = [s.cycle_fn(cycle) for s in self.solvers]
        A = self.solvers[0].levels[0].A

        def matvec(b):
            b_d = jnp.asarray(np.ravel(b))
            if self.mode == "additive":
                x = sum(fn(jnp.zeros_like(b_d), b_d) for fn in fns)
            else:
                x = jnp.zeros_like(b_d)
                for fn in fns:
                    r = b_d - A.matvec(x)
                    x = x + fn(jnp.zeros_like(r), r)
            return np.asarray(x)

        return LinearOperator(shape, matvec, dtype=dtype)

    def solve(self, b, x0=None, tol=1e-5, maxiter=100, cycle="V",
              accel="cg", residuals=None):
        from . import krylov

        A = self.solvers[0].levels[0].A
        b_d = jnp.asarray(np.ravel(np.asarray(b)), dtype=A.dtype)
        x = (jnp.zeros_like(b_d) if x0 is None
             else jnp.asarray(np.ravel(np.asarray(x0)), dtype=A.dtype))
        fns = [s.cycle_fn(cycle) for s in self.solvers]

        def M(r):
            if self.mode == "additive":
                return sum(fn(jnp.zeros_like(r), r) for fn in fns)
            y = jnp.zeros_like(r)
            for fn in fns:
                rr = r - A.matvec(y)
                y = y + fn(jnp.zeros_like(rr), rr)
            return y

        kfn = getattr(krylov, accel) if isinstance(accel, str) else accel
        res_list = []
        xk, info = kfn(A, b_d, x0=x, tol=tol, maxiter=maxiter, M=M,
                       residuals=res_list)
        if residuals is not None:
            residuals.extend(res_list)
        return np.asarray(xk)


multilevel_solver_set = MultilevelSolverSet
