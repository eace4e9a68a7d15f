"""pyamg_tpu — an accelerator-native algebraic multigrid framework.

A ground-up JAX/XLA re-design of the capabilities of PyAMG
(reference: rsmedleystevenson/pyamg): multigrid hierarchies over padded-ELL
sparse operators, jit-compiled V/W/F/AMLI cycles, a fused Krylov suite, and
host-staged setup with parallel-friendly coarsening algorithms.

Reference parity: pyamg/__init__.py:61-65 top-level API.
"""

from . import (gallery, util, relaxation, classical, aggregation, krylov,
               graph, vis, parallel, complexity, amg_core, sparse, strength)
from .multilevel import (MultilevelSolver, multilevel_solver,
                         coarse_grid_solver, MultilevelSolverSet,
                         multilevel_solver_set)
from .classical import ruge_stuben_solver
from .aggregation import (smoothed_aggregation_solver, rootnode_solver,
                          adaptive_sa_solver)
from .blackbox import solve, solver, solver_configuration
from .complexity import cycle_complexity, setup_complexity
from .strength import (classical_strength_of_connection,
                       symmetric_strength_of_connection,
                       evolution_strength_of_connection)
from .sparse import SparseELL, BlockELL

__version__ = "0.1.0"

__all__ = [
    "gallery", "util", "relaxation", "classical", "aggregation", "krylov",
    "graph", "vis", "parallel", "complexity", "amg_core", "sparse",
    "strength",
    "MultilevelSolver", "multilevel_solver", "coarse_grid_solver",
    "MultilevelSolverSet", "multilevel_solver_set", "ruge_stuben_solver",
    "smoothed_aggregation_solver", "rootnode_solver", "adaptive_sa_solver",
    "solve", "solver", "solver_configuration",
    "cycle_complexity", "setup_complexity",
    "classical_strength_of_connection", "symmetric_strength_of_connection",
    "evolution_strength_of_connection", "SparseELL", "BlockELL",
    "__version__",
]


def test(*args, **kwargs):
    """Run the test suite (requires pytest)."""
    import subprocess
    import sys
    import os

    root = os.path.join(os.path.dirname(__file__), "..", "tests")
    return subprocess.call([sys.executable, "-m", "pytest", root, "-q"])
