"""The Poisson solvers (counterpart of `cfd_tpu/solvers/poisson/`): every
``Method`` through the front end, and the cached ``poisson_solve`` API,
exported here as the reference exports them."""

from .base import (Method, PoissonParams, PoissonProblem, PoissonResult,
                   PoissonStats, PoissonStatus, Precond)
from .frontend import (DEFAULT_PRESET, PoissonSolver, SolverPreset,
                       clear_cache, create_solver, poisson_solve,
                       poisson_solve_3d)

__all__ = [
    "Method", "PoissonParams", "PoissonProblem", "PoissonResult",
    "PoissonStats", "PoissonStatus", "Precond", "DEFAULT_PRESET",
    "PoissonSolver", "SolverPreset", "clear_cache", "create_solver",
    "poisson_solve", "poisson_solve_3d",
]
