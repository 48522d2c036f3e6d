"""The Poisson solvers (counterpart of `cfd_tpu/solvers/poisson/`): every
``Method`` through the front end, the cached ``poisson_solve`` API and
the adjoint (reverse-differentiable) solve ``make_adjoint_poisson``,
exported here as the reference exports them."""

from .adjoint import make_adjoint_poisson
from .base import (Method, PoissonParams, PoissonProblem, PoissonResult,
                   PoissonStats, PoissonStatus, Precond)
from .frontend import (DEFAULT_PRESET, PoissonSolver, SolverPreset,
                       clear_cache, create_solver, poisson_solve,
                       poisson_solve_3d)

__all__ = [
    "Method", "PoissonParams", "PoissonProblem", "PoissonResult",
    "PoissonStats", "PoissonStatus", "Precond", "DEFAULT_PRESET",
    "PoissonSolver", "SolverPreset", "clear_cache", "create_solver",
    "make_adjoint_poisson", "poisson_solve", "poisson_solve_3d",
]
