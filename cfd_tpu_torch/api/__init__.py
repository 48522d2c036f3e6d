"""The registry and the simulation facade (counterpart of
`cfd_tpu/api/`, without outputs)."""

from .registry import Backend, SolverRegistry, create_registry, infer_backend
from .simulation import Simulation, has_solver, list_solvers

__all__ = ["Backend", "SolverRegistry", "create_registry", "infer_backend",
           "Simulation", "has_solver", "list_solvers"]
