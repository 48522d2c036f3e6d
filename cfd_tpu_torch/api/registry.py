"""Solver registry: name → factory, with backend tags and availability
(counterpart of `cfd_tpu/api/registry.py`, `solver_registry.c`).

The same 18 names register: the reference's 16 and the two extensions
``projection_spectral`` and ``projection_multigrid``.  The backend is
inferred from the name's suffix; ``create_checked`` refuses a CUDA-tagged
name when no CUDA device is present.  Every name creates a solver; one
whose path is not ported (the CG ``projection`` family,
``projection_multigrid``) raises ``CFDError(ERROR_UNSUPPORTED)`` at
``init``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..core.features import Backend, backend_is_available
from ..core.status import Status, set_error
from ..solvers.ns.solver import Capability, NSSolver
from ..solvers.poisson.base import Method as PoissonMethod

# Standard built-in solver type names (`navier_stokes_solver.h:376-391`).
SOLVER_TYPE_EXPLICIT_EULER = "explicit_euler"
SOLVER_TYPE_EXPLICIT_EULER_OPTIMIZED = "explicit_euler_optimized"
SOLVER_TYPE_EXPLICIT_EULER_OMP = "explicit_euler_omp"
SOLVER_TYPE_EXPLICIT_EULER_GPU = "explicit_euler_gpu"
SOLVER_TYPE_PROJECTION = "projection"
SOLVER_TYPE_PROJECTION_OPTIMIZED = "projection_optimized"
SOLVER_TYPE_PROJECTION_OMP = "projection_omp"
SOLVER_TYPE_PROJECTION_GPU = "projection_gpu"
SOLVER_TYPE_RK2 = "rk2"
SOLVER_TYPE_RK2_OPTIMIZED = "rk2_optimized"
SOLVER_TYPE_RK2_OMP = "rk2_omp"
SOLVER_TYPE_RK2_GPU = "rk2_gpu"
SOLVER_TYPE_RK4 = "rk4"
SOLVER_TYPE_RK4_OPTIMIZED = "rk4_optimized"
SOLVER_TYPE_RK4_OMP = "rk4_omp"
SOLVER_TYPE_RK4_GPU = "rk4_gpu"
SOLVER_TYPE_PROJECTION_SPECTRAL = "projection_spectral"
SOLVER_TYPE_PROJECTION_MULTIGRID = "projection_multigrid"

_DEFAULT_NAMES = (
    SOLVER_TYPE_EXPLICIT_EULER, SOLVER_TYPE_EXPLICIT_EULER_OPTIMIZED,
    SOLVER_TYPE_EXPLICIT_EULER_OMP, SOLVER_TYPE_EXPLICIT_EULER_GPU,
    SOLVER_TYPE_PROJECTION, SOLVER_TYPE_PROJECTION_OPTIMIZED,
    SOLVER_TYPE_PROJECTION_OMP, SOLVER_TYPE_PROJECTION_GPU,
    SOLVER_TYPE_RK2, SOLVER_TYPE_RK2_OPTIMIZED, SOLVER_TYPE_RK2_OMP,
    SOLVER_TYPE_RK2_GPU,
    SOLVER_TYPE_RK4, SOLVER_TYPE_RK4_OPTIMIZED, SOLVER_TYPE_RK4_OMP,
    SOLVER_TYPE_RK4_GPU,
    SOLVER_TYPE_PROJECTION_SPECTRAL, SOLVER_TYPE_PROJECTION_MULTIGRID,
)

_DESCRIPTIONS = {
    "explicit_euler": "Explicit Euler time integration",
    "rk2": "RK2 (Heun) time integration, O(dt^2)",
    "rk4": "Classical RK4 time integration, O(dt^4)",
    "projection": "Chorin projection method (pressure Poisson)",
    "projection_spectral": ("Chorin projection with exact spectral (DST-I) "
                            "pressure solve — uniform grids"),
    "projection_multigrid": ("Chorin projection with multigrid pressure "
                             "solve — coarsenable grids, O(N) iterative"),
}


def infer_backend(name: str) -> Backend:
    """Backend from name suffix (`solver_registry.c:253-270`)."""
    if name.endswith("_gpu"):
        return Backend.CUDA
    if name.endswith("_omp"):
        return Backend.OMP
    if name.endswith("_optimized"):
        return Backend.SIMD
    return Backend.SCALAR


def _base_method(name: str) -> str:
    for suffix in ("_optimized", "_omp", "_gpu"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name


def _default_factory(name: str, device, dtype) -> Callable[[], NSSolver]:
    method = _base_method(name)
    backend = infer_backend(name)
    poisson_method = PoissonMethod.CG
    if name == SOLVER_TYPE_PROJECTION_SPECTRAL:
        method, poisson_method = "projection", PoissonMethod.FFT_DIRECT
    elif name == SOLVER_TYPE_PROJECTION_MULTIGRID:
        method, poisson_method = "projection", PoissonMethod.MULTIGRID

    def factory() -> NSSolver:
        caps = (Capability.INCOMPRESSIBLE | Capability.TRANSIENT
                | Capability.SIMD | Capability.PARALLEL)
        if backend == Backend.CUDA:
            caps |= Capability.GPU
        return NSSolver(name=name, method=method,
                        description=_DESCRIPTIONS.get(
                            _base_method(name), ""),
                        backend=backend, capabilities=caps,
                        poisson_method=poisson_method, device=device,
                        dtype=dtype)

    return factory


class SolverRegistry:
    """Per-simulation registry (context-bound, not global, as in the
    reference).  ``device`` and ``dtype`` are handed to every solver the
    default factories create (None: the card, float32)."""

    def __init__(self, device=None, dtype=None):
        self.device, self.dtype = device, dtype
        self._factories: Dict[str, Callable[[], NSSolver]] = {}

    def register_defaults(self) -> None:
        """Register the 18 built-in solvers (`solver_registry.c:213-249`
        plus the two extensions); GPU names are gated at
        ``create_checked``."""
        for name in _DEFAULT_NAMES:
            self.register(name, _default_factory(name, self.device,
                                                 self.dtype))

    def register(self, name: str, factory: Callable[[], NSSolver]) -> int:
        if not name or factory is None:
            return -1
        self._factories[name] = factory
        return 0

    def unregister(self, name: str) -> int:
        return 0 if self._factories.pop(name, None) is not None else -1

    def list(self) -> List[str]:
        return list(self._factories)

    def list_by_backend(self, backend: Backend) -> List[str]:
        return [n for n in self._factories if infer_backend(n) == backend]

    def has(self, name: str) -> bool:
        return name in self._factories

    def describe(self, name: str) -> Optional[str]:
        f = self._factories.get(name)
        return f().description if f else None

    def create(self, name: str) -> Optional[NSSolver]:
        """cfd_solver_create: None (with last-error set) for unknown names."""
        f = self._factories.get(name)
        if f is None:
            set_error(Status.ERROR_NOT_FOUND,
                      f"solver type '{name}' not registered")
            return None
        return f()

    def create_checked(self, name: str) -> Optional[NSSolver]:
        """cfd_solver_create_checked: also validates backend availability."""
        if name in self._factories and not backend_is_available(
                infer_backend(name)):
            set_error(Status.ERROR_UNSUPPORTED,
                      f"backend for '{name}' is not available")
            return None
        return self.create(name)


def create_registry(device=None, dtype=None) -> SolverRegistry:
    """cfd_registry_create + cfd_registry_register_defaults."""
    reg = SolverRegistry(device, dtype)
    reg.register_defaults()
    return reg
