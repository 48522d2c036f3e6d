"""Boundary conditions (counterpart of `cfd_tpu/boundary/`)."""

from .types import (BCType, DirichletValues, Edge, InletConfig, InletProfile,
                    InletSpecType, OutletConfig, OutletType, SymmetryConfig,
                    ThermalBCConfig, TimeConfig, TimeProfile)
from .handlers import (BCBackend, BCErrorCode, get_backend,
                       get_backend_name, get_error_handler, set_backend,
                       set_error_handler)
from .apply import (apply_dirichlet_scalar, apply_dirichlet_velocity,
                    apply_inlet, apply_neumann_scalar, apply_noslip,
                    apply_outlet_scalar, apply_outlet_velocity,
                    apply_periodic_field, apply_periodic_scalar, apply_scalar,
                    apply_symmetry, apply_velocity, copy_boundary_velocities)

__all__ = [
    "BCType", "DirichletValues", "Edge", "InletConfig", "InletProfile",
    "InletSpecType", "OutletConfig", "OutletType", "SymmetryConfig",
    "ThermalBCConfig", "TimeConfig", "TimeProfile",
    "apply_dirichlet_scalar", "apply_dirichlet_velocity", "apply_inlet",
    "apply_neumann_scalar", "apply_noslip", "apply_outlet_scalar",
    "apply_outlet_velocity", "apply_periodic_field", "apply_periodic_scalar",
    "apply_scalar", "apply_symmetry", "apply_velocity",
    "copy_boundary_velocities",
    "BCBackend", "BCErrorCode", "get_backend", "get_backend_name",
    "get_error_handler", "set_backend", "set_error_handler",
]
