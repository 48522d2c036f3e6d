"""Boundary conditions (counterpart of `cfd_tpu/boundary/`)."""

from .apply import (apply_dirichlet_scalar, apply_neumann_scalar,
                    apply_periodic_field, apply_periodic_scalar)
from .types import DirichletValues

__all__ = ["DirichletValues", "apply_dirichlet_scalar",
           "apply_neumann_scalar", "apply_periodic_field",
           "apply_periodic_scalar"]
