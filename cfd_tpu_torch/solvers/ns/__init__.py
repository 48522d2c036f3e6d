"""Navier-Stokes integrators (counterpart of `cfd_tpu/solvers/ns/`).

Import the step factory from its module,
``cfd_tpu_torch.solvers.ns.projection.make_projection_step``.
"""

from .params import NSParams, StepResult

__all__ = ["NSParams", "StepResult"]
