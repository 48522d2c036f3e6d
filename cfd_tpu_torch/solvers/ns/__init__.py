"""Navier-Stokes integrators (counterpart of `cfd_tpu/solvers/ns/`).

Import the step factory from its module,
``cfd_tpu_torch.solvers.ns.projection.make_projection_step``; the
differentiable rollout ``make_rollout`` is exported here, as the
reference exports it.
"""

from .params import NSParams, StepResult
from .rollout import REMAT_POLICIES, make_rollout

__all__ = ["NSParams", "REMAT_POLICIES", "StepResult", "make_rollout"]
