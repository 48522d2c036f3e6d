"""Navier-Stokes parameters and per-step results (counterpart of
`cfd_tpu/solvers/ns/params.py`).

``NSParams`` keeps the reference's fields and defaults one for one, so a
parameter set carries across with ``NSParams.from_fields`` (the thermal
BC configuration converted to the port's own, `interop.thermal_bc_from`).
``StepResult`` holds 0-d tensors on the field's device: reading one is the
caller's choice of when to synchronise; ``NSStats`` is the host-side
record the ``NSSolver`` facade reads from it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ...boundary.types import ThermalBCConfig
from ...core.status import Status

DEFAULT_TIME_STEP = 0.001
DEFAULT_CFL_NUMBER = 0.2
DEFAULT_GAMMA = 1.4
DEFAULT_VISCOSITY = 0.01
DEFAULT_THERMAL_CONDUCTIVITY = 0.0242
DEFAULT_MAX_ITERATIONS = 100
DEFAULT_TOLERANCE = 1e-6
DEFAULT_SOURCE_AMPLITUDE_U = 0.1
DEFAULT_SOURCE_AMPLITUDE_V = 0.05
DEFAULT_SOURCE_DECAY_RATE = 0.1
DEFAULT_PRESSURE_COUPLING = 0.1

# Stability limits of the explicit integrators
# (`solver_explicit_euler.c:24-55`).
MAX_DERIVATIVE_LIMIT = 100.0
MAX_SECOND_DERIVATIVE_LIMIT = 1000.0
MAX_VELOCITY_LIMIT = 100.0
MAX_DIVERGENCE_LIMIT = 10.0
UPDATE_LIMIT = 1.0
DT_MAX_LIMIT = 0.01
DT_MIN_LIMIT = 1e-6
DT_CONSERVATIVE_LIMIT = 1e-4
VELOCITY_EPSILON = 1e-20
SPEED_EPSILON = 1e-10

# Projection velocity clamp (`solver_projection.c:40`).
PROJ_MAX_VELOCITY = 100.0


@dataclasses.dataclass(frozen=True)
class NSParams:
    """Mirrors the reference's ``NSParams`` (same fields, same defaults):
    ``thermal_bc`` defaults to the port's all-PERIODIC ``ThermalBCConfig()``
    as the reference's does (`params.py:81`); ``alpha > 0`` turns the energy
    equation on and ``beta != 0`` the Boussinesq buoyancy."""

    dt: float = DEFAULT_TIME_STEP
    cfl: float = DEFAULT_CFL_NUMBER
    gamma: float = DEFAULT_GAMMA
    mu: float = DEFAULT_VISCOSITY
    k: float = DEFAULT_THERMAL_CONDUCTIVITY
    max_iter: int = DEFAULT_MAX_ITERATIONS
    tolerance: float = DEFAULT_TOLERANCE
    source_amplitude_u: float = DEFAULT_SOURCE_AMPLITUDE_U
    source_amplitude_v: float = DEFAULT_SOURCE_AMPLITUDE_V
    source_decay_rate: float = DEFAULT_SOURCE_DECAY_RATE
    pressure_coupling: float = DEFAULT_PRESSURE_COUPLING
    source_func: Optional[Callable] = None
    alpha: float = 0.0
    beta: float = 0.0
    T_ref: float = 0.0
    gravity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    heat_source_func: Optional[Callable] = None
    thermal_bc: ThermalBCConfig = ThermalBCConfig()
    nonuniform_scheme: str = "parity"

    def __post_init__(self):
        if self.nonuniform_scheme not in ("parity", "consistent"):
            raise ValueError(
                f"nonuniform_scheme must be 'parity' or 'consistent', "
                f"got {self.nonuniform_scheme!r}")

    def replace(self, **kw) -> "NSParams":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_fields(cls, other) -> "NSParams":
        """Copy every field of the same name from ``other`` (e.g. the
        reference package's NSParams); its ``thermal_bc`` is converted to
        the port's ``ThermalBCConfig`` by enum value and field name."""
        from ...interop import thermal_bc_from
        kw = {f.name: getattr(other, f.name) for f in dataclasses.fields(cls)}
        kw["thermal_bc"] = thermal_bc_from(kw["thermal_bc"])
        return cls(**kw)

    @property
    def energy_enabled(self) -> bool:
        return _enabled(self.alpha, lambda a: a > 0.0)

    @property
    def buoyancy_enabled(self) -> bool:
        return _enabled(self.beta, lambda b: b != 0.0)

    def requires_grad(self) -> bool:
        """Some field is a tensor that requires grad (the
        differentiable-params pattern: a design gradient w.r.t. μ, α, β)."""
        return any(torch.is_tensor(getattr(self, f.name))
                   and getattr(self, f.name).requires_grad
                   for f in dataclasses.fields(self))


def _enabled(value, test) -> bool:
    """``test(value)``; True for a tensor: a tensor-valued physics
    parameter keeps its term whatever its value, as the reference's
    ``static_bool(default=True)`` keeps a traced one (`energy.py:31-45`),
    so a gradient flows through it."""
    return True if torch.is_tensor(value) else bool(test(value))


def param_value(value):
    """A physics parameter for the plain versions: a tensor as it is (its
    gradient flows), anything else as a Python float."""
    return value if torch.is_tensor(value) else float(value)


def source_amplitudes(params: NSParams, t):
    """The default source's decayed amplitudes (su, sv) at time ``t`` (a
    0-d tensor): amplitude · exp(−rate·t), the scalars the explicit
    kernels multiply by sin(πy) and sin(2πx) (`params.py:144-151`, in
    the fused kernels' order)."""
    decay = torch.exp(-params.source_decay_rate * t)
    return params.source_amplitude_u * decay, \
        params.source_amplitude_v * decay


@dataclasses.dataclass
class NSStats:
    """Mirrors ns_solver_stats_t (`navier_stokes_solver.h:198-207`)."""

    iterations: int = 0
    residual: float = 0.0
    max_velocity: float = 0.0
    max_pressure: float = 0.0
    max_temperature: float = 0.0
    cfl_number: float = 0.0
    elapsed_time_ms: float = 0.0
    status: Status = Status.SUCCESS


@dataclasses.dataclass(frozen=True)
class StepResult:
    """Per-step diagnostics as 0-d device tensors."""

    iterations: torch.Tensor     # int32: steps applied
    status: torch.Tensor         # int32 Status code (0, −6, −7)
    residual: torch.Tensor
    max_velocity: torch.Tensor
    max_pressure: torch.Tensor
    max_temperature: torch.Tensor

    @property
    def diverged(self) -> torch.Tensor:
        return self.status == int(Status.ERROR_DIVERGED)
