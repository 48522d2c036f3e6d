"""Boundary-condition types and configuration (counterpart of
`cfd_tpu/boundary/types.py`).

* The enums keep the reference's integer values (`types.py:28-57`), so a
  configuration carries across by value.
* The configuration structs are frozen dataclasses with the reference's
  fields, defaults and constructors.
* A ``custom`` / ``time_custom`` callable takes and returns tensors: a
  profile ``fn(position)`` gets a tensor of normalised edge coordinates in
  [0, 1] and returns (u, v); a time profile ``fn(t, dt)`` gets 0-d
  tensors.  Inside a step ``t`` is a device tensor, so a modulator never
  reads a value on the host.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Optional

import torch


class BCType(enum.IntEnum):
    """Mirrors bc_type_t (`boundary_conditions.h:19-27`)."""

    PERIODIC = 0
    NEUMANN = 1
    DIRICHLET = 2
    NOSLIP = 3
    INLET = 4
    OUTLET = 5
    SYMMETRY = 6


class Edge(enum.IntFlag):
    """Mirrors the bc_edge_t bitmask (`boundary_conditions.h:96-103`)."""

    LEFT = 0x01    # x = 0
    RIGHT = 0x02   # x = Lx
    BOTTOM = 0x04  # y = 0
    TOP = 0x08     # y = Ly
    FRONT = 0x10   # z = Lz (plane nz-1, 3D only)
    BACK = 0x20    # z = 0  (plane 0, 3D only)

    ALL_2D = LEFT | RIGHT | BOTTOM | TOP
    ALL_3D = LEFT | RIGHT | BOTTOM | TOP | FRONT | BACK


def edge_is_single(edge: Edge) -> bool:
    return int(edge) in (0x01, 0x02, 0x04, 0x08, 0x10, 0x20)


@dataclasses.dataclass(frozen=True)
class DirichletValues:
    """Fixed per-face values (mirrors bc_dirichlet_values_t)."""

    left: float = 0.0
    right: float = 0.0
    top: float = 0.0
    bottom: float = 0.0
    front: float = 0.0
    back: float = 0.0


class InletProfile(enum.IntEnum):
    UNIFORM = 0
    PARABOLIC = 1
    CUSTOM = 2


class InletSpecType(enum.IntEnum):
    VELOCITY = 0
    MAGNITUDE_DIR = 1
    MASS_FLOW = 2


class OutletType(enum.IntEnum):
    ZERO_GRADIENT = 0
    CONVECTIVE = 1


class TimeProfile(enum.IntEnum):
    CONSTANT = 0
    SINUSOIDAL = 1
    RAMP = 2
    STEP = 3
    CUSTOM = 4


def _as_tensor(t):
    return t if torch.is_tensor(t) else torch.tensor(float(t),
                                                     dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    """Time modulation of an inlet (mirrors bc_time_config_t).
    ``custom_fn(t, dt)`` takes and returns tensors."""

    profile: TimeProfile = TimeProfile.CONSTANT
    # sinusoidal: offset + amplitude*sin(2*pi*frequency*t + phase)
    frequency: float = 0.0
    amplitude: float = 0.0
    phase: float = 0.0
    offset: float = 0.0
    # ramp
    t_start: float = 0.0
    t_end: float = 0.0
    value_start: float = 0.0
    value_end: float = 0.0
    # step
    t_step: float = 0.0
    value_before: float = 0.0
    value_after: float = 0.0
    custom_fn: Optional[Callable] = None

    def modulator(self, t, dt):
        """The modulation factor at time ``t`` (`types.py:120-141`,
        bc_time_get_modulator): a Python float for the constant profiles,
        else a 0-d tensor on ``t``'s device (a float ``t`` is taken as a
        float64 CPU tensor)."""
        if self.profile == TimeProfile.CONSTANT:
            return 1.0
        if self.profile == TimeProfile.SINUSOIDAL:
            return self.offset + self.amplitude * torch.sin(
                2.0 * math.pi * self.frequency * _as_tensor(t) + self.phase)
        if self.profile == TimeProfile.RAMP:
            if self.t_end <= self.t_start:  # invalid config guard
                return self.value_end
            frac = torch.clamp((_as_tensor(t) - self.t_start)
                               / (self.t_end - self.t_start), 0.0, 1.0)
            return self.value_start + frac * (self.value_end
                                              - self.value_start)
        if self.profile == TimeProfile.STEP:
            t = _as_tensor(t)
            return torch.where(t < self.t_step,
                               torch.full_like(t, self.value_before),
                               torch.full_like(t, self.value_after))
        if self.profile == TimeProfile.CUSTOM and self.custom_fn is not None:
            return self.custom_fn(t, dt)
        return 1.0


@dataclasses.dataclass(frozen=True)
class InletConfig:
    """Inlet specification (mirrors bc_inlet_config_t).
    ``custom_profile(position) -> (u, v)`` and
    ``custom_profile_time(position, time, dt) -> (u, v)`` take a tensor of
    positions in [0, 1]."""

    edge: Edge = Edge.LEFT
    profile: InletProfile = InletProfile.UNIFORM
    spec_type: InletSpecType = InletSpecType.VELOCITY
    # VELOCITY spec
    u: float = 0.0
    v: float = 0.0
    # MAGNITUDE_DIR spec
    magnitude: float = 0.0
    direction: float = 0.0
    # MASS_FLOW spec
    mass_flow_rate: float = 0.0
    density: float = 0.0
    inlet_length: float = 0.0
    custom_profile: Optional[Callable] = None
    time_config: TimeConfig = TimeConfig()
    custom_profile_time: Optional[Callable] = None

    # ---- the constructors of bc_inlet_config_* (`types.py:170-240`)

    @classmethod
    def uniform(cls, u: float, v: float, edge: Edge = Edge.LEFT):
        return cls(edge=edge, profile=InletProfile.UNIFORM,
                   spec_type=InletSpecType.VELOCITY, u=u, v=v)

    @classmethod
    def parabolic(cls, max_velocity: float, edge: Edge = Edge.LEFT):
        """Parabolic profile 4·s(1−s) of the edge-normal velocity: u on
        the left and right edges, v on the bottom and top."""
        if edge in (Edge.BOTTOM, Edge.TOP):
            return cls(edge=edge, profile=InletProfile.PARABOLIC,
                       spec_type=InletSpecType.VELOCITY, u=0.0,
                       v=max_velocity)
        return cls(edge=edge, profile=InletProfile.PARABOLIC,
                   spec_type=InletSpecType.VELOCITY, u=max_velocity, v=0.0)

    @classmethod
    def magnitude_dir(cls, magnitude: float, direction: float,
                      edge: Edge = Edge.LEFT):
        return cls(edge=edge, spec_type=InletSpecType.MAGNITUDE_DIR,
                   magnitude=magnitude, direction=direction)

    @classmethod
    def mass_flow(cls, mass_flow_rate: float, density: float,
                  inlet_length: float, edge: Edge = Edge.LEFT):
        return cls(edge=edge, spec_type=InletSpecType.MASS_FLOW,
                   mass_flow_rate=mass_flow_rate, density=density,
                   inlet_length=inlet_length)

    @classmethod
    def custom(cls, fn: Callable, edge: Edge = Edge.LEFT):
        return cls(edge=edge, profile=InletProfile.CUSTOM, custom_profile=fn)

    @classmethod
    def time_sinusoidal(cls, u, v, frequency, amplitude, phase, offset,
                        edge: Edge = Edge.LEFT):
        return cls(edge=edge, spec_type=InletSpecType.VELOCITY, u=u, v=v,
                   time_config=TimeConfig(TimeProfile.SINUSOIDAL,
                                          frequency=frequency,
                                          amplitude=amplitude, phase=phase,
                                          offset=offset))

    @classmethod
    def time_ramp(cls, u, v, t_start, t_end, value_start, value_end,
                  edge: Edge = Edge.LEFT):
        return cls(edge=edge, spec_type=InletSpecType.VELOCITY, u=u, v=v,
                   time_config=TimeConfig(TimeProfile.RAMP, t_start=t_start,
                                          t_end=t_end,
                                          value_start=value_start,
                                          value_end=value_end))

    @classmethod
    def time_step(cls, u, v, t_step, value_before, value_after,
                  edge: Edge = Edge.LEFT):
        return cls(edge=edge, spec_type=InletSpecType.VELOCITY, u=u, v=v,
                   time_config=TimeConfig(TimeProfile.STEP, t_step=t_step,
                                          value_before=value_before,
                                          value_after=value_after))

    @classmethod
    def time_custom(cls, fn: Callable, edge: Edge = Edge.LEFT):
        return cls(edge=edge, custom_profile_time=fn)

    def with_edge(self, edge: Edge) -> "InletConfig":
        return dataclasses.replace(self, edge=edge)

    def with_time_sinusoidal(self, frequency, amplitude, phase, offset):
        return dataclasses.replace(self, time_config=TimeConfig(
            TimeProfile.SINUSOIDAL, frequency=frequency, amplitude=amplitude,
            phase=phase, offset=offset))


@dataclasses.dataclass(frozen=True)
class OutletConfig:
    """Outlet specification (mirrors bc_outlet_config_t).  Both types
    apply zero gradient, as the reference's C library does; the discrete
    convective update runs only with ``true_convective=True``."""

    edge: Edge = Edge.RIGHT
    type: OutletType = OutletType.ZERO_GRADIENT
    advection_velocity: float = 0.0
    true_convective: bool = False

    @classmethod
    def zero_gradient(cls, edge: Edge = Edge.RIGHT):
        return cls(edge=edge, type=OutletType.ZERO_GRADIENT)

    @classmethod
    def convective(cls, advection_velocity: float, edge: Edge = Edge.RIGHT,
                   true_convective: bool = False):
        return cls(edge=edge, type=OutletType.CONVECTIVE,
                   advection_velocity=advection_velocity,
                   true_convective=true_convective)

    def with_edge(self, edge: Edge) -> "OutletConfig":
        return dataclasses.replace(self, edge=edge)


@dataclasses.dataclass(frozen=True)
class SymmetryConfig:
    """Symmetry planes (mirrors bc_symmetry_config_t)."""

    edges: Edge = Edge(0)


@dataclasses.dataclass(frozen=True)
class ThermalBCConfig:
    """Per-face thermal BCs (mirrors ns_thermal_bc_config_t); the default
    is all PERIODIC."""

    left: BCType = BCType.PERIODIC
    right: BCType = BCType.PERIODIC
    bottom: BCType = BCType.PERIODIC
    top: BCType = BCType.PERIODIC
    front: BCType = BCType.PERIODIC
    back: BCType = BCType.PERIODIC
    dirichlet_values: DirichletValues = DirichletValues()

    def face_types(self):
        return (self.left, self.right, self.bottom, self.top,
                self.front, self.back)


def _face_spec(bc, value, periodic, neumann):
    bc = BCType(bc)
    if bc == BCType.DIRICHLET:
        return float(value)
    if bc == BCType.NEUMANN:
        return neumann
    return periodic


def thermal_z_specs(config: ThermalBCConfig,
                    periodic=("periodic", "periodic"),
                    neumann=("neumann", "neumann")):
    """(low, high) z-face specs of the back / front thermal BCs: the
    value of a DIRICHLET face, the given per-face token of a NEUMANN or
    PERIODIC one (`types.py:299-322`)."""
    v = config.dirichlet_values
    return (_face_spec(config.back, v.back, periodic[0], neumann[0]),
            _face_spec(config.front, v.front, periodic[1], neumann[1]))


def thermal_y_specs(config: ThermalBCConfig,
                    periodic=("periodic", "periodic"),
                    neumann=("neumann", "neumann")):
    """(low, high) y-face specs of the bottom / top thermal BCs, the
    y-row twin of :func:`thermal_z_specs` (`types.py:325-342`)."""
    v = config.dirichlet_values
    return (_face_spec(config.bottom, v.bottom, periodic[0], neumann[0]),
            _face_spec(config.top, v.top, periodic[1], neumann[1]))
