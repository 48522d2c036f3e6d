"""Flow field state (counterpart of `cfd_tpu/core/field.py`).

Six ``(nz, ny, nx)`` tensors (u, v, w, p, rho, T) in a frozen dataclass,
the JAX layout with x last; a 2D field is one plane (nz == 1).  ``w`` is
always allocated, in 2D too.  The constructors put the field on the card
unless the caller passes ``device`` (`config.resolve_device`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from .grid import Grid

# Initial condition constants (`solver_explicit_euler.c:30-44`).
INIT_U_BASE = 1.0
INIT_U_VAR = 0.1
INIT_V_VAR = 0.05
INIT_PRESSURE = 1.0
INIT_DENSITY = 1.0
INIT_TEMP = 300.0

PERTURB_CENTER_X = 1.0
PERTURB_CENTER_Y = 0.5
PERTURB_RADIUS = 0.2
PERTURB_WIDTH_SQ = 0.02
PERTURB_MAG = 0.1
PERTURB_GRAD_FACTOR = 2.0

FIELD_NAMES = ("u", "v", "w", "p", "rho", "T")


@dataclasses.dataclass(frozen=True)
class FlowField:
    """Velocity (u, v, w), pressure p, density rho and temperature T."""

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor
    rho: torch.Tensor
    T: torch.Tensor

    @property
    def shape(self):
        return tuple(self.u.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.u.dtype

    @property
    def device(self) -> torch.device:
        return self.u.device

    def replace(self, **kwargs) -> "FlowField":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def quiescent(cls, nx: int, ny: int, nz: int = 1, dtype=None,
                  device=None, pressure: float = INIT_PRESSURE,
                  density: float = INIT_DENSITY,
                  temperature: float = INIT_TEMP) -> "FlowField":
        """Zero velocity with physical rest-state scalars (the lid
        cavity's start), on the card unless ``device`` says otherwise."""
        device = resolve_device(device)
        dt = resolve_dtype(dtype, device)
        shape = (nz, ny, nx)

        def full(value):
            return torch.full(shape, value, dtype=dt, device=device)

        return cls(u=full(0.0), v=full(0.0), w=full(0.0), p=full(pressure),
                   rho=full(density), T=full(temperature))

    @classmethod
    def initialize(cls, grid: Grid, dtype=None, device=None) -> "FlowField":
        """Default initial condition (`solver_explicit_euler.c:124-160`):
        u = 1 + 0.1 sin(πy), v = 0.05 sin(2πx), w = 0, p = 1, rho = 1,
        T = 300, plus a Gaussian pressure bump at (1, 0.5) with a matched
        velocity perturbation inside radius 0.2.  Built in float64 on the
        host, as the reference does, then cast once, on the card unless
        ``device`` says otherwise."""
        device = resolve_device(device)
        dt = resolve_dtype(dtype, device)
        nz, ny, nx = grid.shape
        X = np.broadcast_to(np.asarray(grid.x)[None, None, :], (nz, ny, nx))
        Y = np.broadcast_to(np.asarray(grid.y)[None, :, None], (nz, ny, nx))

        u = INIT_U_BASE + INIT_U_VAR * np.sin(np.pi * Y)
        v = INIT_V_VAR * np.sin(2.0 * np.pi * X)
        p = np.full((nz, ny, nx), INIT_PRESSURE)

        cx, cy = PERTURB_CENTER_X, PERTURB_CENTER_Y
        r = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2)
        bump = PERTURB_MAG * np.exp(-r * r / PERTURB_WIDTH_SQ)
        inside = r < PERTURB_RADIUS
        dp_dx = -PERTURB_MAG * PERTURB_GRAD_FACTOR * (X - cx) \
            / PERTURB_WIDTH_SQ * np.exp(-r * r / PERTURB_WIDTH_SQ)
        dp_dy = -PERTURB_MAG * PERTURB_GRAD_FACTOR * (Y - cy) \
            / PERTURB_WIDTH_SQ * np.exp(-r * r / PERTURB_WIDTH_SQ)

        p = np.where(inside, p + bump, p)
        u = np.where(inside, u - PERTURB_MAG * dp_dx, u)
        v = np.where(inside, v - PERTURB_MAG * dp_dy, v)

        def dev(a):
            return torch.as_tensor(a, dtype=dt, device=device)

        shape = (nz, ny, nx)
        return cls(u=dev(u), v=dev(v),
                   w=torch.zeros(shape, dtype=dt, device=device),
                   p=dev(p),
                   rho=torch.full(shape, INIT_DENSITY, dtype=dt,
                                  device=device),
                   T=torch.full(shape, INIT_TEMP, dtype=dt, device=device))

    def is_finite(self) -> torch.Tensor:
        """0-d bool tensor: all of u, v, w, p finite (no host sync)."""
        ok = torch.isfinite(self.u).all() & torch.isfinite(self.v).all()
        return ok & torch.isfinite(self.w).all() & torch.isfinite(self.p).all()

    def select(self, keep: torch.Tensor, other: "FlowField") -> "FlowField":
        """``self`` where the 0-d bool ``keep`` is True, else ``other``
        (a ``torch.where`` on the device, no host read)."""
        k = keep.to(self.device)
        return FlowField(*(torch.where(k, getattr(self, n), getattr(other, n))
                           for n in FIELD_NAMES))

    def diagnostics(self):
        """(max |velocity|, max p, max T) as 0-d tensors, for stats."""
        m2 = torch.amax(self.u * self.u + self.v * self.v + self.w * self.w)
        return torch.sqrt(m2), torch.amax(self.p), torch.amax(self.T)
