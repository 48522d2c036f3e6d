"""Shared helpers for the NS time integrators (counterpart of
`cfd_tpu/solvers/ns/common.py`, restricted to what the projection step
reads)."""

from __future__ import annotations

import torch

from ...core.field import FlowField
from ...core.grid import Grid
from ...core.status import CFDError, Status


def validate_grid_for_solver(grid: Grid, field_shape) -> None:
    """Dimension checks shared by all integrators
    (`solver_explicit_euler.c:338-353`)."""
    nz, ny, nx = field_shape
    if nx < 3 or ny < 3 or (nz > 1 and nz < 3):
        raise CFDError(Status.ERROR_INVALID,
                       "solver requires >= 3 points per active axis")
    if grid.nz > 1 and not grid.is_uniform("z", rtol=1e-14):
        raise CFDError(Status.ERROR_INVALID,
                       "non-uniform z-spacing not supported")


def z_constants(grid: Grid):
    """Branch-free z constants (inv_2dz, inv_dz2); zeros in 2D."""
    if grid.nz > 1:
        return 1.0 / (2.0 * grid.dz0), 1.0 / (grid.dz0 * grid.dz0)
    return 0.0, 0.0


def clamp(v: torch.Tensor, limit: float) -> torch.Tensor:
    """Clip to ±limit; NaN passes through (as ``jnp.clip``)."""
    return torch.clamp(v, -limit, limit)


def field_status_and_diagnostics(field: FlowField):
    """(finite, vmax, pmax, tmax) as 0-d tensors: finiteness of u, v, w
    follows from max(u²+v²+w²) being finite (NaN propagates through the
    max) and of p from max|p|."""
    m2 = torch.amax(field.u ** 2 + field.v ** 2 + field.w ** 2)
    pabs = torch.amax(torch.abs(field.p))
    pmax = torch.amax(field.p)
    tmax = torch.amax(field.T)
    finite = torch.isfinite(m2) & torch.isfinite(pabs)
    return finite, torch.sqrt(m2), pmax, tmax
