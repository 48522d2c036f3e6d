"""Shared helpers for the NS time integrators (counterpart of
`cfd_tpu/solvers/ns/common.py`, uniform grids only)."""

from __future__ import annotations

import numpy as np
import torch

from ...core.field import FlowField
from ...core.grid import Grid
from ...core.status import CFDError, Status
from .params import (DT_MAX_LIMIT, DT_MIN_LIMIT, SPEED_EPSILON,
                     VELOCITY_EPSILON, NSParams, StepResult)


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


def stretch_gate(grid: Grid):
    """None when the explicit kernels may run on ``grid`` (uniform x/y
    with spacing above the 1e-10 guard), else the reason they may not
    (`common.py:141-162`; the stretched pins are not ported yet).  On a
    uniform grid the reference's spacing operators (`common.py:74`) reduce
    to the scalar coefficients 1/(2h) and 1/h² that the explicit kernels
    take (`euler_kernels.ExplicitConsts.derivs`)."""
    if not (grid.is_uniform("x") and grid.is_uniform("y")):
        return "a stretched x/y grid"
    if min(grid.dx0, grid.dy0) <= 1e-10:
        return "degenerate grid spacing (|h| <= 1e-10)"
    return None


def z_constants(grid: Grid):
    """Branch-free z constants (inv_2dz, inv_dz2); zeros in 2D."""
    if grid.nz > 1:
        return 1.0 / (2.0 * grid.dz0), 1.0 / (grid.dz0 * grid.dz0)
    return 0.0, 0.0


def clamp(v: torch.Tensor, limit: float) -> torch.Tensor:
    """Clip to ±limit; NaN passes through (as ``jnp.clip``)."""
    return torch.clamp(v, -limit, limit)


def field_diagnostics(field: FlowField):
    """(max |velocity|, max p, max T) for stats."""
    m2 = torch.amax(field.u * field.u + field.v * field.v
                    + field.w * field.w)
    return torch.sqrt(m2), torch.amax(field.p), torch.amax(field.T)


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


def step_result(finite, vmax, pmax, tmax, residual=None,
                poisson_ok=None) -> StepResult:
    """StepResult of one step: one iteration; status 0, −6 (DIVERGED)
    when a field is not finite, else −7 (MAX_ITER) when the pressure solve
    did not converge (``poisson_ok`` False, `projection.py:651-653`);
    ``residual`` the solve's final residual (0 for a direct solve or a
    one-pass step)."""
    dev = vmax.device

    def code(s):
        return torch.full((), int(s), dtype=torch.int32, device=dev)

    ok = code(Status.SUCCESS)
    if poisson_ok is not None:
        ok = torch.where(poisson_ok, ok, code(Status.ERROR_MAX_ITER))
    status = torch.where(finite, ok, code(Status.ERROR_DIVERGED))
    if residual is None:
        residual = torch.zeros((), dtype=vmax.dtype, device=dev)
    return StepResult(
        iterations=torch.ones((), dtype=torch.int32, device=dev),
        status=status, residual=residual, max_velocity=vmax,
        max_pressure=pmax, max_temperature=tmax)


def source_basis(grid: Grid, dtype, device):
    """(sin(πy), sin(2πx)) as (ny,) and (nx,) tensors: the default
    source's shape (`params.py:144-151`), built once in float64 from the
    grid's coordinates and cast, and handed to a kernel and its plain
    version alike."""
    def vec(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (vec(np.sin(np.pi * np.asarray(grid.y))),
            vec(np.sin(2.0 * np.pi * np.asarray(grid.x))))


def thermal_dt_limit(alpha: float, dmin: float, ndim: int,
                     cfl: float) -> float:
    """Thermal diffusion bound dt < dmin²/(2·α·ndim)·cfl
    (`energy.py:200-205`, `solver_explicit_euler.c:214-219`)."""
    if alpha <= 0.0:
        return float("inf")
    return (dmin * dmin) / (2.0 * alpha * ndim) * cfl


def compute_dt(field: FlowField, grid: Grid, params: NSParams) -> float:
    """CFL-stable dt (`common.py:205-229`): clip(cfl·dmin / max(|u| + c),
    1e-6, 0.01) with sound speed c = sqrt(γp/ρ), the thermal bound when
    α > 0, and the speed floored at 1 on a quiescent field.  Reads one
    value from the device."""
    sound = torch.sqrt(params.gamma * field.p
                       / torch.clamp_min(field.rho, 1e-300))
    vel_sq = field.u * field.u + field.v * field.v + field.w * field.w
    vel = torch.where(vel_sq > VELOCITY_EPSILON, torch.sqrt(vel_sq),
                      torch.zeros_like(vel_sq))
    max_speed = float(torch.amax(vel + sound))
    if max_speed < SPEED_EPSILON:
        max_speed = 1.0
    dmin = min(float(np.min(grid.dx)), float(np.min(grid.dy)))
    if grid.nz > 1:
        dmin = min(dmin, float(np.min(grid.dz)))
    dt_cfl = params.cfl * dmin / max_speed
    ndim = 3 if grid.nz > 1 else 2
    dt_stable = min(dt_cfl, thermal_dt_limit(params.alpha, dmin, ndim,
                                             params.cfl))
    return max(DT_MIN_LIMIT, min(DT_MAX_LIMIT, dt_stable))


def iterate_with_divergence_guard(step_once, field: FlowField, dt,
                                  max_iter: int):
    """Run ``max_iter`` steps, freezing the state once a step fails
    (`common.py:232-254`, the reference's early return on DIVERGED as a
    scan).  A Python loop whose freeze is a ``torch.where`` on the device:
    it never reads a value on the host, so the steps queue back to back.
    Returns (field, StepResult) with the number of steps applied."""
    dev = field.device
    status = torch.zeros((), dtype=torch.int32, device=dev)
    applied = torch.zeros((), dtype=torch.int32, device=dev)
    res = torch.zeros((), dtype=field.dtype, device=dev)
    for it in range(max_iter):
        new_field, step_res = step_once(field, dt, it)
        keep_new = status == 0
        field = FlowField(*(torch.where(keep_new, getattr(new_field, n),
                                        getattr(field, n))
                            for n in ("u", "v", "w", "p", "rho", "T")))
        status = torch.where(keep_new, step_res.status, status)
        applied = applied + keep_new.to(torch.int32)
        res = torch.where(keep_new, step_res.residual, res)
    vmax, pmax, tmax = field_diagnostics(field)
    return field, StepResult(iterations=applied, status=status,
                             residual=res, max_velocity=vmax,
                             max_pressure=pmax, max_temperature=tmax)
