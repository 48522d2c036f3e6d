"""Shared helpers for the NS time integrators (counterpart of
`cfd_tpu/solvers/ns/common.py`)."""

from __future__ import annotations

import numpy as np
import torch

from ...config import device_of, resolve_dtype
from ...core.field import FlowField
from ...core.grid import Grid
from ...core.status import CFDError, Status
from ...ops.kernels.stretch import stretch_spacing_ok, triples
from ...ops.stencils import weighted
from ..energy import thermal_dt_limit  # noqa: F401  (re-exported)
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


def spacing_arrays(grid: Grid, dtype, device=None):
    """Per-point inverse spacings broadcastable over (nz, ny, nx)
    (`common.py:30-46`): entry i holds the forward spacing dx[i], the
    last entry repeating dx[−1] (only interior points are read); and the
    |h| ≥ 1e-10 validity mask.  Returns (1/2dx, 1/2dy, 1/dx², 1/dy², ok)."""
    dx = np.concatenate([grid.dx, grid.dx[-1:]])
    dy = np.concatenate([grid.dy, grid.dy[-1:]])

    def vec(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    ok = ((np.abs(dx)[None, None, :] >= 1e-10)
          & (np.abs(dy)[None, :, None] >= 1e-10))
    return (vec(1.0 / (2.0 * dx))[None, None, :],
            vec(1.0 / (2.0 * dy))[None, :, None],
            vec(1.0 / (dx * dx))[None, None, :],
            vec(1.0 / (dy * dy))[None, :, None],
            torch.as_tensor(ok, device=device))


def consistent_triples(spacing):
    """The exact 3-point nonuniform derivative weights (`common.py:49-71`),
    one sextuple of length-n float64 numpy arrays (wm, wc, wp, lm, lc, lp):
    at interior point i with h_m = x[i] − x[i−1], h_p = x[i+1] − x[i] and
    s = h_m + h_p,

      f'  ≈ wm·f[i−1] + wc·f[i] + wp·f[i+1],
            wm = −h_p/(h_m·s), wc = (h_p − h_m)/(h_m·h_p), wp = h_m/(h_p·s)
      f'' ≈ lm·f[i−1] + lc·f[i] + lp·f[i+1],
            lm = 2/(h_m·s),    lc = −2/(h_m·h_p),          lp = 2/(h_p·s)

    exact for quadratics on any grid.  Edge entries substitute the edge
    spacing for the missing gap (finite values only)."""
    return triples(spacing)


def spacing_operators(grid: Grid, dtype, scheme: str = "parity",
                      device=None):
    """(d1x, d1y, d2x, d2y, spacing_ok) (`common.py:74-131`): x/y
    derivative operators of the shifted views ``(f_minus, f_center,
    f_plus)``.  ``"parity"`` is the reference C library's forward-spacing
    stencil (`spacing_arrays`), ``"consistent"`` the exact nonuniform
    weights (`consistent_triples`); on a uniform grid both are the parity
    operators."""
    if scheme not in ("parity", "consistent"):
        raise CFDError(Status.ERROR_INVALID,
                       f"nonuniform_scheme must be 'parity' or "
                       f"'consistent', got {scheme!r}")
    inv_2dx, inv_2dy, inv_dx2, inv_dy2, ok = spacing_arrays(grid, dtype,
                                                            device)
    if scheme == "parity" or (grid.is_uniform("x") and grid.is_uniform("y")):
        def d1(c):
            return lambda fm, fc, fp: (fp - fm) * c

        def d2(c):
            return lambda fm, fc, fp: (fp - 2.0 * fc + fm) * c

        return d1(inv_2dx), d1(inv_2dy), d2(inv_dx2), d2(inv_dy2), ok

    def rows(spacing, shape):
        return [torch.as_tensor(a, dtype=dtype, device=device).reshape(shape)
                for a in consistent_triples(spacing)]

    X, Y = rows(grid.dx, (1, 1, -1)), rows(grid.dy, (1, -1, 1))

    def lin(w):
        return lambda fm, fc, fp: weighted(fm, fc, fp, w)

    return lin(X[:3]), lin(Y[:3]), lin(X[3:]), lin(Y[3:]), ok


def stretch_gate(grid: Grid, params: NSParams):
    """(stretch, reason) — the spacing gate of the explicit kernels
    (`common.py:141-162`).  ``stretch`` is the ``(dx, dy, x, y)`` numpy
    tuple the stretched kernels' weight vectors are built from
    (`ops.kernels.stretch`), None on uniform x/y; ``reason`` is None when
    the kernels may run, else why they may not: degenerate spacing, or the
    energy equation on a stretched grid under the parity scheme (its
    thermal stencils are invalid off uniform grids,
    `energy_solver.c:55-91`)."""
    if grid.is_uniform("x") and grid.is_uniform("y"):
        if min(grid.dx0, grid.dy0) > 1e-10:
            return None, None
        return None, "degenerate grid spacing (|h| <= 1e-10)"
    if params.energy_enabled and params.nonuniform_scheme != "consistent":
        return None, ("stretched x/y with the energy equation needs "
                      "nonuniform_scheme='consistent'")
    if not stretch_spacing_ok(grid.dx, grid.dy):
        return None, "stretched spacing below the 1e-10 validity guard"
    return (grid.dx, grid.dy, grid.x, grid.y), None


def stretch_pin_count(grid: Grid, params: NSParams) -> int:
    """The number of per-point coefficient planes the reference's fused
    kernels pin for this grid and scheme (`common.py:165-170`): 0 on
    uniform x/y, 7 consistent, 3 parity.  Here the rows of the x and y
    weight arrays (`ops.kernels.stretch`)."""
    if grid.is_uniform("x") and grid.is_uniform("y"):
        return 0
    return 7 if params.nonuniform_scheme == "consistent" else 3


def stretch_mode(grid: Grid, params: NSParams):
    """(stretch, fuse_ok) — :func:`stretch_gate` for dispatchers."""
    stretch, reason = stretch_gate(grid, params)
    return stretch, reason is None


def z_constants(grid: Grid):
    """Branch-free z constants (inv_2dz, inv_dz2); zeros in 2D."""
    if grid.nz > 1:
        return 1.0 / (2.0 * grid.dz0), 1.0 / (grid.dz0 * grid.dz0)
    return 0.0, 0.0


def runs_plain(dtype, plain: bool = False) -> bool:
    """A step runs its kernels' plain versions: when asked (``plain=True``)
    or for any dtype but float32.  This is the reference's own dispatch:
    it gates only its kernels on float32 and runs its jnp body otherwise
    (`projection.py:256-292`, `euler.py:75-96`), so a float64 step on the
    card is the plain step, on the card — the kernels are float32 by
    design, and no kernel is tried first."""
    return plain or dtype != torch.float32


def kernel_step(dtype, device, plain: bool = False) -> bool:
    """The step built for ``(dtype, device, plain)`` launches kernels: a
    CUDA device and not :func:`runs_plain`."""
    dev = device_of(device)
    return dev.type == "cuda" and not runs_plain(resolve_dtype(dtype, dev),
                                                 plain)


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


def iterate_with_divergence_guard(step_once, field, dt, max_iter: int):
    """Run ``max_iter`` steps, freezing the state once a step fails
    (`common.py:232-254`, the reference's early return on DIVERGED as a
    scan).  A Python loop whose freeze is a ``torch.where`` on the device:
    it never reads a value on the host, so the steps queue back to back.
    ``field`` is a `FlowField` or a `parallel.mesh.ShardedField`: the loop
    reads only their ``select`` and ``diagnostics``, so the single-device
    and the mesh solver share it, as in the reference.  Returns (field,
    StepResult) with the number of steps applied."""
    dev = field.device
    status = torch.zeros((), dtype=torch.int32, device=dev)
    applied = torch.zeros((), dtype=torch.int32, device=dev)
    res = torch.zeros((), dtype=field.dtype, device=dev)
    for it in range(max_iter):
        new_field, step_res = step_once(field, dt, it)
        keep_new = status == 0
        field = new_field.select(keep_new, field)
        status = torch.where(keep_new, step_res.status.to(dev), status)
        applied = applied + keep_new.to(torch.int32)
        res = torch.where(keep_new, step_res.residual.to(dev), res)
    vmax, pmax, tmax = field.diagnostics()
    return field, StepResult(iterations=applied, status=status,
                             residual=res, max_velocity=vmax,
                             max_pressure=pmax, max_temperature=tmax)
