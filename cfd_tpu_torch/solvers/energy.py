"""Energy equation: explicit temperature advection-diffusion, Boussinesq
buoyancy and thermal boundary conditions (counterpart of
`cfd_tpu/solvers/energy.py`).

* :func:`make_energy_step` — T ← T + dt·(−u·∇T + α∇²T) on the interior,
  skipped when α ≤ 0 (`energy_solver.c:37-39`);
* :func:`compute_buoyancy` — the momentum sources −β(T − T_ref)·g
  (`energy_solver.c:185-196`);
* :func:`apply_thermal_bcs` — the per-face PERIODIC / NEUMANN / DIRICHLET
  thermal BCs in the reference's order (left, right, bottom, top, back,
  front; the face applied last owns a corner, `energy_solver.c:246-331`);
* :func:`thermal_dt_limit` — the thermal diffusion bound on dt.

They are plain PyTorch: the reference runs them in jnp outside any Pallas
kernel in the projection step (`projection.py:624-630`, `:702-708`); the
explicit integrators fuse the same arithmetic into their kernels
(`ops.kernels.euler_kernels`, `rk_kernels`).  A heat source
(``heat_source``, a callable Q) is not ported yet and raises
``CFDError(ERROR_UNSUPPORTED)``.  A stretched x/y grid needs
``scheme="consistent"`` (the exact nonuniform weights), as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..boundary.types import BCType, ThermalBCConfig
from ..core.grid import Grid
from ..core.status import CFDError, Status
from ..ops.kernels.stretch import triples as consistent_triples
from ..ops.stencils import (along_x, along_y, ddx, ddy, ddz, interior,
                            laplacian, laplacian_interior, set_interior)

SUPPORTED_FACES = (BCType.PERIODIC, BCType.NEUMANN, BCType.DIRICHLET)


def validate_energy_grid(grid: Grid, scheme: str = "parity") -> None:
    """The uniform-spacing requirement (`energy_solver.c:55-91`), which
    ``scheme="consistent"`` lifts for x and y (`energy.py:48-64`)."""
    if grid.nx < 3 or grid.ny < 3:
        raise CFDError(Status.ERROR_INVALID, "energy_solver: grid too small")
    if scheme != "consistent" and (not grid.is_uniform("x")
                                   or not grid.is_uniform("y")):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "energy_solver: non-uniform dx/dy not supported "
                       "(opt into NSParams(nonuniform_scheme='consistent'))")
    if grid.nz > 1 and not grid.is_uniform("z"):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "energy_solver: non-uniform dz not supported")


def validate_thermal_bc(config: ThermalBCConfig, grid: Grid) -> None:
    """Reject unsupported face types and too-small grids
    (`energy_solver.c:221-244`)."""
    faces = [config.left, config.right, config.bottom, config.top]
    if grid.nz > 1:
        faces += [config.front, config.back]
    for f in faces:
        if BCType(f) not in SUPPORTED_FACES:
            raise CFDError(
                Status.ERROR_INVALID,
                "thermal BC: only PERIODIC, NEUMANN, DIRICHLET are valid")
    if ((config.left == BCType.PERIODIC or config.right == BCType.PERIODIC)
            and grid.nx < 3):
        raise CFDError(Status.ERROR_INVALID, "grid too small for periodic x")
    if ((config.bottom == BCType.PERIODIC or config.top == BCType.PERIODIC)
            and grid.ny < 3):
        raise CFDError(Status.ERROR_INVALID, "grid too small for periodic y")
    if grid.nz > 1 and (config.back == BCType.PERIODIC
                        or config.front == BCType.PERIODIC) and grid.nz < 3:
        raise CFDError(Status.ERROR_INVALID, "grid too small for periodic z")


def make_energy_step(grid: Grid, alpha: float, heat_source=None,
                     scheme: str = "parity"):
    """``step(T, u, v, w, dt, time) -> T``, or None when the energy
    equation is off (α ≤ 0).  The interior takes
    T + dt·(−(u·T_x + v·T_y + w·T_z) + α∇²T), the shell keeps T.  On a
    stretched x/y grid (``scheme="consistent"``) the x/y derivatives take
    the exact nonuniform weights, unclamped, in the reference's order
    (`energy.py:106-139`): T_x = (T[i−1]·wm + T·wc) + T[i+1]·wp and ∇²T
    one chain of the six x/y terms, then the z term."""
    if not alpha > 0.0:
        return None
    if heat_source is not None:
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "energy_solver: a heat_source callable is not ported "
                       "yet")
    validate_energy_grid(grid, scheme)
    inv_2dx, inv_2dy = 1.0 / (2.0 * grid.dx0), 1.0 / (2.0 * grid.dy0)
    inv_dx2, inv_dy2 = 1.0 / grid.dx0 ** 2, 1.0 / grid.dy0 ** 2
    inv_2dz = 1.0 / (2.0 * grid.dz0) if grid.nz > 1 else 0.0
    inv_dz2 = grid.inv_dz2 if grid.nz > 1 else 0.0
    if not (grid.is_uniform("x") and grid.is_uniform("y")):
        return _consistent_energy_step(grid, alpha, inv_2dz, inv_dz2)

    def step(T, u, v, w, dt, time=None):
        advection = ((interior(u) * ddx(T, inv_2dx)
                      + interior(v) * ddy(T, inv_2dy))
                     + interior(w) * ddz(T, inv_2dz))
        diffusion = alpha * laplacian(T, inv_dx2, inv_dy2, inv_dz2)
        return set_interior(T, interior(T) + dt * (-advection + diffusion))

    return step


def thermal_weight_rows(grid: Grid):
    """``rows(T) -> (X, Y)``: the consistent energy step's interior weight
    rows, the six x rows (wm, wc, wp, lm, lc, lp) broadcasting over
    (…, nx − 2) and the six y rows over (…, ny − 2, 1), in T's dtype on
    T's device, made once per (dtype, device)."""
    triples = [a[1:-1] for a in consistent_triples(grid.dx)], \
        [a[1:-1] for a in consistent_triples(grid.dy)]
    cache = {}

    def rows(T):
        key = (T.dtype, T.device)
        if key not in cache:
            cache[key] = tuple(
                [torch.as_tensor(a, dtype=T.dtype, device=T.device)
                 .reshape(shape) for a in axis]
                for axis, shape in zip(triples, ((1, 1, -1), (1, -1, 1))))
        return cache[key]

    return rows


def _consistent_energy_step(grid: Grid, alpha, inv_2dz, inv_dz2):
    """The stretched-grid energy step (see :func:`make_energy_step`); the
    weight rows are made once per (dtype, device)."""
    rows = thermal_weight_rows(grid)

    def step(T, u, v, w, dt, time=None):
        X, Y = rows(T)
        advection = (interior(u) * along_x(T, X[:3])
                     + interior(v) * along_y(T, Y[:3]))
        if T.shape[0] > 1:
            advection = advection + interior(w) * ddz(T, inv_2dz)
        diffusion = laplacian_interior(T, X[3:], Y[3:], inv_dz2)
        return set_interior(T, interior(T)
                            + dt * (-advection + alpha * diffusion))

    return step


def buoyancy_coefficients(beta: float, gravity, T_ref: float, dtype):
    """((−β)·g[c] for c = x, y, z, T_ref), each rounded to ``dtype`` as the
    fused kernels round them (`(-dtype(beta) * dtype(gravity[c]))`,
    `projection_kernels.py:319-321`): the product in float32 for float32
    fields, in float64 otherwise.  Python floats, exact in ``dtype``; a
    tensor β or T_ref (the differentiable-params pattern) gives 0-d
    ``dtype`` tensors with the same rounding, through which its gradient
    flows."""
    if torch.is_tensor(beta) or torch.is_tensor(T_ref):
        nb = -torch.as_tensor(beta).to(dtype)
        return (tuple(nb * float(g) for g in gravity),
                torch.as_tensor(T_ref).to(dtype))
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    nb = -np_dt(beta)
    return (tuple(float(nb * np_dt(g)) for g in gravity),
            float(np_dt(T_ref)))


def compute_buoyancy(T, beta: float, T_ref: float, gravity):
    """The Boussinesq momentum sources (−β·(T − T_ref)·g[c]) for the
    three components, in the reference's order; (0, 0, 0) when β = 0 (a
    tensor β keeps the term, `NSParams.buoyancy_enabled`)."""
    if not torch.is_tensor(beta) and not beta != 0.0:
        return 0.0, 0.0, 0.0
    dT = T - T_ref
    return tuple(-beta * dT * g for g in gravity)


def apply_thermal_bcs(T: torch.Tensor, config: ThermalBCConfig):
    """The per-face thermal BCs in the reference's order (left, right,
    bottom, top, then back and front in 3D); a NEUMANN face copies its
    inner neighbour, a PERIODIC one the opposite interior line, a
    DIRICHLET one takes its value.  Returns a new tensor."""
    v = config.dirichlet_values
    T = T.clone()
    s = slice(None)
    faces = [(config.left, (s, s, 0), (s, s, 1), (s, s, -2), v.left),
             (config.right, (s, s, -1), (s, s, -2), (s, s, 1), v.right),
             (config.bottom, (s, 0, s), (s, 1, s), (s, -2, s), v.bottom),
             (config.top, (s, -1, s), (s, -2, s), (s, 1, s), v.top)]
    if T.shape[0] > 1:
        faces += [(config.back, (0, s, s), (1, s, s), (-2, s, s), v.back),
                  (config.front, (-1, s, s), (-2, s, s), (1, s, s),
                   v.front)]
    for bc, dst, src_neumann, src_periodic, value in faces:
        bc = BCType(bc)
        if bc == BCType.DIRICHLET:
            T[dst] = value
        elif bc == BCType.NEUMANN:
            T[dst] = T[src_neumann]
        elif bc == BCType.PERIODIC:
            T[dst] = T[src_periodic]
    return T


def thermal_dt_limit(alpha: float, dmin: float, ndim: int,
                     cfl: float) -> float:
    """Thermal diffusion stability bound dt < dmin²/(2·α·ndim)·cfl
    (`solver_explicit_euler.c:214-219`)."""
    if alpha <= 0.0:
        return float("inf")
    return (dmin * dmin) / (2.0 * alpha * ndim) * cfl
