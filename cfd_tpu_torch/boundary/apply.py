"""Boundary conditions on (nz, ny, nx) tensors (counterpart of
`cfd_tpu/boundary/apply.py`).

Each function returns new tensors and leaves its arguments as they were,
as the reference's functional updates do.  Faces are written in the
reference's order — x-faces, then y-faces, then z-faces (3D only) — so the
last writer owns each corner, as there.  A plain (ny, nx) tensor is taken
as one plane.  z-faces are touched only when nz > 1, as the reference's
``if (nz > 1)`` guards.

Time-dependent inlets take ``time`` as a float or a 0-d tensor; inside a
step it is a device tensor, and nothing here reads it on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core.status import CFDError, Status
from .types import (BCType, DirichletValues, Edge, InletConfig, InletProfile,
                    InletSpecType, OutletConfig, OutletType, SymmetryConfig,
                    edge_is_single)


def _planes(f: torch.Tensor) -> torch.Tensor:
    out = f.clone()
    return out[None] if out.dim() == 2 else out


# ---- scalar fields: PERIODIC / NEUMANN / DIRICHLET -------------------------

def apply_neumann_scalar(f: torch.Tensor) -> torch.Tensor:
    """Zero gradient: each boundary face takes the adjacent interior
    values."""
    g = _planes(f)
    g[:, :, 0] = g[:, :, 1]
    g[:, :, -1] = g[:, :, -2]
    g[:, 0, :] = g[:, 1, :]
    g[:, -1, :] = g[:, -2, :]
    if g.shape[0] > 1:
        g[0] = g[1]
        g[-1] = g[-2]
    return g.view_as(f)


def apply_dirichlet_scalar(f: torch.Tensor,
                           values: DirichletValues = DirichletValues()):
    """Fixed value on each boundary face."""
    g = _planes(f)
    g[:, :, 0] = values.left
    g[:, :, -1] = values.right
    g[:, 0, :] = values.bottom
    g[:, -1, :] = values.top
    if g.shape[0] > 1:
        g[0] = values.back
        g[-1] = values.front
    return g.view_as(f)


def apply_periodic_scalar(f: torch.Tensor) -> torch.Tensor:
    """Wrap-around: each boundary face takes the opposite interior values
    (face 0 ← n − 2, face n − 1 ← 1), x then y then z, so a corner ends as
    the value at the opposite interior corner (`core_impl.h:92-120`)."""
    g = _planes(f)
    g[:, :, 0] = g[:, :, -2]
    g[:, :, -1] = g[:, :, 1]
    g[:, 0, :] = g[:, -2, :]
    g[:, -1, :] = g[:, 1, :]
    if g.shape[0] > 1:
        g[0] = g[-2]
        g[-1] = g[1]
    return g.view_as(f)


def apply_scalar(f, bc_type: BCType,
                 values: Optional[DirichletValues] = None):
    """Dispatcher mirroring bc_apply_scalar[_3d] (`apply.py:89-100`)."""
    bc_type = BCType(bc_type)
    if bc_type == BCType.PERIODIC:
        return apply_periodic_scalar(f)
    if bc_type == BCType.NEUMANN:
        return apply_neumann_scalar(f)
    if bc_type == BCType.DIRICHLET:
        return apply_dirichlet_scalar(f, values or DirichletValues())
    raise CFDError(Status.ERROR_INVALID,
                   f"bc_apply_scalar: unsupported type {bc_type.name}")


# ---- velocity BCs -------------------------------------------------------------

def _three_d(u) -> bool:
    return u.dim() == 3 and u.shape[0] > 1


def apply_noslip(u, v, w=None):
    """u = v = (w =) 0 on every boundary face."""
    zero = DirichletValues()
    u, v = apply_dirichlet_scalar(u, zero), apply_dirichlet_scalar(v, zero)
    if w is not None and _three_d(u):
        w = apply_dirichlet_scalar(w, zero)
    return (u, v) if w is None else (u, v, w)


def apply_dirichlet_velocity(u, v, u_values: DirichletValues,
                             v_values: DirichletValues, w=None,
                             w_values: Optional[DirichletValues] = None):
    u = apply_dirichlet_scalar(u, u_values)
    v = apply_dirichlet_scalar(v, v_values)
    if w is not None and _three_d(u):
        w = apply_dirichlet_scalar(w, w_values or DirichletValues())
    return (u, v) if w is None else (u, v, w)


def apply_velocity(u, v, bc_type: BCType, w=None):
    """Componentwise periodic or Neumann, or no-slip (mirrors
    bc_apply_velocity)."""
    bc_type = BCType(bc_type)
    if bc_type == BCType.NOSLIP:
        return apply_noslip(u, v, w)
    if bc_type in (BCType.PERIODIC, BCType.NEUMANN):
        u, v = apply_scalar(u, bc_type), apply_scalar(v, bc_type)
        if w is not None and _three_d(u):
            w = apply_scalar(w, bc_type)
        return (u, v) if w is None else (u, v, w)
    raise CFDError(Status.ERROR_INVALID,
                   f"bc_apply_velocity: unsupported type {bc_type.name}")


# ---- inlets (profiles and time modulation) --------------------------------

def _inlet_base_velocity(cfg: InletConfig) -> Tuple[float, float, float]:
    """Base (u, v, w) from the spec (`apply.py:135-155`)."""
    if cfg.spec_type == InletSpecType.VELOCITY:
        return cfg.u, cfg.v, 0.0
    if cfg.spec_type == InletSpecType.MAGNITUDE_DIR:
        return (cfg.magnitude * math.cos(cfg.direction),
                cfg.magnitude * math.sin(cfg.direction), 0.0)
    if cfg.spec_type == InletSpecType.MASS_FLOW:
        rho_l = cfg.density * cfg.inlet_length
        if rho_l <= 0.0:
            return 0.0, 0.0, 0.0
        avg = cfg.mass_flow_rate / rho_l
        signs = {Edge.LEFT: (1, 0, 0), Edge.RIGHT: (-1, 0, 0),
                 Edge.BOTTOM: (0, 1, 0), Edge.TOP: (0, -1, 0),
                 Edge.FRONT: (0, 0, -1), Edge.BACK: (0, 0, 1)}
        su, sv, sw = signs[cfg.edge]
        return avg * su, avg * sv, avg * sw
    return 0.0, 0.0, 0.0


def _inlet_profile_velocity(cfg: InletConfig, position, time=None,
                            dt=None):
    """(u, v) along the edge after the spatial profile; ``position`` the
    normalised coordinates in [0, 1] (`apply.py:158-175`)."""
    ub, vb, _ = _inlet_base_velocity(cfg)
    if cfg.custom_profile_time is not None and time is not None:
        return cfg.custom_profile_time(position, time, dt)
    if cfg.profile == InletProfile.PARABOLIC:
        factor = 4.0 * position * (1.0 - position)
        return ub * factor, vb * factor
    if cfg.profile == InletProfile.CUSTOM and cfg.custom_profile is not None:
        return cfg.custom_profile(position)
    ones = torch.ones_like(position)
    return ub * ones, vb * ones


def apply_inlet(u, v, cfg: InletConfig, w=None, time=None, dt=None):
    """Set the inlet velocity on the configured edge (bc_apply_inlet and
    bc_apply_inlet_time, `apply.py:178-259`).  With ``time=None`` the
    modulation factor is 1.  In 3D an x- or y-edge inlet sets w = 0 on
    the edge; a z-face inlet is uniform over the plane, evaluated at
    position 0.5."""
    if not edge_is_single(cfg.edge):
        raise CFDError(Status.ERROR_INVALID, "inlet edge must be a single edge")
    squeeze = u.dim() == 2
    if squeeze:
        u, v = u[None], v[None]
        w = None if w is None else w[None]
    nz, ny, nx = u.shape
    mod = 1.0
    if time is not None and cfg.custom_profile_time is None:
        mod = cfg.time_config.modulator(time, dt if dt is not None else 0.0)
    u, v = u.clone(), v.clone()
    w = None if w is None else w.clone()

    if cfg.edge in (Edge.FRONT, Edge.BACK):
        if nz <= 1 or w is None:
            raise CFDError(Status.ERROR_INVALID,
                           "z-face inlet requires a 3D field with w")
        pos = torch.full((), 0.5, dtype=u.dtype, device=u.device)
        uv, vv = _inlet_profile_velocity(cfg, pos, time, dt)
        _, _, wb = _inlet_base_velocity(cfg)
        k = nz - 1 if cfg.edge == Edge.FRONT else 0
        u[k] = uv * mod
        v[k] = vv * mod
        w[k] = wb * mod
    else:
        along_y = cfg.edge in (Edge.LEFT, Edge.RIGHT)
        count = ny if along_y else nx
        if count > 1:
            pos = torch.arange(count, dtype=u.dtype,
                               device=u.device) / (count - 1)
        else:
            pos = torch.full((count,), 0.5, dtype=u.dtype, device=u.device)
        uv, vv = _inlet_profile_velocity(cfg, pos, time, dt)
        uv, vv = uv * mod, vv * mod
        index = {Edge.LEFT: (slice(None), slice(None), 0),
                 Edge.RIGHT: (slice(None), slice(None), -1),
                 Edge.BOTTOM: (slice(None), 0, slice(None)),
                 Edge.TOP: (slice(None), -1, slice(None))}[cfg.edge]
        u[index] = uv[None, :]
        v[index] = vv[None, :]
        if w is not None and nz > 1:
            w[index] = 0.0
    if squeeze:
        u, v = u[0], v[0]
        w = None if w is None else w[0]
    return (u, v) if w is None else (u, v, w)


# ---- outlets ------------------------------------------------------------------

_OUTLET_FACES = {
    Edge.LEFT: ((slice(None), slice(None), 0), (slice(None), slice(None), 1)),
    Edge.RIGHT: ((slice(None), slice(None), -1),
                 (slice(None), slice(None), -2)),
    Edge.BOTTOM: ((slice(None), 0, slice(None)),
                  (slice(None), 1, slice(None))),
    Edge.TOP: ((slice(None), -1, slice(None)),
               (slice(None), -2, slice(None))),
    Edge.BACK: ((0, slice(None), slice(None)), (1, slice(None), slice(None))),
    Edge.FRONT: ((-1, slice(None), slice(None)),
                 (-2, slice(None), slice(None))),
}


def apply_outlet_scalar(f, cfg: OutletConfig, dt=None, dn=None):
    """Outlet on one edge: zero gradient for both outlet types, as the
    reference (`apply.py:262-284`); with ``cfg.true_convective`` and dt /
    dn given, the discrete convective update f_b ← f_b − U·dt/dn ·
    (f_b − f_i)."""
    if not edge_is_single(cfg.edge):
        raise CFDError(Status.ERROR_INVALID,
                       "outlet edge must be a single edge")
    g = _planes(f)
    if cfg.edge in (Edge.FRONT, Edge.BACK) and g.shape[0] <= 1:
        raise CFDError(Status.ERROR_INVALID,
                       "z-face outlet requires 3D field")
    dst, src = _OUTLET_FACES[cfg.edge]
    if (cfg.type == OutletType.CONVECTIVE and cfg.true_convective
            and dt is not None and dn is not None):
        c = cfg.advection_velocity * dt / dn
        g[dst] = g[dst] - c * (g[dst] - g[src])
    else:
        g[dst] = g[src]
    return g.view_as(f)


def apply_outlet_velocity(u, v, cfg: OutletConfig, w=None, dt=None,
                          dn=None):
    u = apply_outlet_scalar(u, cfg, dt, dn)
    v = apply_outlet_scalar(v, cfg, dt, dn)
    if w is not None and _three_d(u):
        w = apply_outlet_scalar(w, cfg, dt, dn)
    return (u, v) if w is None else (u, v, w)


# ---- symmetry -------------------------------------------------------------------

def apply_symmetry(u, v, cfg: SymmetryConfig, w=None):
    """Zero normal velocity and zero tangential gradient on each selected
    edge (`apply.py:296-330`)."""
    squeeze = u.dim() == 2
    u, v = _planes(u), _planes(v)
    w = None if w is None else _planes(w)
    nz = u.shape[0]
    wz = w is not None and nz > 1
    edges = cfg.edges
    if edges & Edge.LEFT:
        u[:, :, 0] = 0.0
        v[:, :, 0] = v[:, :, 1]
        if wz:
            w[:, :, 0] = w[:, :, 1]
    if edges & Edge.RIGHT:
        u[:, :, -1] = 0.0
        v[:, :, -1] = v[:, :, -2]
        if wz:
            w[:, :, -1] = w[:, :, -2]
    if edges & Edge.BOTTOM:
        v[:, 0, :] = 0.0
        u[:, 0, :] = u[:, 1, :]
        if wz:
            w[:, 0, :] = w[:, 1, :]
    if edges & Edge.TOP:
        v[:, -1, :] = 0.0
        u[:, -1, :] = u[:, -2, :]
        if wz:
            w[:, -1, :] = w[:, -2, :]
    if nz > 1:
        if edges & Edge.BACK:
            if w is not None:
                w[0] = 0.0
            u[0] = u[1]
            v[0] = v[1]
        if edges & Edge.FRONT:
            if w is not None:
                w[-1] = 0.0
            u[-1] = u[-2]
            v[-1] = v[-2]
    if squeeze:
        u, v = u[0], v[0]
        w = None if w is None else w[0]
    return (u, v) if w is None else (u, v, w)


# ---- whole fields --------------------------------------------------------------

def apply_periodic_field(field):
    """Periodic wrap of all six flow variables (the NS solvers' default,
    `solver_explicit_euler.c:231-314`)."""
    return dataclasses.replace(field, **{
        n: apply_periodic_scalar(getattr(field, n))
        for n in ("u", "v", "w", "p", "rho", "T")})


def _shell_mask(shape, device):
    """The boundary shell: x/y edges of every plane, and the whole z-faces
    when nz > 1."""
    nz, ny, nx = shape
    mask = torch.zeros(shape, dtype=torch.bool, device=device)
    mask[:, :, 0] = mask[:, :, -1] = True
    mask[:, 0, :] = mask[:, -1, :] = True
    if nz > 1:
        mask[0] = mask[-1] = True
    return mask


def copy_boundary_velocities(dst_u, dst_v, dst_w, src_u, src_v, src_w):
    """Copy the boundary shells of (u, v[, w]) from src into dst
    (copy_boundary_velocities_3d, `apply.py:371-388`): the x/y edges of u
    and v always, w's only in 3D, the z-faces only in 3D."""
    mask = _shell_mask(dst_u.shape, dst_u.device)
    dst_u = torch.where(mask, src_u, dst_u)
    dst_v = torch.where(mask, src_v, dst_v)
    if dst_u.shape[0] > 1:
        dst_w = torch.where(mask, src_w, dst_w)
    return dst_u, dst_v, dst_w
