"""Boundary conditions on (nz, ny, nx) tensors (counterpart of
`cfd_tpu/boundary/apply.py`, restricted to the lid cavity's scalar BCs
and the explicit integrators' periodic wrap).

Each function returns a new tensor and leaves its argument as it was, as
the reference's functional updates do.  Faces are written in the
reference's order — x-faces, then y-faces, then z-faces (3D only) — so the
last writer owns each corner, as there.  A plain (ny, nx) tensor is taken
as one plane.
"""

from __future__ import annotations

import dataclasses

import torch

from .types import DirichletValues


def _planes(f: torch.Tensor) -> torch.Tensor:
    out = f.clone()
    return out[None] if out.dim() == 2 else out


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


def apply_periodic_field(field):
    """Periodic wrap of all six flow variables (the NS solvers' default,
    `solver_explicit_euler.c:231-314`)."""
    return dataclasses.replace(field, **{
        n: apply_periodic_scalar(getattr(field, n))
        for n in ("u", "v", "w", "p", "rho", "T")})
