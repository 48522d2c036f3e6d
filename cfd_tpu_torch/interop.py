"""Carry state between the two packages as numpy arrays.

A test holds the port against the reference by feeding both the same
numpy inputs: ``field_from_numpy({"u": ..., ...}, device, dtype)`` builds a
:class:`FlowField`, ``field_to_numpy(field)`` reads one back; ``thermal_bc_from(config)``
converts another package's thermal BC configuration to the port's, and
``grid_from(grid)`` another package's grid (stretched ones included).  A JAX array
should be converted with ``np.array`` (a copy), not ``np.asarray``: the
latter is a read-only view of the JAX buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from .boundary.types import BCType, DirichletValues, ThermalBCConfig
from .config import resolve_device, resolve_dtype
from .core.field import FIELD_NAMES, FlowField
from .core.grid import Grid


def field_from_numpy(arrays: dict, device=None, dtype=None) -> FlowField:
    """``arrays`` maps each of u, v, w, p, rho, T to an (nz, ny, nx)
    array; ``device`` defaults to the card."""
    device = resolve_device(device)
    dt = resolve_dtype(dtype, device)
    return FlowField(*(torch.tensor(np.array(arrays[n]), dtype=dt,
                                    device=device) for n in FIELD_NAMES))


def grid_from(grid) -> Grid:
    """The port's ``Grid`` with the sizes, bounds, coordinates and
    spacings of ``grid`` (e.g. the reference package's), copied as
    float64 numpy arrays, so both packages step on bit-identical grids;
    duck-typed, so nothing of that package is imported."""
    if isinstance(grid, Grid):
        return grid

    def arr(a):
        return None if a is None else np.array(a, dtype=np.float64)

    return Grid(int(grid.nx), int(grid.ny), int(grid.nz),
                *(float(getattr(grid, n)) for n in (
                    "xmin", "xmax", "ymin", "ymax", "zmin", "zmax")),
                arr(grid.x), arr(grid.y), arr(grid.dx), arr(grid.dy),
                arr(grid.z), arr(grid.dz), float(grid.inv_dz2))


def field_to_numpy(field: FlowField) -> dict:
    return {n: getattr(field, n).detach().cpu().numpy()
            for n in FIELD_NAMES}


def thermal_bc_from(config) -> ThermalBCConfig:
    """The port's ``ThermalBCConfig`` with the face types (by enum value)
    and Dirichlet values (by field name) of ``config``, e.g. the
    reference package's; duck-typed, so nothing of that package is
    imported.  A port config is returned as it is."""
    if isinstance(config, ThermalBCConfig):
        return config
    faces = ("left", "right", "bottom", "top", "front", "back")
    values = config.dirichlet_values
    return ThermalBCConfig(
        **{f: BCType(int(getattr(config, f))) for f in faces},
        dirichlet_values=DirichletValues(
            **{f: float(getattr(values, f)) for f in faces}))
