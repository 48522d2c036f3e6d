"""Structured grid, uniform or tanh-stretched (counterpart of
`cfd_tpu/core/grid.py`).

The grid is static host configuration: coordinates and spacings are numpy
float64 arrays, and solvers read them when they build a step.  Fields on
the grid are ``(nz, ny, nx)`` tensors with x last, the reference's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import resolve_dtype
from .status import CFDError, Status


@dataclasses.dataclass(frozen=True)
class Grid:
    """Node-centered collocated grid: ``x[0] == xmin``, ``x[-1] == xmax``,
    ``dx[i] = x[i+1] − x[i]`` (length nx − 1)."""

    nx: int
    ny: int
    nz: int
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    zmin: float
    zmax: float
    x: np.ndarray
    y: np.ndarray
    dx: np.ndarray
    dy: np.ndarray
    z: Optional[np.ndarray] = None
    dz: Optional[np.ndarray] = None
    inv_dz2: float = 0.0

    @staticmethod
    def _validate(nx, ny, nz, xmin, xmax, ymin, ymax, zmin, zmax):
        if nx <= 0 or ny <= 0 or nz <= 0:
            raise CFDError(Status.ERROR_INVALID,
                           "grid dimensions must be positive")
        if xmax <= xmin or ymax <= ymin:
            raise CFDError(Status.ERROR_INVALID,
                           "grid bounds invalid (max must be > min)")
        if nz > 1 and zmax <= zmin:
            raise CFDError(Status.ERROR_INVALID,
                           "grid z-bounds invalid (zmax must be > zmin "
                           "when nz > 1)")

    @classmethod
    def uniform(cls, nx: int, ny: int, nz: int = 1,
                xmin: float = 0.0, xmax: float = 1.0,
                ymin: float = 0.0, ymax: float = 1.0,
                zmin: float = 0.0, zmax: float = 0.0) -> "Grid":
        cls._validate(nx, ny, nz, xmin, xmax, ymin, ymax, zmin, zmax)
        x = np.linspace(xmin, xmax, nx)
        y = np.linspace(ymin, ymax, ny)
        z = dz = None
        inv_dz2 = 0.0
        if nz > 1:
            z = np.linspace(zmin, zmax, nz)
            dz = np.diff(z)
            inv_dz2 = 1.0 / float(dz[0] ** 2)
        return cls(nx, ny, nz, xmin, xmax, ymin, ymax, zmin, zmax,
                   x, y, np.diff(x), np.diff(y), z, dz, inv_dz2)

    @classmethod
    def stretched(cls, nx: int, ny: int, nz: int = 1,
                  xmin: float = 0.0, xmax: float = 1.0,
                  ymin: float = 0.0, ymax: float = 1.0,
                  zmin: float = 0.0, zmax: float = 0.0,
                  beta: float = 0.0, stretch_axes: str = "xyz") -> "Grid":
        """Tanh-stretched grid clustering points at both ends of each axis
        named in ``stretch_axes`` (`grid.py:92-137`, `grid.c:129-160`):
        x[i] = xmin + L·(1 + tanh(β(2ξ − 1))/tanh(β))/2, ξ = i/(n − 1);
        the other axes stay uniform.  |β| < 1e-10 gives ``uniform``.  In
        3D ``inv_dz2`` is taken from the smallest dz."""
        bad = set(stretch_axes) - set("xyz")
        if bad or not stretch_axes:
            raise ValueError(f"stretch_axes must name axes from 'xyz', "
                             f"got {stretch_axes!r}")
        if abs(beta) < 1e-10:
            return cls.uniform(nx, ny, nz, xmin, xmax, ymin, ymax, zmin,
                               zmax)
        cls._validate(nx, ny, nz, xmin, xmax, ymin, ymax, zmin, zmax)
        tb = np.tanh(beta)

        def stretch(n, lo, hi, axis):
            if axis not in stretch_axes:
                return np.linspace(lo, hi, n)
            xi = np.arange(n) / (n - 1)
            return lo + (hi - lo) * (1.0 + np.tanh(beta * (2.0 * xi - 1.0))
                                     / tb) / 2.0

        x = stretch(nx, xmin, xmax, "x")
        y = stretch(ny, ymin, ymax, "y")
        z = dz = None
        inv_dz2 = 0.0
        if nz > 1:
            z = stretch(nz, zmin, zmax, "z")
            dz = np.diff(z)
            inv_dz2 = 1.0 / float(np.min(dz) ** 2)
        return cls(nx, ny, nz, xmin, xmax, ymin, ymax, zmin, zmax,
                   x, y, np.diff(x), np.diff(y), z, dz, inv_dz2)

    @property
    def shape(self):
        """Field shape (nz, ny, nx)."""
        return (self.nz, self.ny, self.nx)

    @property
    def dx0(self) -> float:
        return float(self.dx[0])

    @property
    def dy0(self) -> float:
        return float(self.dy[0])

    @property
    def dz0(self) -> float:
        """First z-spacing; 0.0 in 2D (the inv_dz2 = 0 convention)."""
        return float(self.dz[0]) if self.nz > 1 else 0.0

    def is_uniform(self, axis: str = "all", rtol: float = 1e-12) -> bool:
        def uni(d):
            if d is None or len(d) == 0:
                return True
            tol = rtol * max(1.0, abs(float(d[0])))
            return bool(np.all(np.abs(d - d[0]) <= tol))

        if axis in ("x", "y", "z"):
            return uni(getattr(self, "d" + axis))
        return uni(self.dx) and uni(self.dy) and uni(self.dz)

    def coordinate_arrays(self, dtype=None, device=None):
        """Broadcastable (nz, ny, nx) coordinate tensors X, Y, Z."""
        dt = resolve_dtype(dtype, device)
        X = torch.as_tensor(self.x, dtype=dt, device=device)[None, None, :]
        Y = torch.as_tensor(self.y, dtype=dt, device=device)[None, :, None]
        if self.nz > 1:
            Z = torch.as_tensor(self.z, dtype=dt, device=device)[:, None,
                                                                 None]
        else:
            Z = torch.zeros((1, 1, 1), dtype=dt, device=device)
        return X, Y, Z
