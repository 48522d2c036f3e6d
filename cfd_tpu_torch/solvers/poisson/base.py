"""Poisson solver types (counterpart of `cfd_tpu/solvers/poisson/base.py`,
restricted to the types the projection step reads)."""

from __future__ import annotations

import dataclasses
import enum

from ...core.status import CFDError, Status


class Method(enum.IntEnum):
    """Mirrors poisson_solver_method_t (`poisson_solver.h:53-61`)."""

    JACOBI = 0
    GAUSS_SEIDEL = 1
    SOR = 2
    REDBLACK_SOR = 3
    CG = 4
    BICGSTAB = 5
    MULTIGRID = 6
    FFT_DIRECT = 7   # exact DST-I solve on uniform grids


class Precond(enum.IntEnum):
    NONE = 0
    JACOBI = 1
    MULTIGRID = 2


@dataclasses.dataclass(frozen=True)
class PoissonParams:
    """Mirrors poisson_solver_params_t with the same defaults."""

    tolerance: float = 1e-6
    absolute_tolerance: float = 1e-10
    max_iterations: int = 5000
    omega: float = 0.0
    check_interval: int = 1
    verbose: bool = False
    preconditioner: Precond = Precond.NONE


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """Static problem geometry (nz == 1, dz == 0 for 2D)."""

    nx: int
    ny: int
    nz: int = 1
    dx: float = 1.0
    dy: float = 1.0
    dz: float = 0.0

    def __post_init__(self):
        if self.nx < 3 or self.ny < 3 or (self.nz > 1 and self.nz < 3):
            raise CFDError(Status.ERROR_INVALID,
                           "Poisson grid needs >= 3 points per active axis")

    @property
    def inv_dx2(self) -> float:
        return 1.0 / (self.dx * self.dx)

    @property
    def inv_dy2(self) -> float:
        return 1.0 / (self.dy * self.dy)

    @property
    def inv_dz2(self) -> float:
        return 1.0 / (self.dz * self.dz) if self.dz > 0.0 else 0.0
