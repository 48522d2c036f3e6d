"""Poisson solver types and device-side building blocks (counterpart of
`cfd_tpu/solvers/poisson/base.py`).

Semantics kept from the reference:

* solve ∇²x = rhs on the interior points with Neumann BCs on x
  (`linear_solver.c:348-392`);
* relative tolerance ``tol·‖r₀‖`` floored by ``absolute_tolerance``;
* Krylov methods measure the L2 norm of their recursion residual,
  checked every ``check_interval`` iterations;
* status codes CONVERGED / MAX_ITER / DIVERGED / STAGNATED.

A solve returns a :class:`PoissonResult` of 0-d device tensors, so a step
can fold its status into the step status without reading it on the host.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from ...boundary.apply import apply_neumann_scalar
from ...core.status import CFDError, Status
from ...ops import stencils


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


class PoissonStatus(enum.IntEnum):
    """Mirrors poisson_solver_status_t (`poisson_solver.h:77-83`)."""

    CONVERGED = 0
    MAX_ITER = 1
    DIVERGED = 2
    STAGNATED = 3
    ERROR = -1


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
class PoissonStats:
    """Host-side stats (mirrors poisson_solver_stats_t)."""

    status: PoissonStatus = PoissonStatus.ERROR
    iterations: int = 0
    initial_residual: float = 0.0
    final_residual: float = 0.0
    elapsed_time_ms: float = 0.0


@dataclasses.dataclass(frozen=True)
class PoissonResult:
    """A solve's result: ``x`` and four 0-d tensors on its device."""

    x: torch.Tensor
    iterations: torch.Tensor        # int32
    initial_residual: torch.Tensor
    final_residual: torch.Tensor
    status: torch.Tensor            # int32 PoissonStatus code


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """Static problem geometry (nz == 1, dz == 0 for 2D).  Fields are
    (nz, ny, nx); the interior is planes 1..nz−2 in 3D, the one plane in
    2D."""

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
    def shape(self):
        return (self.nz, self.ny, self.nx)

    @property
    def inv_dx2(self) -> float:
        return 1.0 / (self.dx * self.dx)

    @property
    def inv_dy2(self) -> float:
        return 1.0 / (self.dy * self.dy)

    @property
    def inv_dz2(self) -> float:
        return 1.0 / (self.dz * self.dz) if self.dz > 0.0 else 0.0

    @property
    def inv_factor(self) -> float:
        """1 / diag of the (negative) Laplacian."""
        return 1.0 / (2.0 * (self.inv_dx2 + self.inv_dy2 + self.inv_dz2))

    # ---- device-side building blocks ---------------------------------------

    def interior(self, a):
        return stencils.interior(a)

    def set_interior(self, dst, src):
        """A copy of ``dst`` whose interior is ``src``'s."""
        return stencils.set_interior(dst, stencils.interior(src))

    def zero_boundary(self, a):
        """``a`` with its boundary shell zeroed (interior kept)."""
        return self.set_interior(torch.zeros_like(a), a)

    def laplacian(self, x):
        """5/7-point Laplacian on the interior, zero on the shell (the
        reference's wrapped shell values, which every caller discards)."""
        out = torch.zeros_like(x)
        out[stencils.interior_index(x)] = stencils.laplacian(
            x, self.inv_dx2, self.inv_dy2, self.inv_dz2)
        return out

    def residual_inf(self, x, rhs):
        """‖∇²x − rhs‖∞ over the interior (`linear_solver.c:304-346`)."""
        return torch.amax(torch.abs(self.interior(self.laplacian(x) - rhs)))

    def dot_interior(self, a, b):
        """Interior dot product (`linear_solver_cg.c:67-80`)."""
        return torch.sum(self.interior(a) * self.interior(b))

    def neumann_bc(self, x):
        """Zero-gradient BC on all faces, a new tensor
        (`linear_solver.c:361-392`)."""
        return apply_neumann_scalar(x)

    def tolerance_for(self, params: PoissonParams, initial_res):
        return torch.clamp_min(params.tolerance * initial_res,
                               params.absolute_tolerance)


def result_to_stats(result: PoissonResult,
                    elapsed_ms: float = 0.0) -> PoissonStats:
    """Read a result on the host."""
    return PoissonStats(
        status=PoissonStatus(int(result.status)),
        iterations=int(result.iterations),
        initial_residual=float(result.initial_residual),
        final_residual=float(result.final_residual),
        elapsed_time_ms=float(elapsed_ms))
