"""The Poisson solver front end: creation, the solver object, and the
cached convenience API (counterpart of `cfd_tpu/solvers/poisson/
frontend.py`).

* ``create_solver(method)`` → a :class:`PoissonSolver`, bound to a
  geometry by ``init`` and run by ``solve`` / ``solve_result``;
* CG (``Precond.MULTIGRID`` turns it into MG-preconditioned CG) and
  multigrid are ported; every other method raises
  ``CFDError(ERROR_UNSUPPORTED)`` at ``init`` until its slice — so does
  the cached ``poisson_solve`` / ``poisson_solve_3d`` with its default
  preset, which is Red-Black SOR;
* the reference's ``use_pallas`` becomes the port's ``device`` / ``plain``
  convention: ``init`` builds the kernel solve for float32 inputs (the
  whole-solve kernels in 2D, the fused CG passes or the multigrid sweeps
  in 3D) beside the plain solve for other dtypes; on the CPU the kernel
  wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, Optional, Tuple

import torch

from ...config import device_of
from ...core.status import CFDError, Status
from .base import (Method, PoissonParams, PoissonProblem, PoissonResult,
                   PoissonStats, PoissonStatus, Precond, result_to_stats)
from .krylov import make_cg, make_cg_fused, make_cg_vmem
from .multigrid import (make_mg_cg, make_multigrid, make_multigrid_vmem,
                        raise_not_coarsenable)


def _make_cg_dispatch(problem, params, plain=True):
    if params.preconditioner == Precond.MULTIGRID:
        fn = make_mg_cg(problem, params, plain=plain)
        if fn is None:
            raise_not_coarsenable("multigrid preconditioner")
        return fn
    return make_cg(problem, params)


def _make_multigrid_dispatch(problem, params, plain=True):
    fn = make_multigrid(problem, params, plain=plain)
    if fn is None:
        raise_not_coarsenable("multigrid")
    return fn


_MAKERS = {
    Method.CG: _make_cg_dispatch,
    Method.MULTIGRID: _make_multigrid_dispatch,
}


def _fused_maker(method: Method, problem: PoissonProblem,
                 params: PoissonParams, plain: bool):
    """The kernel solve of ``method`` (float32): the whole solve in one
    launch on 2D grids, the fused passes or sweeps on 3D ones."""
    two_d = problem.nz == 1
    if method == Method.MULTIGRID:
        if two_d:
            return make_multigrid_vmem(problem, params, plain=plain)
        return make_multigrid(problem, params, plain=plain)
    if params.preconditioner == Precond.MULTIGRID:
        return make_mg_cg(problem, params, plain=plain)
    if two_d:
        return make_cg_vmem(problem, params, plain=plain)
    return make_cg_fused(problem, params, plain=plain)


_METHOD_NAMES = {
    Method.JACOBI: "jacobi",
    Method.GAUSS_SEIDEL: "gauss_seidel",
    Method.SOR: "sor",
    Method.REDBLACK_SOR: "redblack",
    Method.CG: "cg",
    Method.BICGSTAB: "bicgstab",
    Method.MULTIGRID: "multigrid",
    Method.FFT_DIRECT: "fft_direct",
}


class SolverPreset(enum.IntEnum):
    """Mirrors poisson_solver_type (`poisson_solver.h:405-415`)."""

    SOR_SCALAR = 0
    JACOBI_SIMD = 1
    REDBLACK_SIMD = 2
    REDBLACK_OMP = 3
    REDBLACK_SCALAR = 4
    CG_SCALAR = 5
    CG_SIMD = 6
    CG_OMP = 7
    SOR_SIMD = 8


_PRESET_METHOD = {
    SolverPreset.SOR_SCALAR: Method.SOR,
    SolverPreset.JACOBI_SIMD: Method.JACOBI,
    SolverPreset.REDBLACK_SIMD: Method.REDBLACK_SOR,
    SolverPreset.REDBLACK_OMP: Method.REDBLACK_SOR,
    SolverPreset.REDBLACK_SCALAR: Method.REDBLACK_SOR,
    SolverPreset.CG_SCALAR: Method.CG,
    SolverPreset.CG_SIMD: Method.CG,
    SolverPreset.CG_OMP: Method.CG,
    SolverPreset.SOR_SIMD: Method.SOR,
}

#: Default preset for the projection pressure solve
#: (DEFAULT_POISSON_SOLVER, `poisson_solver.h:418`).
DEFAULT_PRESET = SolverPreset.REDBLACK_SIMD


@dataclasses.dataclass
class PoissonSolver:
    """A configured Poisson solver bound to one problem geometry
    (create → init → solve).  ``device`` is where ``solve`` puts its
    inputs (None: the card); ``plain=True`` makes the kernel solve run
    its plain version on the card too (a reference switch for checks)."""

    method: Method
    problem: Optional[PoissonProblem] = None
    params: PoissonParams = PoissonParams()
    device: Optional[object] = None
    plain: bool = False
    _solve_fn: Optional[object] = None
    _fused_fn: Optional[object] = None

    @property
    def name(self) -> str:
        return _METHOD_NAMES[self.method]

    def init(self, nx: int, ny: int, nz: int = 1,
             dx: float = 1.0, dy: float = 1.0, dz: float = 0.0,
             params: Optional[PoissonParams] = None) -> "PoissonSolver":
        """Bind to a problem geometry (mirrors poisson_solver_init);
        raises ``ERROR_UNSUPPORTED`` for a method not ported yet or a
        multigrid grid that cannot be coarsened."""
        if self.method not in _MAKERS:
            raise CFDError(Status.ERROR_UNSUPPORTED,
                           f"Poisson method {self.method.name} is not "
                           f"ported yet")
        self.problem = PoissonProblem(nx, ny, nz, dx, dy, dz)
        if params is not None:
            self.params = params
        self._solve_fn = _MAKERS[self.method](self.problem, self.params)
        self._fused_fn = _fused_maker(self.method, self.problem,
                                      self.params, self.plain)
        return self

    def _dispatch(self, x):
        if self._fused_fn is not None and x.dtype == torch.float32:
            return self._fused_fn
        return self._solve_fn

    def _inputs(self, x, rhs):
        dev = device_of(self.device)
        return (torch.as_tensor(x, device=dev),
                torch.as_tensor(rhs, device=dev))

    def solve(self, x, rhs) -> Tuple[torch.Tensor, PoissonStats]:
        """Solve ∇²x = rhs from the initial guess x; returns (x, stats).
        A (ny, nx) plane in gives a plane out."""
        if self._solve_fn is None:
            raise CFDError(Status.ERROR_INVALID, "solver not initialized")
        x, rhs = self._inputs(x, rhs)
        squeeze = x.dim() == 2
        if squeeze:
            x, rhs = x[None], rhs[None]
        t0 = time.perf_counter()
        result: PoissonResult = self._dispatch(x)(x, rhs)
        stats = result_to_stats(result)      # waits for the device
        stats = dataclasses.replace(
            stats, elapsed_time_ms=(time.perf_counter() - t0) * 1e3)
        out = result.x[0] if squeeze else result.x
        return out, stats

    def solve_result(self, x, rhs) -> PoissonResult:
        """Device-side solve for embedding in larger computations."""
        if self._solve_fn is None:
            raise CFDError(Status.ERROR_INVALID, "solver not initialized")
        return self._dispatch(x)(x, rhs)

    def compute_residual(self, x, rhs) -> float:
        x, rhs = self._inputs(x, rhs)
        if x.dim() == 2:
            x, rhs = x[None], rhs[None]
        return float(self.problem.residual_inf(x, rhs))


def create_solver(method: Method, params: Optional[PoissonParams] = None,
                  backend=None, device=None,
                  plain: bool = False) -> PoissonSolver:
    """Mirrors poisson_solver_create; ``backend`` is accepted for parity
    and selects nothing."""
    return PoissonSolver(method=Method(method),
                         params=params or PoissonParams(), device=device,
                         plain=plain)


# ---------------------------------------------------------------------------
# Cached convenience API (poisson_solve / poisson_solve_3d equivalents)
# ---------------------------------------------------------------------------

_cache: Dict[SolverPreset, PoissonSolver] = {}


def clear_cache() -> None:
    _cache.clear()


def poisson_solve_3d(p, rhs, nx: int, ny: int, nz: int,
                     dx: float, dy: float, dz: float,
                     preset: SolverPreset = DEFAULT_PRESET, device=None):
    """Convenience solve with one cached solver per preset, recreated when
    the geometry changes (`linear_solver.c:589-705`); returns
    (p, iterations), iterations −1 on non-convergence.  The default preset
    (Red-Black SOR) raises ``ERROR_UNSUPPORTED`` until its slice."""
    preset = SolverPreset(preset)
    solver = _cache.get(preset)
    prob = (nx, ny, nz, dx, dy, dz)
    if (solver is None or solver.problem is None
            or (solver.problem.nx, solver.problem.ny, solver.problem.nz,
                solver.problem.dx, solver.problem.dy,
                solver.problem.dz) != prob):
        solver = create_solver(_PRESET_METHOD[preset], device=device)
        solver.init(nx, ny, nz, dx, dy, dz)
        _cache[preset] = solver
    p_out, stats = solver.solve(p, rhs)
    if stats.status == PoissonStatus.CONVERGED:
        return p_out, stats.iterations
    return p_out, -1


def poisson_solve(p, rhs, nx: int, ny: int, dx: float, dy: float,
                  preset: SolverPreset = DEFAULT_PRESET, device=None):
    """2D convenience wrapper (mirrors poisson_solve)."""
    return poisson_solve_3d(p, rhs, nx, ny, 1, dx, dy, 0.0, preset, device)
