"""The Poisson solver front end: creation, the solver object, and the
cached convenience API (counterpart of `cfd_tpu/solvers/poisson/
frontend.py`).

* ``create_solver(method)`` → a :class:`PoissonSolver`, bound to a
  geometry by ``init`` and run by ``solve`` / ``solve_result``;
* every ``Method`` is ported: Jacobi, SOR and Gauss-Seidel (one maker,
  ω resolved as the reference resolves it), Red-Black SOR, CG
  (``Precond.MULTIGRID`` turns it into MG-preconditioned CG), BiCGSTAB,
  multigrid and FFT_DIRECT (the exact spectral solve; a problem it does
  not take — nz = 3 with dz = 0 — raises ``ERROR_UNSUPPORTED`` at
  ``init``);
* Jacobi's factory defaults (``max_iterations=2000``,
  ``check_interval=10``, `linear_solver_jacobi.c:146-147`) apply only
  when the user gave no params, at ``create_solver`` or at ``init``;
* the cached ``poisson_solve`` / ``poisson_solve_3d`` run a preset, by
  default Red-Black SOR;
* the reference's ``use_pallas`` becomes the port's ``device`` / ``plain``
  convention: ``init`` builds the kernel solve for float32 inputs beside
  the plain solve for other dtypes — the whole-solve kernels on 2D grids
  (Jacobi on 3D ones too), the fused CG or BiCGSTAB passes, the Red-Black
  SOR sweep or the multigrid sweeps on 3D ones; on the CPU the kernel
  wrappers run their plain versions.  SOR and Gauss-Seidel have no kernel
  solve, as in the reference (`frontend.py:80-82`).  FFT_DIRECT's kernel
  solve is ``make_fft_direct`` with its products through the GEMM
  wrappers of `ops.kernels.rolling` (the hand-written SGEMM on the card),
  its plain solve the same maker on the plain products.
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
from .krylov import (make_bicgstab, make_bicgstab_fused, make_bicgstab_vmem,
                     make_cg, make_cg_fused, make_cg_vmem)
from .multigrid import (make_mg_cg, make_multigrid, make_multigrid_vmem,
                        raise_not_coarsenable)
from .spectral import make_fft_direct, spectral_supported
from .stationary import (make_jacobi, make_jacobi_vmem, make_redblack_sor,
                         make_redblack_sor_fused, make_redblack_sor_vmem,
                         make_sor)


def _make_cg_dispatch(problem, params, plain=True):
    if params.preconditioner == Precond.MULTIGRID:
        fn = make_mg_cg(problem, params, plain=plain)
        if fn is None:
            raise_not_coarsenable("multigrid preconditioner")
        return fn
    return make_cg(problem, params)


def _make_fft_dispatch(problem, params):
    if not spectral_supported(problem):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       "fft_direct: needs nz==1 or (nz>=3 with dz>0)")
    return make_fft_direct(problem, params, plain=True)


def _make_multigrid_dispatch(problem, params, plain=True):
    fn = make_multigrid(problem, params, plain=plain)
    if fn is None:
        raise_not_coarsenable("multigrid")
    return fn


_MAKERS = {
    Method.JACOBI: make_jacobi,
    Method.SOR: make_sor,
    Method.GAUSS_SEIDEL: make_sor,   # GS == SOR with omega resolved normally
    Method.REDBLACK_SOR: make_redblack_sor,
    Method.CG: _make_cg_dispatch,
    Method.BICGSTAB: make_bicgstab,
    Method.MULTIGRID: _make_multigrid_dispatch,
    Method.FFT_DIRECT: _make_fft_dispatch,
}


def _fused_maker(method: Method, problem: PoissonProblem,
                 params: PoissonParams, plain: bool):
    """The kernel solve of ``method`` (float32): the whole solve in one
    launch on 2D grids, the fused passes or sweeps on 3D ones; Jacobi,
    whose only kernel is the whole solve, takes it on both; FFT_DIRECT
    its products as GEMM launches.  None for SOR and Gauss-Seidel, which
    have none."""
    if method in (Method.SOR, Method.GAUSS_SEIDEL):
        return None
    if method == Method.FFT_DIRECT:
        return make_fft_direct(problem, params, plain=plain)
    two_d = problem.nz == 1
    if method == Method.JACOBI:
        return make_jacobi_vmem(problem, params, plain=plain)
    if method == Method.REDBLACK_SOR:
        if two_d:
            return make_redblack_sor_vmem(problem, params, plain=plain)
        return make_redblack_sor_fused(problem, params, plain=plain)
    if method == Method.BICGSTAB:
        if two_d:
            return make_bicgstab_vmem(problem, params, plain=plain)
        return make_bicgstab_fused(problem, params, plain=plain)
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
    _params_user_set: bool = False

    @property
    def name(self) -> str:
        return _METHOD_NAMES[self.method]

    def init(self, nx: int, ny: int, nz: int = 1,
             dx: float = 1.0, dy: float = 1.0, dz: float = 0.0,
             params: Optional[PoissonParams] = None) -> "PoissonSolver":
        """Bind to a problem geometry (mirrors poisson_solver_init);
        raises ``ERROR_UNSUPPORTED`` for a multigrid grid that cannot be
        coarsened or a problem FFT_DIRECT does not take."""
        self.problem = PoissonProblem(nx, ny, nz, dx, dy, dz)
        if params is not None:
            self.params = params
            self._params_user_set = True
        elif self.method == Method.JACOBI and not self._params_user_set:
            # Jacobi's factory defaults (`linear_solver.c:276-278`,
            # `linear_solver_jacobi.c:146-147`)
            self.params = dataclasses.replace(self.params,
                                              max_iterations=2000,
                                              check_interval=10)
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
    and selects nothing.  Params given here are never overridden by a
    method's factory defaults."""
    return PoissonSolver(method=Method(method),
                         params=params or PoissonParams(), device=device,
                         plain=plain, _params_user_set=params is not None)


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
    is Red-Black SOR."""
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
