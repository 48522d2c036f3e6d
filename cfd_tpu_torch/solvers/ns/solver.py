"""The pluggable NSSolver object (counterpart of
`cfd_tpu/solvers/ns/solver.py`, single device).

One class whose ``init`` builds the step and solve closures for a
(grid, params) pair on the solver's ``device`` (the card unless set), with
the reference's lifecycle (create → init → step/solve) and stats.
Methods: ``explicit_euler``, ``rk2``, ``rk4`` and ``projection``; the
projection's pressure solve is CG (the default, with ``poisson_params``),
multigrid (``MULTIGRID``, the registry's ``projection_multigrid``) or the
spectral direct solve (``FFT_DIRECT``), and any other method raises
``CFDError(ERROR_UNSUPPORTED)`` at ``init``.  There is no ``mesh``:
sharding is a later slice.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Optional

import torch

from ...boundary.apply import apply_periodic_field
from ...config import device_of
from ...core.features import Backend
from ...core.field import FlowField
from ...core.grid import Grid
from ...core.status import CFDError, Status
from ..poisson.base import Method as PoissonMethod
from ..poisson.base import PoissonParams
from .common import compute_dt as _compute_dt
from .common import iterate_with_divergence_guard
from .euler import make_euler_step
from .params import NSParams, NSStats, StepResult
from .projection import make_projection_step
from .rk import make_rk2_step, make_rk4_step


class Capability(enum.IntFlag):
    """Mirrors ns_solver_capabilities_t (`navier_stokes_solver.h:183-192`)."""

    NONE = 0
    INCOMPRESSIBLE = 1 << 0
    COMPRESSIBLE = 1 << 1
    STEADY_STATE = 1 << 2
    TRANSIENT = 1 << 3
    SIMD = 1 << 4
    PARALLEL = 1 << 5
    GPU = 1 << 6


_STEP_BUILDERS = {
    "explicit_euler": make_euler_step,
    "rk2": make_rk2_step,
    "rk4": make_rk4_step,
}


@dataclasses.dataclass
class NSSolver:
    """A named, configured NS time integrator.

    ``method`` ∈ {explicit_euler, rk2, rk4, projection}; ``backend`` is the
    reference-compat tag.  ``device`` and ``dtype`` place the state the
    steps expect (None: the card, float32 there).
    """

    name: str
    method: str
    description: str = ""
    version: str = "1.0"
    backend: Backend = Backend.SCALAR
    capabilities: Capability = (Capability.INCOMPRESSIBLE
                                | Capability.TRANSIENT | Capability.SIMD
                                | Capability.PARALLEL)
    poisson_method: PoissonMethod = PoissonMethod.CG
    poisson_params: Optional[PoissonParams] = None
    spectral_precision: Optional[object] = None
    device: Optional[object] = None
    dtype: Optional[torch.dtype] = None

    # bound at init()
    grid: Optional[Grid] = None
    params: Optional[NSParams] = None
    _step_fn: Optional[Callable] = None
    _solve_fn: Optional[Callable] = None

    def init(self, grid: Grid, params: NSParams) -> Status:
        """Build the step/solve closures (mirrors solver_init); raises
        ``CFDError`` outside the ported slice."""
        if self.method == "projection":
            method = PoissonMethod(self.poisson_method)
            if method not in (PoissonMethod.CG, PoissonMethod.MULTIGRID,
                              PoissonMethod.FFT_DIRECT):
                raise CFDError(
                    Status.ERROR_UNSUPPORTED,
                    f"solver '{self.name}': the {method.name} pressure "
                    f"solve is not ported yet")
            step = make_projection_step(
                grid, params, dtype=self.dtype,
                poisson_method=self.poisson_method,
                poisson_params=self.poisson_params, device=self.device,
                spectral_precision=self.spectral_precision)
        else:
            step = _STEP_BUILDERS[self.method](grid, params, self.dtype,
                                               self.device)
        self.grid, self.params = grid, params
        max_iter = params.max_iter

        def solve(field, dt):
            return iterate_with_divergence_guard(step, field, dt, max_iter)

        self._step_fn, self._solve_fn = step, solve
        return Status.SUCCESS

    def _require_init(self):
        if self._step_fn is None:
            raise CFDError(Status.ERROR_INVALID, "solver not initialized")

    def _sync(self):
        if device_of(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, field: FlowField, dt: Optional[float] = None,
             iter_idx: int = 0):
        """One time step (mirrors solver_step); returns (field, NSStats).
        Waits for the device, as the reference's blocking call does."""
        self._require_init()
        dt = self.params.dt if dt is None else dt
        t0 = time.perf_counter()
        new_field, res = self._step_fn(field, dt, iter_idx)
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        return new_field, self._stats(res, dt, ms)

    def solve(self, field: FlowField, dt: Optional[float] = None):
        """``max_iter`` guarded steps (mirrors solver_solve); returns
        (field, NSStats)."""
        self._require_init()
        dt = self.params.dt if dt is None else dt
        t0 = time.perf_counter()
        new_field, res = self._solve_fn(field, dt)
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        return new_field, self._stats(res, dt, ms)

    def step_result(self, field: FlowField, dt, iter_idx=0):
        """Device-side step (no host sync)."""
        self._require_init()
        return self._step_fn(field, dt, iter_idx)

    def apply_boundary(self, field: FlowField) -> FlowField:
        """Default periodic BCs on all variables (solver_apply_boundary)."""
        return apply_periodic_field(field)

    def compute_dt(self, field: FlowField) -> float:
        self._require_init()
        return _compute_dt(field, self.grid, self.params)

    def _stats(self, res: StepResult, dt, ms) -> NSStats:
        status_code = int(res.status)
        dmin = min(float(self.grid.dx.min()), float(self.grid.dy.min()))
        vmax = float(res.max_velocity)
        return NSStats(
            iterations=int(res.iterations),
            residual=float(res.residual),
            max_velocity=vmax,
            max_pressure=float(res.max_pressure),
            max_temperature=float(res.max_temperature),
            cfl_number=vmax * float(dt) / dmin if dmin > 0 else 0.0,
            elapsed_time_ms=ms,
            status=Status(status_code) if status_code else Status.SUCCESS)
