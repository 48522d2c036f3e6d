"""The simulation facade (counterpart of `cfd_tpu/api/simulation.py`,
`simulation_api.c`), without outputs or checkpoints.

The same lifecycle and deliberate quirks:

* ``create`` builds a uniform grid, the default sinusoidal initial field,
  a registry of the default solvers and the requested one (default
  ``explicit_euler``) with ``max_iter = 1`` (`simulation_api.c:72-77`);
* ``step`` hard-codes ``dt = 0.005`` (`simulation_api.c:191`); Euler's
  step then caps it at 1e-4 itself;
* ``solve`` runs ``max_iter`` guarded steps and accumulates
  ``current_time += dt·iterations``.

The session lives on the card unless ``device`` says otherwise.  With
``mesh`` (a `parallel.mesh.Mesh`) it runs on a domain decomposition
(`simulation.py:65-112` of the reference): every solver bound to the
session takes the mesh, ``field`` is a `parallel.mesh.ShardedField`, and
``step`` / ``solve`` run the sharded step and its guarded loop.  VTK/CSV
outputs and checkpoints raise ``CFDError(ERROR_UNSUPPORTED)``: they come
with the I/O slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..config import device_of, resolve_dtype
from ..core.field import FlowField
from ..core.grid import Grid
from ..core.runtime import init as cfd_init
from ..core.status import CFDError, Status
from ..solvers.ns.params import NSParams, NSStats
from ..solvers.ns.solver import NSSolver
from .registry import SolverRegistry, create_registry

DEFAULT_SOLVER_TYPE = "explicit_euler"
STEP_DT = 0.005  # run_simulation_step's fixed dt (`simulation_api.c:191`)


def _not_ported(what: str):
    raise CFDError(Status.ERROR_UNSUPPORTED,
                   f"Simulation: {what} is not ported yet")


class Simulation:
    """Mirrors simulation_data (`simulation_api.h:22-33`)."""

    def __init__(self, grid: Grid, field: FlowField, params: NSParams,
                 solver: NSSolver, registry: SolverRegistry):
        self.grid = grid
        self.field = field
        self.params = params
        self.solver = solver
        self.registry = registry
        self.current_time: float = 0.0
        self.last_stats = NSStats()
        self.mesh = None  # the domain decomposition; from_grid(mesh=...)

    # ---- construction ------------------------------------------------------

    @classmethod
    def create(cls, nx: int, ny: int, nz: int = 1,
               xmin: float = 0.0, xmax: float = 1.0,
               ymin: float = 0.0, ymax: float = 1.0,
               zmin: float = 0.0, zmax: float = 0.0,
               solver_type: Optional[str] = None,
               params: Optional[NSParams] = None,
               device=None, dtype=None, mesh=None) -> "Simulation":
        """init_simulation[_with_solver] (`simulation_api.c:24-140`)."""
        grid = Grid.uniform(nx, ny, nz, xmin, xmax, ymin, ymax, zmin, zmax)
        return cls.from_grid(grid, solver_type, params, device=device,
                             dtype=dtype, mesh=mesh)

    @classmethod
    def from_grid(cls, grid: Grid, solver_type: Optional[str] = None,
                  params: Optional[NSParams] = None, device=None,
                  dtype=None, mesh=None) -> "Simulation":
        """``create`` for a caller-built grid.  ``mesh``: the session runs
        on that domain decomposition (the start field is made on the
        mesh's first device, then placed by the solver); ``device`` is
        then ignored."""
        cfd_init()      # lazy global init, as init_simulation (`:26`)
        if mesh is not None:
            device = mesh.devices.flat[mesh.comm.shards[0]]
        device = device_of(device)
        dtype = resolve_dtype(dtype, device)
        field = FlowField.initialize(grid, dtype=dtype, device=device)
        if params is None:
            params = NSParams(dt=0.001, cfl=0.2, mu=0.01, max_iter=1)
        registry = create_registry(device, dtype)
        name = solver_type or DEFAULT_SOLVER_TYPE
        solver = registry.create(name)
        if solver is None:
            raise CFDError(Status.ERROR_NOT_FOUND,
                           f"solver '{name}' not registered")
        solver.mesh = mesh
        solver.init(grid, params)
        sim = cls(grid, solver.place(field), params, solver, registry)
        sim.mesh = mesh
        return sim

    # ---- solver management -------------------------------------------------

    def set_solver(self, solver: NSSolver) -> None:
        """simulation_set_solver.  The session's mesh carries over to the
        new solver, and the field is placed again under it."""
        solver.mesh = self.mesh
        solver.init(self.grid, self.params)
        self.solver = solver
        self.field = solver.place(self.field)

    def set_solver_by_name(self, solver_type: str) -> int:
        """simulation_set_solver_by_name; -1 on unknown name."""
        solver = self.registry.create(solver_type)
        if solver is None:
            return -1
        self.set_solver(solver)
        return 0

    def get_stats(self) -> NSStats:
        return self.last_stats

    # ---- stepping ----------------------------------------------------------

    def step(self) -> Status:
        """run_simulation_step: fixed dt = 0.005, one solver step."""
        self.params = self.params.replace(dt=STEP_DT)
        self._rebind_if_needed()
        self.field, self.last_stats = self.solver.step(self.field, STEP_DT)
        if self.last_stats.status != Status.SUCCESS:
            return self.last_stats.status
        self.current_time += STEP_DT
        return Status.SUCCESS

    def solve(self) -> Status:
        """run_simulation_solve: max_iter steps, accumulate elapsed time."""
        self.params = self.params.replace(dt=STEP_DT)
        self._rebind_if_needed()
        self.field, self.last_stats = self.solver.solve(self.field, STEP_DT)
        self.current_time += STEP_DT * self.last_stats.iterations
        return self.last_stats.status

    def _rebind_if_needed(self):
        """dt flows into the step at call time, so only a change of the
        structural parameters rebuilds the solver's closures."""
        if self.solver.params is not self.params:
            if self.solver.params is None or \
                    _structural(self.solver.params) != _structural(
                        self.params):
                self.solver.init(self.grid, self.params)
            else:
                self.solver.params = self.params

    # ---- outputs and checkpoints (the I/O slice) ---------------------------

    def register_output(self, *args, **kwargs) -> None:
        _not_ported("register_output (VTK/CSV outputs)")

    def write_outputs(self, step: int) -> None:
        _not_ported("write_outputs (VTK/CSV outputs)")

    def save_checkpoint(self, path: str) -> Status:
        _not_ported("save_checkpoint")

    @classmethod
    def load_checkpoint(cls, path: str) -> "Simulation":
        _not_ported("load_checkpoint")

    def restore_checkpoint(self, path: str) -> Status:
        _not_ported("restore_checkpoint")


def _structural(p: NSParams):
    """Fields whose change requires rebuilding the step."""
    return dataclasses.replace(p, dt=0.0)


# ---- module-level solver discovery (simulation_api.c:452-490) --------------

_SOLVER_NAMES = [
    "explicit_euler", "explicit_euler_optimized", "projection",
    "projection_optimized", "explicit_euler_gpu", "projection_gpu",
    "explicit_euler_omp", "projection_omp",
    "projection_spectral", "projection_multigrid",
]


def list_solvers() -> List[str]:
    return list(_SOLVER_NAMES)


def has_solver(solver_type: str) -> bool:
    return solver_type in _SOLVER_NAMES
