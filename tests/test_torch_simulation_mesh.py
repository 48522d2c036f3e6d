"""The facade on a mesh: ``Simulation.create(..., mesh=)`` runs the whole
session decomposed (the port's `parallel.mesh.Mesh` on `LocalComm` CPU
shards) against the reference's single-device session, in float64 on the
CPU (modelled on `tests/parallel/test_facade_sharded.py:32-70`).

* ``step()``: the default solver (the 2D explicit Euler step) at 32×16
  over 4 y-shards, three steps; ``solve()``: Euler at 32×16×16 over 4
  z-shards with ``max_iter = 4`` (RK4 over (2, 2) runs through the
  facade in `chip_smoke.py` phase 57).  Fields, stats and time within
  1e-10 (the reference session's own bars,
  `tests/test_torch_simulation.py`);
* a solver swap keeps the mesh and places the field again: Euler → RK2
  on the y mesh against the reference session swapped the same way, and
  Euler → the spectral projection on the z mesh (a step with status 0);
* ``NSSolver.place`` of a field already on the solver's mesh passes it
  through; a field on another mesh is gathered and placed again.
"""

import numpy as np
import pytest
import torch

from cfd_tpu.api import Simulation as JSimulation
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu_torch.api import Simulation
from cfd_tpu_torch.parallel import ShardedField, make_mesh
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.solver import NSSolver

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
NAMES = ("u", "v", "w", "p", "rho", "T")


def _pair(mesh, nz=1, solver_type=None, params=None, jparams=None):
    zmax = 1.0 if nz > 1 else 0.0
    sim = Simulation.create(32, 16, nz, zmax=zmax, solver_type=solver_type,
                            params=params, dtype=torch.float64, mesh=mesh)
    jsim = JSimulation.create(32, 16, nz, zmax=zmax,
                              solver_type=solver_type, params=jparams)
    return sim, jsim


def _assert_close(sim, jsim, atol=1e-10):
    assert isinstance(sim.field, ShardedField)
    g = sim.field.gather()
    for n in NAMES:
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jsim.field, n)),
                                   rtol=0, atol=atol, err_msg=n)
    s, js = sim.get_stats(), jsim.get_stats()
    for a in ("max_velocity", "max_pressure", "max_temperature"):
        np.testing.assert_allclose(getattr(s, a), getattr(js, a),
                                   rtol=1e-10, atol=1e-12, err_msg=a)
    assert (s.iterations, int(s.status)) == (js.iterations, int(js.status))
    assert sim.current_time == pytest.approx(jsim.current_time, abs=1e-15)


def test_facade_on_mesh_step_matches_single_device():
    sim, jsim = _pair(make_mesh([CPU] * 4, axes=("y",)))
    for _ in range(3):
        assert int(sim.step()) == 0
        assert int(jsim.step()) == 0
    assert sim.solver.mesh is sim.mesh
    assert len(sim.field.blocks) == 4
    _assert_close(sim, jsim)


def test_facade_on_mesh_solve_matches_single_device():
    kw = dict(dt=0.001, cfl=0.2, mu=0.01, max_iter=4)
    sim, jsim = _pair(make_mesh([CPU] * 4, axes=("z",)), nz=16,
                      solver_type="explicit_euler", params=NSParams(**kw),
                      jparams=JParams(**kw))
    assert int(sim.solve()) == 0
    assert int(jsim.solve()) == 0
    assert sim.last_stats.iterations == jsim.last_stats.iterations == 4
    _assert_close(sim, jsim)


def test_facade_solver_swap_keeps_mesh():
    ymesh = make_mesh([CPU] * 4, axes=("y",))
    sim, jsim = _pair(ymesh)
    assert int(sim.step()) == 0 and int(jsim.step()) == 0
    assert sim.set_solver_by_name("rk2") == 0
    assert jsim.set_solver_by_name("rk2") == 0
    assert sim.solver.mesh is ymesh
    for _ in range(2):
        assert int(sim.step()) == 0 and int(jsim.step()) == 0
    _assert_close(sim, jsim)
    zmesh = make_mesh([CPU] * 4, axes=("z",))
    sim3, _ = _pair(zmesh, nz=16)
    assert sim3.set_solver_by_name("projection_spectral") == 0
    assert sim3.solver.mesh is zmesh
    assert int(sim3.step()) == 0
    assert isinstance(sim3.field, ShardedField)


def test_place_passes_through_or_replaces():
    grid_sim = Simulation.create(32, 16, 16, zmax=1.0, dtype=torch.float64,
                                 mesh=make_mesh([CPU] * 4, axes=("z",)))
    field = grid_sim.field
    assert grid_sim.solver.place(field) is field
    other = NSSolver(name="rk2", method="rk2", dtype=torch.float64,
                     mesh=make_mesh([CPU] * 4))
    other.init(grid_sim.grid, NSParams())
    moved = other.place(field)
    assert moved.mesh is other.mesh and moved.spec == ("z", "y", None)
    for n in NAMES:
        assert torch.equal(getattr(moved.gather(), n),
                           getattr(field.gather(), n))
