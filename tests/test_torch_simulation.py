"""The port's solver registry, `NSSolver` and `Simulation` facade against
the reference's (`cfd_tpu.api`), in float64 on the CPU.

* ``Simulation.create(32, 16)`` with the default solver (the 2D explicit
  Euler step), then ``rk4``, then ``projection_spectral``: ten
  ``step()``s each and one ``solve()``, fields, stats and time against
  the reference's session;
* every registered name: the same list, backends and descriptions; the
  CG ``projection`` family runs a session like the other ported names;
  each of the 18 names inits and steps; ``projection_multigrid`` runs a
  2D session on a 2^k+1 grid;
* the divergence guard of ``solve`` on a field with a NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.api import Simulation as JSimulation
from cfd_tpu.api import create_registry as j_create_registry
from cfd_tpu.api import has_solver as j_has_solver
from cfd_tpu.api import infer_backend as j_infer_backend
from cfd_tpu.api import list_solvers as j_list_solvers
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.solver import NSSolver as JSolver
from cfd_tpu_torch import CFDError, FlowField, Grid, Status
from cfd_tpu_torch.api import (Simulation, create_registry, has_solver,
                               infer_backend, list_solvers)
from cfd_tpu_torch.api.registry import SolverRegistry
from cfd_tpu_torch.core.features import Backend
from cfd_tpu_torch.core.status import get_last_error, get_last_status
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.solver import NSSolver

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")


def _session(nx=32, ny=16, **kw):
    return Simulation.create(nx, ny, device="cpu", dtype=torch.float64, **kw)


def _assert_sessions_close(sim, jsim, atol=1e-10):
    out = field_to_numpy(sim.field)
    for n in NAMES:
        np.testing.assert_allclose(out[n], np.asarray(getattr(jsim.field, n)),
                                   rtol=0, atol=atol, err_msg=n)
    s, js = sim.get_stats(), jsim.get_stats()
    for a in ("max_velocity", "max_pressure", "max_temperature",
              "cfl_number"):
        np.testing.assert_allclose(getattr(s, a), getattr(js, a),
                                   rtol=1e-10, atol=1e-12, err_msg=a)
    assert (s.iterations, int(s.status)) == (js.iterations, int(js.status))
    assert sim.current_time == pytest.approx(jsim.current_time, abs=1e-15)


def _run_both(sim, jsim, n_steps):
    for _ in range(n_steps):
        assert sim.step() == jsim.step() == Status.SUCCESS


def test_default_session_then_rk4_then_spectral():
    """The facade's first use: the default solver, then two switches by
    name, ten steps of each and a closing solve()."""
    sim, jsim = _session(), JSimulation.create(32, 16)
    assert sim.solver.name == jsim.solver.name == "explicit_euler"
    assert sim.field.dtype == torch.float64
    for name in (None, "rk4", "projection_spectral"):
        if name is not None:
            assert sim.set_solver_by_name(name) == 0
            assert jsim.set_solver_by_name(name) == 0
        _run_both(sim, jsim, 10)
        _assert_sessions_close(sim, jsim)
    assert sim.solve() == jsim.solve() == Status.SUCCESS
    _assert_sessions_close(sim, jsim)


@pytest.mark.parametrize("name", ["explicit_euler", "rk2", "rk4",
                                  "projection_spectral", "rk2_omp",
                                  "explicit_euler_optimized", "projection",
                                  "projection_optimized", "projection_omp",
                                  "projection_gpu"])
def test_session_per_solver(name):
    """Each ported name from ``create``, 3D as well (nz = 6), with
    ``max_iter = 3`` so ``solve()`` runs the guarded loop."""
    kw = dict(nz=6, zmin=0.0, zmax=1.0)
    params = dict(dt=0.001, cfl=0.2, mu=0.01, max_iter=3)
    sim = _session(24, 20, solver_type=name, params=NSParams(**params), **kw)
    jsim = JSimulation.create(24, 20, solver_type=name,
                              params=JParams(**params), **kw)
    _run_both(sim, jsim, 4)
    _assert_sessions_close(sim, jsim)
    assert sim.solve() == jsim.solve()
    _assert_sessions_close(sim, jsim)
    assert sim.get_stats().iterations == 3


def test_projection_session_2d():
    """The reference's default projection solver (CG) through the facade
    at its published small grid: ``Simulation.create(100, 50,
    solver_type="projection")``, ten ``step()``s and a ``solve()``."""
    sim = _session(100, 50, solver_type="projection")
    jsim = JSimulation.create(100, 50, solver_type="projection")
    assert sim.solver.poisson_params is None
    _run_both(sim, jsim, 10)
    _assert_sessions_close(sim, jsim)
    assert sim.solve() == jsim.solve() == Status.SUCCESS
    _assert_sessions_close(sim, jsim)


def test_projection_facade_growth_matches_reference():
    """The facade's fixed dt = 0.005 is past the explicit viscous limit
    of the 100×50 projection (2ν·dt·(1/dx² + 1/dy²) = 1.22 > 1): a
    grid-scale mode grows about 1.44× a step, in the reference too.  The
    port follows the reference's growth over 30 steps (max|u| from 1.10
    to ~40)."""
    sim = _session(100, 50, solver_type="projection")
    jsim = JSimulation.create(100, 50, solver_type="projection")
    _run_both(sim, jsim, 30)
    vmax = sim.get_stats().max_velocity
    assert vmax > 10.0
    assert vmax == pytest.approx(jsim.get_stats().max_velocity, rel=1e-9)
    np.testing.assert_allclose(sim.field.u.numpy(), np.asarray(jsim.field.u),
                               rtol=0, atol=1e-9 * vmax)


def test_registry_matches_reference():
    reg, jreg = create_registry(), j_create_registry()
    assert reg.list() == jreg.list()
    assert len(reg.list()) == 18
    for name in reg.list():
        assert int(infer_backend(name)) == int(j_infer_backend(name)), name
        assert reg.describe(name) == jreg.describe(name), name
        solver, jsolver = reg.create(name), jreg.create(name)
        assert (solver.method, int(solver.poisson_method),
                int(solver.capabilities)) == (
            jsolver.method, int(jsolver.poisson_method),
            int(jsolver.capabilities)), name
    for b in Backend:
        assert reg.list_by_backend(b) == jreg.list_by_backend(int(b))
    assert list_solvers() == j_list_solvers()
    assert [has_solver(n) for n in ("rk4", "projection", "x")] == [
        j_has_solver(n) for n in ("rk4", "projection", "x")]


def test_unknown_name_and_checked_create():
    reg = create_registry(device="cpu")
    assert reg.create("no_such_solver") is None
    assert get_last_status() == Status.ERROR_NOT_FOUND
    assert "no_such_solver" in get_last_error()
    assert reg.has("rk4") and not reg.has("no_such_solver")
    # a CUDA-tagged name needs a CUDA device; the others never do
    gpu = reg.create_checked("rk4_gpu")
    assert (gpu is not None) == torch.cuda.is_available()
    assert reg.create_checked("rk4_omp").name == "rk4_omp"
    with pytest.raises(CFDError) as err:
        _session(solver_type="no_such_solver")
    assert err.value.status == Status.ERROR_NOT_FOUND
    assert reg.register("", None) == -1 and reg.unregister("nope") == -1
    assert SolverRegistry().list() == []


@pytest.mark.parametrize("name", create_registry().list())
def test_every_name_inits_and_steps(name):
    """Each of the 18 registered names inits on a 2^k+1 grid (which
    multigrid needs) and takes a step on the CPU, as the reference's."""
    solver = create_registry(device="cpu", dtype=torch.float64).create(name)
    jsolver = j_create_registry().create(name)
    grid, jgrid = Grid.uniform(17, 17), JGrid.uniform(17, 17)
    assert solver.init(grid, NSParams()) == Status.SUCCESS
    jsolver.init(jgrid, JParams())
    f = FlowField.initialize(grid, dtype=torch.float64, device="cpu")
    out, stats = solver.step(f)
    jout, jstats = jsolver.step(JField.initialize(jgrid))
    assert stats.status == jstats.status == Status.SUCCESS
    np.testing.assert_allclose(field_to_numpy(out)["u"],
                               np.asarray(jout.u), rtol=0, atol=1e-10)


def test_projection_multigrid_session():
    """``Simulation.create(33, 33, solver_type="projection_multigrid")``:
    ten ``step()``s and a ``solve()`` against the reference's session
    (the facade's dt = 0.005 is inside the viscous limit at 33²)."""
    sim = _session(33, 33, solver_type="projection_multigrid")
    jsim = JSimulation.create(33, 33, solver_type="projection_multigrid")
    _run_both(sim, jsim, 10)
    _assert_sessions_close(sim, jsim)
    assert sim.solve() == jsim.solve() == Status.SUCCESS
    _assert_sessions_close(sim, jsim)


def test_projection_multigrid_needs_a_coarsenable_grid():
    """On a grid that cannot be coarsened the name creates a solver whose
    init raises unsupported, as the reference's."""
    solver = create_registry(device="cpu").create("projection_multigrid")
    assert solver is not None and solver.method == "projection"
    with pytest.raises(CFDError) as err:
        solver.init(Grid.uniform(32, 16), NSParams())
    assert err.value.status == Status.ERROR_UNSUPPORTED
    with pytest.raises(CFDError):
        _session(solver_type="projection_multigrid")


@pytest.mark.parametrize("call", [
    lambda s: s.register_output(0, 1), lambda s: s.write_outputs(0),
    lambda s: s.save_checkpoint("x"), lambda s: s.restore_checkpoint("x"),
    lambda s: Simulation.load_checkpoint("x")],
    ids=["register_output", "write_outputs", "save_checkpoint",
         "restore_checkpoint", "load_checkpoint"])
def test_outputs_and_checkpoints_are_not_ported(call):
    with pytest.raises(CFDError) as err:
        call(_session())
    assert err.value.status == Status.ERROR_UNSUPPORTED


@pytest.mark.nan_injection
@pytest.mark.parametrize("method", ["explicit_euler", "rk2", "rk4"])
def test_solve_freezes_after_divergence(method):
    """A NaN in u: the first guarded step reports −6 and the later ones
    are not applied (one iteration counted), as in the reference."""
    grid, jgrid = Grid.uniform(24, 20), JGrid.uniform(24, 20)
    params = dict(max_iter=4)
    solver = NSSolver(name=method, method=method, device="cpu",
                      dtype=torch.float64)
    solver.init(grid, NSParams(**params))
    jsolver = JSolver(name=method, method=method)
    jsolver.init(jgrid, JParams(**params))
    arrays = {n: np.asarray(getattr(JField.initialize(jgrid), n))
              for n in NAMES}
    arrays["u"] = arrays["u"].copy()
    arrays["u"][0, 7, 9] = np.nan
    _, stats = solver.solve(field_from_numpy(arrays, "cpu", torch.float64),
                            1e-3)
    _, jstats = jsolver.solve(JField(**{n: jnp.asarray(a)
                                        for n, a in arrays.items()}), 1e-3)
    assert stats.status == jstats.status == Status.ERROR_DIVERGED
    assert stats.iterations == jstats.iterations == 1


def test_compute_dt_and_apply_boundary_match_reference():
    grid, jgrid = Grid.uniform(24, 20, 6, zmin=0.0, zmax=1.0), \
        JGrid.uniform(24, 20, 6, zmin=0.0, zmax=1.0)
    solver = NSSolver(name="rk2", method="rk2", device="cpu",
                      dtype=torch.float64)
    solver.init(grid, NSParams())
    jsolver = JSolver(name="rk2", method="rk2")
    jsolver.init(jgrid, JParams())
    field = FlowField.initialize(grid, dtype=torch.float64, device="cpu")
    jfield = JField.initialize(jgrid)
    assert solver.compute_dt(field) == pytest.approx(
        jsolver.compute_dt(jfield), rel=1e-14)
    wrapped = field_to_numpy(solver.apply_boundary(field))
    jwrapped = jsolver.apply_boundary(jfield)
    for n in NAMES:
        np.testing.assert_array_equal(wrapped[n],
                                      np.asarray(getattr(jwrapped, n)))
    # the device-side step: 0-d tensors, no stats
    stepped, res = solver.step_result(field, 1e-3, 2)
    jstepped, jres = jsolver.step_result(jfield, 1e-3, 2)
    assert torch.is_tensor(res.status) and int(res.status) == 0
    np.testing.assert_allclose(stepped.u.numpy(), np.asarray(jstepped.u),
                               rtol=0, atol=1e-10)
    assert float(res.max_velocity) == pytest.approx(
        float(jres.max_velocity), rel=1e-12)
