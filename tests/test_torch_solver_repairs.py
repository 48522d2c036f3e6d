"""Two repaired faults of the port, against the reference on the CPU.

* C1: `NSSolver` lets every pressure solve `make_projection_step` builds
  through, as the reference's ``init`` does (`cfd_tpu/solvers/ns/
  solver.py:106-111`): BiCGSTAB, Red-Black SOR and Jacobi ``init`` and
  ``step`` through `NSSolver` and through `Simulation.set_solver`, and
  match the reference's facade in float64 at 17² and 9³.
* C2: a float64 step is the plain step — the reference gates only its
  kernels on float32 and runs its jnp body otherwise — so it reaches no
  kernel wrapper: the wrappers' device test (`native.on_cpu`, which every
  wrapper calls first) is never called, and no launch counter moves,
  while a float32 step on the CPU goes through the wrappers.  (The same
  float64 steps on CUDA are held against the CPU plain step at 1e-12 by
  ``chip_smoke.py`` phase 44.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.api import Simulation as JSimulation
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.solver import NSSolver as JSolver
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import Grid, Status
from cfd_tpu_torch.api import Simulation
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.ops.kernels import native
from cfd_tpu_torch.ops.kernels import projection_kernels as pkm
from cfd_tpu_torch.solvers.ns.euler import make_euler_step
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.rk import make_rk2_step
from cfd_tpu_torch.solvers.ns.solver import NSSolver
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")
METHODS = (Method.BICGSTAB, Method.REDBLACK_SOR, Method.JACOBI)
SHAPES = ((17, 17, 1), (9, 9, 9))
ATOL = 1e-10     # float64, the same iterations on both sides


def _grids(nx, ny, nz):
    if nz == 1:
        return Grid.uniform(nx, ny), JGrid.uniform(nx, ny)
    return (Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0),
            JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0))


def _assert_fields_close(out, jfield):
    for n in NAMES:
        np.testing.assert_allclose(out[n], np.asarray(getattr(jfield, n)),
                                   rtol=0, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("shape", SHAPES, ids=["17x17", "9x9x9"])
@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
def test_nssolver_takes_every_projection_method(method, shape):
    """C1: init and two steps through NSSolver, against the reference."""
    grid, jgrid = _grids(*shape)
    solver = NSSolver(name="p", method="projection", poisson_method=method,
                      device="cpu", dtype=torch.float64)
    jsolver = JSolver(name="p", method="projection",
                      poisson_method=JMethod(int(method)))
    assert solver.init(grid, NSParams()) == Status.SUCCESS
    jsolver.init(jgrid, JParams())
    jf = JField.initialize(jgrid, dtype=jnp.float64)
    f = field_from_numpy({n: getattr(jf, n) for n in NAMES}, "cpu",
                         torch.float64)
    for _ in range(2):
        f, stats = solver.step(f, 1e-3)
        jf, jstats = jsolver.step(jf, 1e-3)
    _assert_fields_close(field_to_numpy(f), jf)
    assert int(stats.status) == int(jstats.status)
    assert stats.iterations == jstats.iterations
    for a in ("max_velocity", "max_pressure"):
        np.testing.assert_allclose(getattr(stats, a), getattr(jstats, a),
                                   rtol=1e-9, atol=1e-12, err_msg=a)
    # the final residual is a norm of the converged solve's cancelling
    # residual vector (BiCGSTAB's 6e-4 at 17² from fields equal to 2e-13),
    # summed in another order on each side: 1e-6 relative
    np.testing.assert_allclose(stats.residual, jstats.residual, rtol=1e-6,
                               err_msg="residual")


@pytest.mark.parametrize("shape", SHAPES, ids=["17x17", "9x9x9"])
@pytest.mark.parametrize("method", METHODS, ids=lambda m: m.name)
def test_set_solver_takes_every_projection_method(method, shape):
    """C1: the same solvers through ``Simulation.set_solver``."""
    nx, ny, nz = shape
    zmax = 1.0 if nz > 1 else 0.0
    sim = Simulation.create(nx, ny, nz, zmax=zmax, device="cpu",
                            dtype=torch.float64)
    jsim = JSimulation.create(nx, ny, nz, zmax=zmax)
    sim.set_solver(NSSolver(name="p", method="projection",
                            poisson_method=method, device="cpu",
                            dtype=torch.float64))
    jsim.set_solver(JSolver(name="p", method="projection",
                            poisson_method=JMethod(int(method))))
    assert sim.step() == jsim.step()
    _assert_fields_close(field_to_numpy(sim.field), jsim.field)
    assert sim.get_stats().iterations == jsim.get_stats().iterations


def _steps_float64():
    grid = Grid.uniform(17, 9, 9, zmin=0.0, zmax=1.0)
    return grid, {
        "fft_direct": lambda dt: make_projection_step(
            grid, NSParams(), dt, Method.FFT_DIRECT, device="cpu"),
        "cg": lambda dt: make_projection_step(grid, NSParams(), dt,
                                              Method.CG, device="cpu"),
        "euler": lambda dt: make_euler_step(grid, NSParams(), dt, "cpu"),
        "rk2": lambda dt: make_rk2_step(grid, NSParams(), dt, "cpu")}


@pytest.mark.parametrize("name", ["fft_direct", "cg", "euler", "rk2"])
def test_float64_step_reaches_no_kernel_wrapper(name, monkeypatch):
    """C2: a float64 step runs the plain versions without entering a
    kernel wrapper; the float32 step (the control) enters them."""
    from cfd_tpu_torch import FlowField

    grid, makers = _steps_float64()
    calls = []
    real_on_cpu = native.on_cpu

    def spy(t):
        calls.append(t.dtype)
        return real_on_cpu(t)

    monkeypatch.setattr(native, "on_cpu", spy)
    pkm.reset_launch_counts()
    for dtype, expect_wrappers in ((torch.float64, False),
                                   (torch.float32, True)):
        calls.clear()
        step = makers[name](dtype)
        f = FlowField.initialize(grid, dtype=dtype, device="cpu")
        f, res = step(f, 1e-4, 0)
        assert int(res.status) == 0 and bool(f.is_finite())
        assert bool(calls) == expect_wrappers, (dtype, len(calls))
    counts = [getattr(w, a, 0) for w in pkm.WRAPPERS + pkm.WRAPPERS_HIGH
              for a in ("launches", "consistent_launches",
                        "global_nz_launches")]
    assert not any(counts)
