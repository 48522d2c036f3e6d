"""The (z, y)-decomposed projection step (`cfd_tpu_torch.parallel.fused`
on a (Pz, Py) mesh with Py > 1, plain versions on `LocalComm` CPU
shards) against the reference's, and its refusals, on the CPU.

* FFT_DIRECT over (2, 4) at 128×32×8 float32, one step, against the
  reference's (z, y) step (``make_sharded_step`` on its 8 virtual
  devices, interpret mode) and its one-device step: u, v, w within 5e-6,
  p within 5e-5 (`tests/parallel/test_fused_sharded.py:855-882`);
* ``spectral_precision="high"``: p within 2e-4·max|p| of the
  one-device HIGHEST step, and off the sharded HIGHEST step (it reached
  the 3xTF32 products; `:967-994`);
* float64 over (2, 2), (1, 4) and (4, 2), three steps: the port's
  one-device plain FFT_DIRECT step within 1e-12 on u, v, w and 1e-10 on
  p (the dense z stage and the Thomas solve, both exact to rounding);
* ``make_mesh([cpu] * 4)`` with its default axes — the (2, 2) mesh
  every 4-card machine gets — builds and steps FFT_DIRECT and CG, and so
  does ``NSSolver(method="projection", mesh=…)``;
* every (z, y) configuration outside the slice raises
  ``ERROR_UNSUPPORTED`` with its reason: a preconditioned BiCGSTAB (the
  (z, y) BiCGSTAB itself runs, `tests/test_torch_parallel_bicgstab_zy.py`),
  a heat source, a NOSLIP thermal face (``ERROR_INVALID``; energy and
  buoyancy run, `tests/test_torch_parallel_thermal*.py`), the consistent
  scheme, custom sources, ``nx % Pz !=
  0`` (the two-axis pencil fallback), a y count that does not divide ny,
  a 2D grid (its step needs a y-only mesh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.parallel import make_sharded_step as j_make_sharded_step
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_projection_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import Grid, Status
from cfd_tpu_torch.boundary.types import BCType, ThermalBCConfig
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import (gather_field, make_mesh,
                                    make_sharded_raw_step, make_sharded_step)
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.solver import NSSolver
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                Precond)

from tests.test_torch_parallel_step import random_arrays

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
SHAPE = (8, 32, 128)               # (nz, ny, nx): 4 planes, 8 rows a shard


@pytest.fixture(scope="module")
def reference():
    """The reference's (z, y) step over (2, 4), its one-device FFT_DIRECT
    step, and the same start field, float32, one step of dt = 1e-3."""
    jgrid = JGrid.uniform(128, 32, 8, zmin=0.0, zmax=1.0)
    arrays = random_arrays(SHAPE, seed=41)
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("z", "y"))
    jstep, jplace = j_make_sharded_step(jgrid, JParams(), jmesh,
                                        "projection", use_pallas=True,
                                        strict=True, dtype=jnp.float32)
    zy, zy_res = jstep(jplace(jf), 0.001, 0)
    single, _ = jax.jit(j_make_projection_step(
        jgrid, JParams(), dtype=jnp.float32,
        poisson_method=JMethod.FFT_DIRECT))(jf, 0.001, 0)
    return grid_from(jgrid), arrays, zy, int(zy_res.status), single


def _step(grid, mesh, **kw):
    step, place = make_sharded_step(grid, NSParams(), mesh, "projection",
                                    **kw)
    return step, place


def _hold(g, ref, atol_uvw, atol_p):
    for n in "uvw":
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(ref, n)), rtol=0,
                                   atol=atol_uvw, err_msg=n)
    np.testing.assert_allclose(g.p.numpy(), np.asarray(ref.p), rtol=0,
                               atol=atol_p, err_msg="p")


def test_fft_step_matches_reference_zy_and_single_device(reference):
    grid, arrays, zy, zy_status, single = reference
    step, place = _step(grid, make_mesh([CPU] * 8, shape=(2, 4)),
                        dtype=torch.float32)
    fs, res = step(place(field_from_numpy(arrays, device="cpu")), 0.001, 0)
    assert int(res.status) == zy_status == 0
    g = gather_field(fs)
    _hold(g, zy, 5e-6, 5e-5)
    _hold(g, single, 5e-6, 5e-5)
    # the diagnostics: the maxima of the gathered field
    vmax, pmax, _ = g.diagnostics()
    assert float(res.max_velocity) == float(vmax)
    assert float(res.max_pressure) == float(pmax)


def test_high_precision_reaches_the_products(reference):
    grid, arrays, _, _, single = reference
    f = field_from_numpy(arrays, device="cpu")
    mesh = make_mesh([CPU] * 8, shape=(2, 4))
    outs = {}
    for prec in (None, "high"):
        step, place = _step(grid, mesh, dtype=torch.float32,
                            spectral_precision=prec)
        fs, res = step(place(f), 0.001, 0)
        assert int(res.status) == 0
        outs[prec] = gather_field(fs).p.numpy()
    ref_p = np.asarray(single.p)
    scale = np.abs(ref_p).max()
    assert np.abs(outs["high"] - ref_p).max() / scale < 2e-4
    assert np.abs(outs["high"] - outs[None]).max() > 0.0


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 2)], ids=str)
def test_float64_equals_the_one_device_plain_step(shape):
    grid = Grid.uniform(24, 16, 8, zmin=0.0, zmax=1.0)
    f = field_from_numpy(random_arrays(grid.shape, 3, np.float64),
                         device="cpu", dtype=torch.float64)
    step, place = _step(grid, make_mesh([CPU] * (shape[0] * shape[1]),
                                        shape=shape), dtype=torch.float64)
    single = make_projection_step(grid, NSParams(), torch.float64,
                                  Method.FFT_DIRECT, device="cpu")
    fs, f1 = place(f), f
    for it in range(3):
        fs, rs = step(fs, 1e-3, it)
        f1, r1 = single(f1, 1e-3, it)
    g = gather_field(fs)
    assert int(rs.status) == int(r1.status) == 0
    for n in "uvw":
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   getattr(f1, n).numpy(), rtol=0,
                                   atol=1e-12, err_msg=n)
    np.testing.assert_allclose(g.p.numpy(), f1.p.numpy(), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("method", [Method.FFT_DIRECT, Method.CG],
                         ids=["fft_direct", "cg"])
def test_default_mesh_and_solver_build_and_step(method):
    """``make_mesh`` of four devices is (2, 2): the step, and the solver
    on it, equal the one-device plain step in float64."""
    grid = Grid.uniform(24, 16, 8, zmin=0.0, zmax=1.0)
    mesh = make_mesh([CPU] * 4)
    assert mesh.shape == {"z": 2, "y": 2}
    f = field_from_numpy(random_arrays(grid.shape, 5, np.float64),
                         device="cpu", dtype=torch.float64)
    pp = PoissonParams(tolerance=1e-10) if method == Method.CG else None
    kw = {"poisson_params": pp} if pp else {}
    step, place = make_sharded_step(grid, NSParams(), mesh,
                                    dtype=torch.float64,
                                    poisson_method=method, **kw)
    fs, res = step(place(f), 1e-3, 0)
    f1, _ = make_projection_step(grid, NSParams(), torch.float64, method,
                                 device="cpu", **kw)(f, 1e-3, 0)
    assert int(res.status) == 0
    np.testing.assert_allclose(gather_field(fs).u.numpy(), f1.u.numpy(),
                               rtol=0, atol=1e-12)
    solver = NSSolver(name="p", method="projection", dtype=torch.float64,
                      poisson_method=method, mesh=mesh, device="cpu",
                      **({"poisson_params": pp} if pp else {}))
    solver.init(grid, NSParams())
    sf, sres = solver.step(solver.place(f), 1e-3, 0)
    assert int(sres.status) == 0
    np.testing.assert_allclose(gather_field(sf).u.numpy(), f1.u.numpy(),
                               rtol=0, atol=1e-12)


def _uniform(nx=24, ny=16, nz=8):
    return Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0)


def _mesh4():
    return make_mesh([CPU] * 4)


REFUSALS = {
    # BiCGSTAB runs on a (z, y) mesh; a preconditioner is refused there
    # as on a z mesh (the reference's sharded solve is unpreconditioned)
    "bicgstab": (lambda: (_uniform(), NSParams(), _mesh4(),
                          {"poisson_method": Method.BICGSTAB,
                           "poisson_params": PoissonParams(
                               preconditioner=Precond.JACOBI)}),
                 "BiCGSTAB kernel build failed"),
    # energy and buoyancy run (tests/test_torch_parallel_thermal*.py);
    # a heat source and a face the energy step has no rule for do not
    "energy": (lambda: (_uniform(), NSParams(
        alpha=1e-3, heat_source_func=lambda *a: 0.0), _mesh4(), {}),
        "a heat_source callable is not ported yet"),
    "buoyancy": (lambda: (_uniform(), NSParams(
        alpha=1e-3, beta=3e-3, gravity=(0.0, -9.81, 0.0),
        thermal_bc=ThermalBCConfig(back=BCType.NOSLIP)), _mesh4(), {}),
        "only PERIODIC, NEUMANN, DIRICHLET are valid", Status.ERROR_INVALID),
    "consistent": (lambda: (Grid.stretched(24, 16, 8, zmin=0.0, zmax=1.0,
                                           beta=1.5),
                            NSParams(nonuniform_scheme="consistent"),
                            _mesh4(), {}),
                   "consistent-scheme fused sharded projection needs a "
                   "z-only mesh"),
    "custom sources": (lambda: (_uniform(), NSParams(
        source_func=lambda *a: a), _mesh4(), {}),
        "custom source callables"),
    "pencil fallback": (lambda: (_uniform(nx=25), NSParams(), _mesh4(),
                                 {}), "two-axis pencil DST path (nx=25 not "
                                      "divisible by 2 z-shards) is not "
                                      "ported yet"),
    "ny not divisible": (lambda: (_uniform(ny=15), NSParams(), _mesh4(),
                                  {"poisson_method": Method.CG}),
                         "ny=15 must be divisible by 2 y-shards"),
    "2d": (lambda: (Grid.uniform(24, 16), NSParams(), _mesh4(), {}),
           "fused sharded 2D projection needs a y-only mesh"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_zy_outside_the_slice_raises_with_its_reason(case):
    build, reason, *status = REFUSALS[case]
    grid, params, mesh, kw = build()
    for maker in (make_sharded_step, make_sharded_raw_step):
        with pytest.raises(CFDError) as err:
            maker(grid, params, mesh, "projection", **dict(kw))
        assert err.value.status == (status or [Status.ERROR_UNSUPPORTED])[0]
        assert reason in str(err.value)
