"""The (z, y)-decomposed BiCGSTAB solve and step (`cfd_tpu_torch.parallel.
fused_bicgstab` with Py > 1, ``make_sharded_step(..., poisson_method=
Method.BICGSTAB)`` and ``NSSolver(mesh=)`` on a (Pz, Py) mesh; plain
versions on `LocalComm` CPU shards).

* Against the reference's (z, y) BiCGSTAB step — its own case
  (`tests/parallel/test_fused_bicgstab_sharded.py:170-200`): 128×32×8
  over (2, 4), tolerance 1e-5, at that test's bars: status 0 on both,
  u, v, w within 1e-4, p within 5e-2 after removing the mean (two
  BiCGSTAB trajectories agree on p only to tol·κ; the corrector sees
  ∇p).
* In float64, against the single-device BiCGSTAB step on (2, 2), (1, 4)
  and (4, 2) meshes at 16×16×8, a smooth start whose solve converges in
  26 iterations at tolerance 1e-8: the same count, fields within 1e-10,
  the solve's recursion residual (2e-5) within 1e-9 (over longer runs
  BiCGSTAB's float64 trajectories part with the summation order, ROADMAP
  §C); the solve alone (`make_bicgstab_fused_sharded`) on (2, 2) against
  the single-device solve, from zero on a smooth rhs, at the same bars.
* The facade: ``NSSolver(method="projection", poisson_method=BICGSTAB,
  mesh=)`` on a (2, 2) mesh against the single-device solver, float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.parallel import make_mesh as j_make_mesh
from cfd_tpu.parallel import make_sharded_step as j_make_sharded_step
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPParams
from cfd_tpu_torch.core.grid import Grid
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import (gather_field, make_bicgstab_fused_sharded,
                                    make_mesh, make_sharded_step)
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.solver import NSSolver
from cfd_tpu_torch.solvers.poisson import krylov
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem)

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
NAMES = ("u", "v", "w", "p", "rho", "T")
MESHES = [(2, 2), (1, 4), (4, 2)]


def test_zy_step_matches_reference_zy_bicgstab_step():
    jgrid = JGrid.uniform(128, 32, 8, zmin=0.0, zmax=1.0)
    rng = np.random.default_rng(37)
    jf = JField.initialize(jgrid, dtype=jnp.float32)
    jf = jf.replace(**{n: jnp.asarray(rng.normal(0, .1, jgrid.shape),
                                      jnp.float32) for n in "uvw"})
    jstep, jplace = j_make_sharded_step(
        jgrid, JParams(), j_make_mesh(jax.devices()[:8]), "projection",
        use_pallas=True, strict=True, dtype=jnp.float32,
        poisson_method=JMethod.BICGSTAB,
        poisson_params=JPParams(tolerance=1e-5, max_iterations=800))
    step, place = make_sharded_step(
        grid_from(jgrid), NSParams(), make_mesh([CPU] * 8, shape=(2, 4)),
        "projection", dtype=torch.float32, poisson_method=Method.BICGSTAB,
        poisson_params=PoissonParams(tolerance=1e-5, max_iterations=800))
    jout, jres = jstep(jplace(jf), 1e-3, 0)
    out, res = step(place(field_from_numpy(
        {n: np.asarray(getattr(jf, n)) for n in NAMES}, "cpu",
        torch.float32)), 1e-3, 0)
    assert int(res.status) == int(jres.status) == 0
    g = gather_field(out)
    for n in "uvw":
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jout, n)), rtol=0,
                                   atol=1e-4, err_msg=n)
    dp = g.p.numpy() - np.asarray(jout.p)
    np.testing.assert_allclose(dp - dp[1:-1, 1:-1, 1:-1].mean(), 0.0,
                               atol=5e-2)


def _smooth_field(grid):
    """A divergent smooth start (the solve then converges in 26
    iterations at tolerance 1e-8)."""
    nz, ny, nx = grid.shape
    z, y, x = np.meshgrid(np.linspace(0, 1, nz), np.linspace(0, 1, ny),
                          np.linspace(0, 1, nx), indexing="ij")
    s = np.sin
    arrays = {"u": 0.1 * s(np.pi * x) * np.cos(np.pi * y) * s(np.pi * z),
              "v": -0.1 * np.cos(np.pi * x) * s(np.pi * y) * s(np.pi * z),
              "w": 0.05 * s(2 * np.pi * x) * s(np.pi * z),
              "p": np.zeros(grid.shape), "rho": np.ones(grid.shape),
              "T": np.full(grid.shape, 300.0)}
    return field_from_numpy(arrays, "cpu", torch.float64)


PP = PoissonParams(tolerance=1e-8, max_iterations=400)


@pytest.mark.parametrize("shape", MESHES, ids=["2x2", "1x4", "4x2"])
def test_zy_float64_step_matches_single_device(shape):
    grid = Grid.uniform(16, 16, 8, zmin=0.0, zmax=1.0)
    f = _smooth_field(grid)
    ref = make_projection_step(grid, NSParams(), torch.float64,
                               Method.BICGSTAB, poisson_params=PP,
                               device="cpu")
    mesh = make_mesh([CPU] * (shape[0] * shape[1]), shape=shape)
    step, place = make_sharded_step(grid, NSParams(), mesh, "projection",
                                    dtype=torch.float64,
                                    poisson_method=Method.BICGSTAB,
                                    poisson_params=PP)
    fr, rr = ref(f, 1e-3, 0)
    fs, rs = step(place(f), 1e-3, 0)
    assert int(rs.status) == int(rr.status) == 0
    assert int(step.last_poisson.iterations) == int(
        ref.last_poisson.iterations) == 26
    g = gather_field(fs)
    for n in NAMES:
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   getattr(fr, n).numpy(), rtol=0,
                                   atol=1e-10, err_msg=n)
    # the recursion residual (2e-5) carries the shards' summation order:
    # 8e-11 apart
    np.testing.assert_allclose(float(rs.residual), float(rr.residual),
                               rtol=0, atol=1e-9)


def test_zy_float64_solve_matches_single_device():
    prob = PoissonProblem(16, 16, 8, 1.0 / 15, 1.0 / 15, 1.0 / 7)
    rhs = np.zeros((8, 16, 16))
    z, y, x = np.meshgrid(*(np.linspace(0, 1, n) for n in (8, 16, 16)),
                          indexing="ij")
    rhs[1:-1, 1:-1, 1:-1] = (np.sin(2 * np.pi * x) * np.sin(np.pi * y)
                             * np.cos(np.pi * z))[1:-1, 1:-1, 1:-1]
    x0 = torch.zeros(8, 16, 16, dtype=torch.float64)
    one = krylov.make_bicgstab_fused(prob, PP, device="cpu")(
        x0, torch.from_numpy(rhs))
    res = make_bicgstab_fused_sharded(prob, PP, make_mesh([CPU] * 4))(
        x0, torch.from_numpy(rhs))
    assert int(res.status) == int(one.status) == 0
    assert int(res.iterations) == int(one.iterations) <= 30
    np.testing.assert_allclose(res.x.numpy(), one.x.numpy(), rtol=0,
                               atol=1e-10)


def test_nssolver_bicgstab_on_zy_mesh_matches_single_device():
    grid = Grid.uniform(16, 16, 8, zmin=0.0, zmax=1.0)
    f = _smooth_field(grid)
    kw = dict(name="p", method="projection", poisson_method=Method.BICGSTAB,
              poisson_params=PP, device="cpu", dtype=torch.float64)
    single, sharded = NSSolver(**kw), NSSolver(**kw, mesh=make_mesh(
        [CPU] * 4))
    for s in (single, sharded):
        s.init(grid, NSParams())
    f1, st1 = single.step(f, 1e-3)
    f2, st2 = sharded.step(sharded.place(f), 1e-3)
    assert int(st1.status) == int(st2.status) == 0
    g = f2.gather()
    for n in NAMES:
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   getattr(f1, n).numpy(), rtol=0,
                                   atol=1e-10, err_msg=n)
    for a in ("max_velocity", "max_pressure"):
        np.testing.assert_allclose(getattr(st2, a), getattr(st1, a),
                                   rtol=1e-9, err_msg=a)
    np.testing.assert_allclose(st2.residual, st1.residual, rtol=0,
                               atol=1e-9)
