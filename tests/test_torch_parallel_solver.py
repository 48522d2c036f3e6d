"""`NSSolver.mesh` and `NSSolver.place` (`cfd_tpu/solvers/ns/solver.py:83`,
`:97-105`): a projection solver with the FFT_DIRECT pressure solve on a
z mesh of four CPU shards ``init``s through `make_sharded_raw_step`,
``place``s a field as a `ShardedField`, and ``step``s and ``solve``s on
it — against the reference's ``NSSolver(mesh=…)`` on four virtual devices
at its sharded bars, atol 5e-6 on u, v, w and 5e-5 on p
(`tests/parallel/test_fused_sharded.py:58-64`).  Outside the slice (the
multigrid solve on a grid that is not coarsenable) ``init`` raises
``ERROR_UNSUPPORTED``, and on a 2^k+1 grid the same solver builds and
steps; the default CG solve on a mesh is held in
`tests/test_torch_parallel_cg.py`, the multigrid step against the
reference in `tests/test_torch_parallel_mg.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.parallel.mesh import make_mesh as j_make_mesh
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.solver import NSSolver as JSolver
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import Status
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import ShardedField, make_mesh
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.solver import NSSolver
from cfd_tpu_torch.solvers.poisson.base import Method

from tests.test_torch_parallel_step import assert_close, random_arrays

torch.set_num_threads(min(2, torch.get_num_threads()))

P = 4
CPU = torch.device("cpu")


def _pair(max_iter=3):
    jgrid = JGrid.uniform(64, 16, 8, zmin=0.0, zmax=1.0)
    solver = NSSolver(name="p", method="projection",
                      poisson_method=Method.FFT_DIRECT, dtype=torch.float32,
                      mesh=make_mesh([CPU] * P, axes=("z",)))
    jsolver = JSolver(name="p", method="projection",
                      poisson_method=JMethod.FFT_DIRECT,
                      mesh=j_make_mesh(jax.devices()[:P], axes=("z",)))
    assert solver.init(grid_from(jgrid), NSParams(max_iter=max_iter)) \
        == Status.SUCCESS
    jsolver.init(jgrid, JParams(max_iter=max_iter))
    arrays = random_arrays(jgrid.shape, seed=31)
    f = solver.place(field_from_numpy(arrays, "cpu", torch.float32))
    jf = jsolver.place(JField(**{n: jnp.asarray(a)
                                 for n, a in arrays.items()}))
    return solver, jsolver, f, jf


def test_solver_on_a_mesh_steps_like_the_reference():
    solver, jsolver, f, jf = _pair()
    assert isinstance(f, ShardedField) and len(f.blocks) == P
    for _ in range(2):
        f, stats = solver.step(f, 1e-3)
        jf, jstats = jsolver.step(jf, 1e-3)
    assert isinstance(f, ShardedField)
    assert stats.status == jstats.status == Status.SUCCESS
    assert_close(f, jf, 5e-6, 5e-5)
    np.testing.assert_allclose(stats.max_velocity, jstats.max_velocity,
                               rtol=1e-6)


def test_solver_on_a_mesh_solves_like_the_reference():
    solver, jsolver, f, jf = _pair(max_iter=3)
    f, stats = solver.solve(f, 1e-3)
    jf, jstats = jsolver.solve(jf, 1e-3)
    assert stats.iterations == jstats.iterations == 3
    assert stats.status == jstats.status == Status.SUCCESS
    assert_close(f, jf, 5e-6, 5e-5)
    np.testing.assert_allclose(stats.max_pressure, jstats.max_pressure,
                               rtol=1e-5)


def test_solver_on_a_mesh_refuses_what_is_not_ported():
    solver = NSSolver(name="p", method="projection",
                      poisson_method=Method.MULTIGRID,
                      mesh=make_mesh([CPU] * 2, axes=("z",)))
    grid = grid_from(JGrid.uniform(32, 16, 8, zmin=0.0, zmax=1.0))
    with pytest.raises(CFDError) as err:
        solver.init(grid, NSParams())     # not a 2^k+1 grid
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert "coarsenable" in str(err.value)
    coarsenable = grid_from(JGrid.uniform(17, 17, 17, zmin=0.0, zmax=1.0))
    assert solver.init(coarsenable, NSParams()) == Status.SUCCESS
    f, stats = solver.step(solver.place(field_from_numpy(
        random_arrays(coarsenable.shape, seed=3), "cpu", torch.float32)),
        1e-3)
    assert isinstance(f, ShardedField)
    assert stats.status == Status.SUCCESS
    plain = NSSolver(name="p", method="projection",
                     poisson_method=Method.FFT_DIRECT, device="cpu")
    plain.init(grid, NSParams())
    f = object()
    assert plain.place(f) is f


def test_solve_on_a_mesh_freezes_after_divergence():
    """A NaN on one shard reaches every shard's status through the
    folded maxima: the step reports DIVERGED (−6), as the single-device
    step does, and the guarded solve stops there, as the single-device
    one: the failing step is applied and counted, no later one."""
    solver, _, f, _ = _pair(max_iter=4)
    single = NSSolver(name="p", method="projection",
                      poisson_method=Method.FFT_DIRECT, dtype=torch.float32,
                      device="cpu")
    single.init(solver.grid, solver.params)
    whole = f.gather()
    bad = whole.replace(u=whole.u.clone())
    bad.u[5, 3, 7] = float("nan")           # on shard 2 of 4 (planes 4-5)
    _, stats = solver.step(solver.place(bad), 1e-3)
    _, stats1 = single.step(bad, 1e-3)
    assert stats.status == stats1.status == Status.ERROR_DIVERGED
    out, stats = solver.solve(solver.place(bad), 1e-3)
    out1, stats1 = single.solve(bad, 1e-3)
    assert stats.iterations == stats1.iterations == 1
    assert stats.status == stats1.status == Status.ERROR_DIVERGED
    g = out.gather()
    for n in ("u", "v", "w", "p"):
        assert torch.equal(torch.isnan(getattr(g, n)),
                           torch.isnan(getattr(out1, n))), n
