"""The z-decomposed CG solve and step (`cfd_tpu_torch.parallel.fused_cg`,
``make_sharded_step(..., poisson_method=Method.CG)``, plain versions on
`LocalComm` CPU shards) against the reference's
``make_cg_fused_sharded`` and CG-backed sharded step on a z mesh of P of
the 8 virtual devices, its kernels in interpret mode.

* The solve at 128×16×16 float32, tolerance 1e-3 (the reference's
  `tests/parallel/test_fused_cg_sharded.py:55-96`): status 0, equal
  iteration counts, the initial residual at rtol 1e-5, x within 2e-5.
* Float64, the plain sharded CG against the reference's jnp ``make_cg``
  over 30 iterations at ``check_interval = 30``: equal counts, x within
  1e-10, from a zero and from a random start (shells kept).
* The step (`:99-132`): u, v, w within 1e-4, p within 2e-3, status 0;
  −7 from both when the solve stops at its iteration cap.
* Fault C3: the reference's keywords ``strict``, ``use_pallas``,
  ``use_pallas_cg`` and ``pallas_interpret`` build the same step.
* ``NSSolver(mesh=…)`` with its default CG inits and steps like the
  single-device ``NSSolver`` (float64, 1e-10); the refusals that remain.
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
from cfd_tpu.parallel.fused_cg import \
    make_cg_fused_sharded as j_make_cg_fused_sharded
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.krylov import make_cg as j_make_cg
from cfd_tpu_torch import Status
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import (ShardedField,
                                    cg_fused_sharded_unsupported_reason,
                                    gather_field, make_cg_fused_sharded,
                                    make_mesh, make_sharded_raw_step,
                                    make_sharded_step)
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.solver import NSSolver
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem, Precond)

from tests.test_torch_parallel_step import random_arrays

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
SHAPE = (16, 16, 128)             # (nz, ny, nx)
H = (1.0 / 127, 1.0 / 15, 1.0 / 15)


def _zmesh(P):
    return make_mesh([CPU] * P, axes=("z",))


def _jmesh(P):
    return j_make_mesh(jax.devices()[:P], axes=("z",))


def _problems():
    return (PoissonProblem(128, 16, 16, *H), JProblem(128, 16, 16, *H))


def _rhs(seed=0, dtype=np.float32):
    """The reference's `_rhs` (`test_fused_cg_sharded.py:37-44`)."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0.0, 1.0, SHAPE)
    r[0] = r[-1] = 0.0
    r[:, 0] = r[:, -1] = 0.0
    r[:, :, 0] = r[:, :, -1] = 0.0
    r -= r[1:-1, 1:-1, 1:-1].mean()
    return r.astype(dtype)


def test_supported():
    prob, _ = _problems()
    assert cg_fused_sharded_unsupported_reason(prob, 8) is None
    p2 = PoissonProblem(128, 16, 1, 0.01, 0.01, 0.0)
    assert "3D" in cg_fused_sharded_unsupported_reason(p2, 8)
    p3 = PoissonProblem(128, 16, 12, 0.01, 0.01, 0.01)
    assert "divisible" in cg_fused_sharded_unsupported_reason(p3, 8)
    # the (z, y) CG is ported: a y count that divides ny applies, one
    # that does not is refused
    assert cg_fused_sharded_unsupported_reason(prob, 2, py=4) is None
    assert "y-shards" in cg_fused_sharded_unsupported_reason(prob, 2, py=3)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_solve_matches_reference_sharded_cg(P):
    prob, jprob = _problems()
    rhs = _rhs()
    x0 = np.zeros(SHAPE, np.float32)
    jres = jax.jit(j_make_cg_fused_sharded(
        jprob, JPParams(tolerance=1e-3, max_iterations=400), _jmesh(P)))(
        jnp.asarray(x0), jnp.asarray(rhs))
    res = make_cg_fused_sharded(
        prob, PoissonParams(tolerance=1e-3, max_iterations=400),
        _zmesh(P))(torch.from_numpy(x0), torch.from_numpy(rhs))
    assert int(res.status) == int(jres.status) == 0
    assert int(res.iterations) == int(jres.iterations)
    np.testing.assert_allclose(float(res.initial_residual),
                               float(jres.initial_residual), rtol=1e-5)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("start", ["zero", "random"])
def test_float64_plain_matches_reference_jnp_cg(start):
    prob, jprob = _problems()
    params = dict(tolerance=0.0, absolute_tolerance=0.0, max_iterations=30,
                  check_interval=30)
    rhs = _rhs(seed=3, dtype=np.float64)
    x0 = (np.zeros(SHAPE) if start == "zero"
          else np.random.default_rng(9).normal(0.0, 1.0, SHAPE))
    jres = jax.jit(j_make_cg(jprob, JPParams(**params)))(
        jnp.asarray(x0), jnp.asarray(rhs))
    solve = make_cg_fused_sharded(prob, PoissonParams(**params), _zmesh(4))
    res = solve(torch.from_numpy(x0), torch.from_numpy(rhs))
    assert res.x.dtype == torch.float64
    assert int(res.iterations) == int(jres.iterations) == 30
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10)


def _step_pair(P, pp, jpp, seed=21, **kw):
    """The port's and the reference's sharded CG steps at 128×16×16 and
    the same random start (the reference's `test_projection_with_sharded_
    cg` field)."""
    jgrid = JGrid.uniform(128, 16, 16, zmin=0.0, zmax=1.0)
    rng = np.random.default_rng(seed)
    arrays = random_arrays(jgrid.shape, seed=seed)
    arrays.update({n: rng.normal(0, 0.1, jgrid.shape).astype(np.float32)
                   for n in "uvwp"})
    jstep, jplace = j_make_sharded_step(
        jgrid, JParams(), _jmesh(P), "projection", use_pallas=True,
        strict=True, dtype=jnp.float32, poisson_method=JMethod.CG,
        poisson_params=jpp)
    step, place = make_sharded_step(
        grid_from(jgrid), NSParams(), _zmesh(P), "projection",
        dtype=torch.float32, poisson_method=Method.CG, poisson_params=pp,
        **kw)
    jf = jplace(JField(**{n: jnp.asarray(a) for n, a in arrays.items()}))
    fs = place(field_from_numpy(arrays, "cpu", torch.float32))
    return step, fs, jstep, jf


@pytest.mark.parametrize("P", [2, 4])
def test_step_matches_reference_sharded_cg_step(P):
    step, fs, jstep, jf = _step_pair(
        P, PoissonParams(tolerance=1e-3, max_iterations=400),
        JPParams(tolerance=1e-3, max_iterations=400))
    fs, res = step(fs, 1e-3, 0)
    jf, jres = jstep(jf, 0.001, 0)
    assert isinstance(fs, ShardedField)
    assert int(res.status) == int(jres.status) == 0
    g = gather_field(fs)
    for n in "uvw":
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jf, n)), rtol=0,
                                   atol=1e-4, err_msg=n)
    np.testing.assert_allclose(g.p.numpy(), np.asarray(jf.p), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(float(res.residual), float(jres.residual),
                               rtol=1e-2)
    assert int(step.last_poisson.iterations) > 0


def test_step_reports_a_failed_solve_as_the_reference():
    """A solve stopped at its iteration cap: status −7 (MAX_ITER) and its
    final residual as the step's, as the reference's (`fused.py:631-643`)."""
    step, fs, jstep, jf = _step_pair(
        2, PoissonParams(tolerance=1e-6, max_iterations=2),
        JPParams(tolerance=1e-6, max_iterations=2))
    _, res = step(fs, 1e-3, 0)
    _, jres = jstep(jf, 0.001, 0)
    assert int(res.status) == int(jres.status) == -7
    np.testing.assert_allclose(float(res.residual), float(jres.residual),
                               rtol=1e-4)


@pytest.mark.parametrize("maker", [make_sharded_step, make_sharded_raw_step],
                         ids=["step", "raw_step"])
def test_reference_keywords_build_the_same_step(maker):
    """C3: the reference's ``strict``, ``use_pallas``, ``use_pallas_cg``
    and ``pallas_interpret`` (`sharded.py:83-94`) are taken; the step is
    the one built without them."""
    grid = grid_from(JGrid.uniform(40, 16, 8, zmin=0.0, zmax=1.0))
    pp = PoissonParams(tolerance=1e-4)
    arrays = random_arrays(grid.shape, seed=5)
    outs = []
    for kw in ({}, dict(use_pallas=True, strict=True),
               dict(use_pallas_cg=True, strict=False,
                    pallas_interpret=True)):
        built = maker(grid, NSParams(), _zmesh(2), "projection",
                      dtype=torch.float32, poisson_method=Method.CG,
                      poisson_params=pp, **kw)
        step, place = built[0], built[-1]
        f, res = step(place(field_from_numpy(arrays, "cpu",
                                             torch.float32)), 1e-3, 0)
        assert int(res.status) == 0
        outs.append(gather_field(f))
    for g in outs[1:]:
        for n in "uvwp":
            assert torch.equal(getattr(g, n), getattr(outs[0], n)), n
    with pytest.raises(CFDError, match="GSPMD"):
        maker(grid, NSParams(), _zmesh(2), "projection", use_pallas=False,
              strict=True)


def test_nssolver_on_a_mesh_takes_the_default_cg():
    """``NSSolver(mesh=…)`` with its default pressure solve (CG) inits,
    steps and solves like the single-device ``NSSolver`` in float64."""
    grid = grid_from(JGrid.uniform(32, 16, 8, zmin=0.0, zmax=1.0))
    kw = dict(name="p", method="projection", dtype=torch.float64)
    solver = NSSolver(mesh=_zmesh(4), **kw)
    single = NSSolver(device="cpu", **kw)
    assert solver.poisson_method == Method.CG
    params = NSParams(max_iter=3)
    assert solver.init(grid, params) == Status.SUCCESS
    single.init(grid, params)
    arrays = random_arrays(grid.shape, seed=8, dtype=np.float64)
    f1 = field_from_numpy(arrays, "cpu", torch.float64)
    fs = solver.place(f1)
    for _ in range(2):
        fs, stats = solver.step(fs, 1e-3)
        f1, stats1 = single.step(f1, 1e-3)
    assert stats.status == stats1.status == Status.SUCCESS
    g = fs.gather()
    for n in "uvwp":
        assert float((getattr(g, n) - getattr(f1, n)).abs().max()) <= 1e-10
    assert abs(stats.max_velocity - stats1.max_velocity) <= 1e-10
    fs, stats = solver.solve(fs, 1e-3)
    f1, stats1 = single.solve(f1, 1e-3)
    assert stats.iterations == stats1.iterations == 3
    g = fs.gather()
    for n in "uvwp":
        assert float((getattr(g, n) - getattr(f1, n)).abs().max()) <= 1e-10


REFUSALS = {
    "multigrid preconditioner": (
        dict(poisson_params=PoissonParams(preconditioner=Precond.MULTIGRID)),
        _zmesh, "CG kernel build failed"),
    # a (z, y) mesh whose y count does not divide ny (3 of 16 rows)
    "zy mesh": ({}, lambda P: make_mesh([CPU] * (P - 1), axes=("z", "y")),
                "ny=16 must be divisible by 3 y-shards"),
    "nz not divisible": ({}, lambda P: _zmesh(3), "nz=8 must be divisible"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_that_remain(case):
    kw, mesh_of, reason = REFUSALS[case]
    grid = grid_from(JGrid.uniform(40, 16, 8, zmin=0.0, zmax=1.0))
    with pytest.raises(CFDError) as err:
        make_sharded_step(grid, NSParams(), mesh_of(4), "projection",
                          poisson_method=Method.CG, **kw)
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert reason in str(err.value)
