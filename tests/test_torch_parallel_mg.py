"""The decomposed multigrid solve (`parallel.fused_mg`) and the projection
step with it on a mesh (`parallel.sharded`'s MULTIGRID dispatch), on
`LocalComm` CPU shards.

* The solve over 2 and 4 z-shards and a (2, 2) (z, y) mesh at 17³ and
  33³, cold and warm started, float32 and float64: the V-cycle count and
  x of the port's single-device ``make_multigrid`` bit for bit (the
  restriction is formed by the owner of each coarse node's centre plane,
  in the single-device order), so within 1e-10 in float64; at 17³ in
  float32 also against the reference's single-device jnp solve
  (``use_pallas=False``, compiled once): the same count, x at the
  reference's sharded bar (atol 1e-4, 2e-4 warm,
  `tests/parallel/test_fused_mg_sharded.py:60`, `:85`);
* ``make_sharded_step(..., "projection", poisson_method=MULTIGRID)`` at
  33³ over z meshes of 2 and 4 shards and over (2, 2): one step against
  the reference's single-device jnp step (u, v, w 1e-5, p 1e-4,
  `tests/parallel/test_sharded_mg_projection.py:93-98`), three steps with
  the energy equation and buoyancy (3e-5, `:121-129`); the single-device
  port step bit for bit;
* ``Simulation.create(..., "projection_multigrid", mesh=)`` against the
  single-device facade;
* the fine level runs the sweep's sharded modes on the shards' blocks
  (the wrapper's calls recorded), never the single-device solve;
* the refusals: a 2D grid, a non-coarsenable grid, too few planes or
  rows a shard, a mesh over another axis — ``ERROR_UNSUPPORTED`` with the
  reason.

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson import multigrid as jmg
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch import Grid, Status
from cfd_tpu_torch.api import Simulation
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.interop import field_from_numpy
from cfd_tpu_torch.ops.kernels import mg_kernels as mgk
from cfd_tpu_torch.parallel import (ShardedField, make_mesh,
                                    make_multigrid_sharded,
                                    make_sharded_step,
                                    mg_fused_sharded_unsupported_reason)
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson import multigrid as mgs
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem)

from tests.test_torch_parallel_step import assert_close

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
MESHES = {"z2": (2, 1), "z4": (4, 1), "zy22": (2, 2)}
TOL = 1e-6
N_STEP = 33
# the energy equation and buoyancy (`test_sharded_mg_projection.py:105`)
ENERGY = dict(alpha=1e-3, beta=0.5, T_ref=0.5)


def _mesh(name):
    pz, py = MESHES[name]
    if py == 1:
        return make_mesh([CPU] * pz, axes=("z",))
    return make_mesh([CPU] * (pz * py), shape=(pz, py))


def _rhs(n, seed):
    """The reference test's rhs (`test_fused_mg_sharded.py:15-21`)."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0.0, 1.0, (n, n, n))
    r[0] = r[-1] = 0.0
    r[:, 0] = r[:, -1] = 0.0
    r[:, :, 0] = r[:, :, -1] = 0.0
    return r


def _problems(n):
    h = 1.0 / (n - 1)
    return PoissonProblem(n, n, n, h, h, h), JProblem(n, n, n, h, h, h)


# ---- the solve --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_solve(n):
    """The reference's single-device jnp solve, compiled once."""
    return jax.jit(jmg.make_multigrid(_problems(n)[1],
                                      JPParams(tolerance=TOL),
                                      use_pallas=False))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("n", [17, 33])
def test_solve_matches_one_device(n, mesh, dtype, warm):
    np_dt = {"f32": np.float32, "f64": np.float64}[dtype]
    prob = _problems(n)[0]
    rhs = _rhs(n, 2 + warm).astype(np_dt)
    x0 = (np.random.default_rng(11).normal(0, 1, (n, n, n)).astype(np_dt)
          if warm else np.zeros((n, n, n), np_dt))
    pp = PoissonParams(tolerance=TOL)
    solve = make_multigrid_sharded(prob, pp, _mesh(mesh))
    got = solve(torch.tensor(x0), torch.tensor(rhs))
    one = mgs.make_multigrid(prob, pp, device="cpu")(torch.tensor(x0),
                                                     torch.tensor(rhs))
    assert int(got.status) == int(one.status) == 0
    assert int(got.iterations) == int(one.iterations)
    assert torch.equal(got.x, one.x)
    assert solve.host_syncs == int(got.iterations) + 1
    if n != 17 or dtype == "f64":
        return
    ref = _reference_solve(n)(jnp.asarray(x0), jnp.asarray(rhs))
    assert int(ref.status) == 0
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=2e-4 if warm else 1e-4)
    np.testing.assert_allclose(float(got.initial_residual),
                               float(ref.initial_residual), rtol=1e-6)


def test_fine_level_runs_the_sharded_sweep_modes(monkeypatch):
    """Every fine-level sweep is the wrapper's sharded mode on a shard's
    halo block (4 planes a side, and 4 rows on a (z, y) mesh); the coarse
    levels are single-device sweeps of the level-1 shapes and below; the
    single-device solve is never built."""
    calls = []
    sweep = mgk.rb_sweep

    def record(x, b, lv, *a, **k):
        calls.append((tuple(x.shape), k.get("z_off"), k.get("y_off")))
        return sweep(x, b, lv, *a, **k)

    def refuse(*a, **k):
        raise AssertionError("the single-device multigrid was built")

    monkeypatch.setattr(mgk, "rb_sweep", record)
    monkeypatch.setattr(mgs, "make_multigrid", refuse)
    prob, _ = _problems(17)
    for mesh, block, offs in (
            ("z4", (6 + 8, 17, 17), {(z, None) for z in (-4, 2, 8, 14)}),
            ("zy22", (10 + 8, 10 + 8, 17),
             {(z, y) for z in (-4, 6) for y in (-4, 6)})):
        calls.clear()
        res = make_multigrid_sharded(prob, PoissonParams(tolerance=TOL),
                                     _mesh(mesh))(
            torch.zeros(17, 17, 17), torch.tensor(_rhs(17, 0),
                                                  dtype=torch.float32))
        assert int(res.status) == 0
        fine = [c for c in calls if c[1] is not None]
        assert {c[0] for c in fine} == {block}
        assert {c[1:] for c in fine} == offs
        # (pre + post) sweeps of each shard a V-cycle
        assert len(fine) == 4 * 4 * int(res.iterations)
        assert all(c[0][0] <= 9 for c in calls if c[1] is None)


# ---- the step ---------------------------------------------------------------

def _arrays(shape, seed, temperature=False):
    """The reference test's ``_random_field`` (`test_sharded_mg_
    projection.py:23-31`): u, v, w, p ~ N(0, 0.1), ρ = 1, T uniform on
    [0, 1] with the energy equation, else 300."""
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(0, 0.1, shape).astype(np.float32) for k in "uvwp"}
    out["rho"] = np.ones(shape, np.float32)
    out["T"] = (rng.uniform(0, 1, shape).astype(np.float32) if temperature
                else np.full(shape, 300.0, np.float32))
    return out


@functools.lru_cache(maxsize=None)
def _reference_steps(energy, n_steps, seed):
    """The reference's single-device jnp step's field after ``n_steps``
    steps of dt 1e-3 (compiled once a configuration)."""
    jparams = JParams(**ENERGY) if energy else JParams()
    jgrid = JGrid.uniform(N_STEP, N_STEP, N_STEP, zmin=0.0, zmax=1.0)
    jstep = jax.jit(j_make_step(jgrid, jparams, dtype=jnp.float32,
                                use_pallas=False,
                                poisson_method=JMethod.MULTIGRID,
                                poisson_params=JPParams(tolerance=TOL)))
    jf = JField(**{k: jnp.asarray(a) for k, a in
                   _arrays((N_STEP,) * 3, seed, energy).items()})
    for i in range(n_steps):
        jf, jres = jstep(jf, 1e-3, i)
        assert int(jres.status) == 0
    return jf


def _steps(energy, mesh, n_steps, seed):
    """(sharded port field, reference field, single-device port field)
    after ``n_steps`` steps of dt 1e-3."""
    params = NSParams(**ENERGY) if energy else NSParams()
    grid = Grid.uniform(N_STEP, N_STEP, N_STEP, zmin=0.0, zmax=1.0)
    arrays = _arrays((N_STEP,) * 3, seed, energy)
    step, place = make_sharded_step(
        grid, params, _mesh(mesh), "projection", dtype=torch.float32,
        poisson_method=Method.MULTIGRID,
        poisson_params=PoissonParams(tolerance=TOL))
    one = make_projection_step(grid, params, torch.float32,
                               Method.MULTIGRID, PoissonParams(tolerance=TOL),
                               device="cpu")
    f = field_from_numpy(arrays, "cpu", torch.float32)
    sf = place(f)
    for i in range(n_steps):
        sf, res = step(sf, 1e-3, i)
        f, res1 = one(f, 1e-3, i)
        assert int(res.status) == int(res1.status) == 0
        assert int(step.last_poisson.iterations) \
            == int(one.last_poisson.iterations)
    assert isinstance(sf, ShardedField)
    return sf, _reference_steps(energy, n_steps, seed), f


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_step_matches_the_reference_single_device_step(mesh):
    sf, jf, f = _steps(False, mesh, 1, seed=5)
    assert_close(sf, jf, 1e-5, 1e-4)
    g = sf.gather()
    for k in "uvwp":
        assert torch.equal(getattr(g, k), getattr(f, k)), k


def test_three_steps_with_energy_and_buoyancy():
    sf, jf, f = _steps(True, "z4", 3, seed=7)
    g = sf.gather()
    for k in "uvwT":
        np.testing.assert_allclose(getattr(g, k).numpy(),
                                   np.asarray(getattr(jf, k)), rtol=0,
                                   atol=3e-5, err_msg=k)
        assert torch.equal(getattr(g, k), getattr(f, k)), k


@pytest.mark.parametrize("mesh", ["z2", "zy22"])
def test_facade_on_a_mesh_steps_like_one_device(mesh):
    sims = [Simulation.create(
        N_STEP, N_STEP, N_STEP, zmax=1.0, solver_type="projection_multigrid",
        device="cpu", **kw) for kw in ({"mesh": _mesh(mesh)}, {})]
    start = field_from_numpy(_arrays((N_STEP,) * 3, 9), "cpu",
                             torch.float32)
    sims[0].field = sims[0].solver.place(start)
    sims[1].field = start
    assert [int(s.step()) for s in sims] == [0, 0]
    assert isinstance(sims[0].field, ShardedField)
    g = sims[0].field.gather()
    for k in "uvwp":
        assert torch.equal(getattr(g, k), getattr(sims[1].field, k)), k


# ---- the refusals -----------------------------------------------------------

REFUSALS = {
    "2D": (lambda: Grid.uniform(33, 33), "z2", "3D-only"),
    "not coarsenable": (lambda: Grid.uniform(32, 32, 32, zmin=0.0,
                                             zmax=1.0), "z2", "coarsenable"),
    "planes": (lambda: Grid.uniform(9, 9, 9, zmin=0.0, zmax=1.0), "z8",
               "nz=9 over 8 shards leaves 2 planes per shard"),
    "rows": (lambda: Grid.uniform(9, 9, 9, zmin=0.0, zmax=1.0), "zy18",
             "ny=9 over 8 y-shards leaves 2 rows per shard"),
    "y mesh": (lambda: Grid.uniform(33, 33, 33, zmin=0.0, zmax=1.0), "y4",
               "needs a mesh over"),
}


def _named_mesh(name):
    if name == "z8":
        return make_mesh([CPU] * 8, axes=("z",))
    if name == "zy18":
        return make_mesh([CPU] * 8, shape=(1, 8))
    if name == "y4":
        return make_mesh([CPU] * 4, axes=("y",))
    return _mesh(name)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals(case):
    grid_of, mesh, reason = REFUSALS[case]
    grid = grid_of()
    with pytest.raises(CFDError) as err:
        make_sharded_step(grid, NSParams(), _named_mesh(mesh), "projection",
                          poisson_method=Method.MULTIGRID)
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert reason in str(err.value)
    if case != "y mesh":
        prob = PoissonProblem(grid.nx, grid.ny, grid.nz, grid.dx0,
                              grid.dy0, grid.dz0)
        with pytest.raises(CFDError) as err:
            make_multigrid_sharded(prob, PoissonParams(), _named_mesh(mesh))
        assert err.value.status == Status.ERROR_UNSUPPORTED
        assert reason in str(err.value)


def test_reasons_follow_the_reference_where_it_has_the_rule():
    prob = _problems(33)[0]
    assert mg_fused_sharded_unsupported_reason(prob, 8) is None
    # the TPU's float32-only gate is left out: float64 runs the plain
    # sweeps
    assert mg_fused_sharded_unsupported_reason(prob, 8,
                                               torch.float64) is None
    assert mg_fused_sharded_unsupported_reason(prob, 2, py=2) is None
    flat = PoissonProblem(33, 33, 1, 1 / 32, 1 / 32, 0.0)
    assert "3D" in mg_fused_sharded_unsupported_reason(flat, 8)
    odd = PoissonProblem(34, 33, 34, 1 / 33, 1 / 32, 1 / 33)
    assert "coarsenable" in mg_fused_sharded_unsupported_reason(odd, 8)
