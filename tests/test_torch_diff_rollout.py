"""Differentiable rollouts (`cfd_tpu_torch.solvers.ns.rollout.make_rollout`)
against the reference's (`cfd_tpu/solvers/ns/rollout.py`), on the CPU in
float64, mirroring `tests/solvers/test_diff_rollout.py`.

* the Euler, RK2 and RK4 plain steps' gradients w.r.t. the initial u
  through a 3-step rollout against ``jax.grad`` of the reference's jnp
  steps, rtol 1e-9 of max|grad| (the same arithmetic in another operation
  order: float64 rounding, about 1e-15);
* a tensor β (the Boussinesq buoyancy kept, as the reference's
  ``static_bool``) and a per-step dt schedule, against the reference's
  gradients at the same bar;
* the remat policies: values bit-equal to the store-everything rollout,
  gradients within 1e-12 relative (the reference's 1e-10 / 1e-12 bar);
* ``collect_results``, ``start_iter`` and the argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns import make_euler_step as j_euler
from cfd_tpu.solvers.ns import make_rk2_step as j_rk2
from cfd_tpu.solvers.ns import make_rk4_step as j_rk4
from cfd_tpu.solvers.ns import make_rollout as j_rollout
from cfd_tpu_torch import Grid
from cfd_tpu_torch.interop import field_from_numpy
from cfd_tpu_torch.solvers import ns
from cfd_tpu_torch.solvers.ns import NSParams, make_rollout
from cfd_tpu_torch.solvers.ns.euler import make_euler_step
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.rk import make_rk2_step, make_rk4_step
from cfd_tpu_torch.solvers.ns.rollout import REMAT_POLICIES
from cfd_tpu_torch.solvers.poisson.base import Method, PoissonParams

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(min(2, torch.get_num_threads()))

TIGHT = PoissonParams(tolerance=1e-12, absolute_tolerance=1e-13,
                      max_iterations=4000)
NO_SOURCES = dict(source_amplitude_u=0.0, source_amplitude_v=0.0)
MAKERS = {"euler": (make_euler_step, j_euler),
          "rk2": (make_rk2_step, j_rk2), "rk4": (make_rk4_step, j_rk4)}


def _grids(n=17):
    kw = dict(xmin=0, xmax=2 * np.pi, ymin=0, ymax=2 * np.pi)
    return Grid.uniform(n, n, **kw), JGrid.uniform(n, n, **kw)


def _tg_arrays(jgrid, amp=0.3, T=None):
    """`test_diff_rollout.py:29-34`'s Taylor-Green field as numpy."""
    X, Y, _ = jgrid.coordinate_arrays(jnp.float64)
    shape = (jgrid.nz, jgrid.ny, jgrid.nx)
    out = dict(u=np.broadcast_to(amp * np.sin(X) * np.cos(Y), shape).copy(),
               v=np.broadcast_to(-amp * np.cos(X) * np.sin(Y),
                                 shape).copy(),
               w=np.zeros(shape), p=np.zeros(shape), rho=np.ones(shape),
               T=np.zeros(shape) if T is None else T)
    return out


def _ke(f):
    return 0.5 * (f.u ** 2 + f.v ** 2).sum()


def _j_ke(f):
    return 0.5 * jnp.sum(f.u ** 2 + f.v ** 2)


def _port_field(arrays):
    return field_from_numpy(arrays, "cpu", torch.float64)


def _j_field(arrays):
    return JField(**{k: jnp.asarray(a) for k, a in arrays.items()})


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"max abs deviation {err:.3e} of max {scale:.3e}")
    assert err <= rtol * scale


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_integrator_grad_matches_reference(name):
    """Euler / RK2 / RK4 are differentiable as they are: the gradient of
    the final kinetic energy w.r.t. the initial u through a 3-step
    rollout, against the reference's jnp steps (`test_diff_rollout.py:
    42-60`)."""
    grid, jgrid = _grids()
    arrays = _tg_arrays(jgrid)
    ours, theirs = MAKERS[name]
    roll = make_rollout(ours(grid, NSParams(**NO_SOURCES), torch.float64,
                             "cpu", differentiable=True), 3)
    jroll = j_rollout(theirs(jgrid, JParams(**NO_SOURCES),
                             use_pallas=False), 3)
    f0, jf0 = _port_field(arrays), _j_field(arrays)
    u = f0.u.clone().requires_grad_()
    _ke(roll(f0.replace(u=u), 1e-4)[0]).backward()
    want = jax.grad(lambda u0: _j_ke(jroll(jf0.replace(u=u0), 1e-4)[0]))(
        jf0.u)
    assert np.isfinite(u.grad.numpy()).all()
    _close(u.grad, want, 1e-9)


def test_grad_wrt_boussinesq_beta():
    """A tensor β keeps the buoyancy term (the reference's
    ``static_bool(default=True)``), and d(KE)/dβ through a 3-step Euler
    rollout matches the reference's (`test_diff_rollout.py:63-86`)."""
    grid, jgrid = _grids()
    rng = np.random.default_rng(11)
    arrays = _tg_arrays(jgrid, T=0.5 + 0.1 * rng.standard_normal(
        (1, jgrid.ny, jgrid.nx)))
    kw = dict(alpha=0.01, T_ref=0.5, gravity=(0.0, -9.81, 0.0),
              **NO_SOURCES)
    beta = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    params = NSParams(beta=beta, **kw)
    assert params.buoyancy_enabled and params.requires_grad()
    step = make_euler_step(grid, params, torch.float64, "cpu",
                           differentiable=True)
    _ke(make_rollout(step, 3)(_port_field(arrays), 1e-4)[0]).backward()
    jf0 = _j_field(arrays)

    def loss(b):
        jstep = j_euler(jgrid, JParams(beta=b, **kw), use_pallas=False)
        return _j_ke(j_rollout(jstep, 3)(jf0, 1e-4)[0])

    want = float(jax.grad(loss)(0.7))
    assert float(beta.grad) == pytest.approx(want, rel=1e-9)
    # β = 0 as a tensor still takes the buoyant term's path
    assert NSParams(beta=torch.tensor(0.0)).buoyancy_enabled
    assert not NSParams(beta=0.0).buoyancy_enabled


def test_grad_wrt_dt_schedule():
    """A per-step dt tensor is optimizable: an RK2 4-step schedule's
    gradient is negative (longer steps, more viscous decay) and matches
    the reference's (`test_diff_rollout.py:89-106`)."""
    grid, jgrid = _grids()
    arrays = _tg_arrays(jgrid)
    step = make_rk2_step(grid, NSParams(**NO_SOURCES), torch.float64, "cpu",
                         differentiable=True)
    dts = torch.full((4,), 1e-3, dtype=torch.float64, requires_grad=True)
    _ke(make_rollout(step, 4)(_port_field(arrays), dts)[0]).backward()
    jroll = j_rollout(j_rk2(jgrid, JParams(**NO_SOURCES), use_pallas=False),
                      4)
    jf0 = _j_field(arrays)
    want = jax.grad(lambda d: _j_ke(jroll(jf0, d)[0]))(jnp.full((4,),
                                                                1e-3))
    assert dts.grad.shape == (4,) and bool((dts.grad < 0).all())
    _close(dts.grad, want, 1e-9)


@pytest.mark.parametrize("remat", ["step", "sqrt"])
def test_remat_policies_match_plain(remat):
    """Checkpointing changes the memory schedule, not the math: a 7-step
    differentiable CG projection rollout (7 exercises the sqrt policy's
    tail) gives the store-everything rollout's value bit for bit and its
    gradient within 1e-12 relative (`test_diff_rollout.py:109-136`)."""
    grid, jgrid = _grids()
    step = make_projection_step(grid, NSParams(**NO_SOURCES), torch.float64,
                                Method.CG, TIGHT, device="cpu",
                                differentiable=True)
    f0 = _port_field(_tg_arrays(jgrid))

    def value_and_grad(policy):
        u = f0.u.clone().requires_grad_()
        f, _ = make_rollout(step, 7, remat=policy)(f0.replace(u=u), 0.01)
        val = _ke(f)
        val.backward()
        return val.detach(), f, u.grad

    base, f_base, g_base = value_and_grad(None)
    val, f, g = value_and_grad(remat)
    assert torch.equal(val, base)
    for k in ("u", "v", "w", "p"):
        assert torch.equal(getattr(f, k).detach(), getattr(f_base, k).detach())
    _close(g, g_base, 1e-12)


def test_rollout_results_and_final_status():
    """``collect_results`` stacks the StepResults; without it the last
    step's comes back (`test_diff_rollout.py:139-152`)."""
    grid, jgrid = _grids()
    step = make_euler_step(grid, NSParams(**NO_SOURCES), torch.float64,
                           "cpu")
    f0 = _port_field(_tg_arrays(jgrid))
    f_all, results = make_rollout(step, 5, collect_results=True)(f0, 1e-4)
    assert results.status.shape == (5,)
    assert bool((results.status == 0).all())
    f_last, last = make_rollout(step, 5)(f0, 1e-4)
    assert last.status.shape == ()
    assert torch.equal(f_all.u, f_last.u)
    assert float(last.max_velocity) == float(results.max_velocity[-1])
    _, sq = make_rollout(step, 5, remat="sqrt", collect_results=True)(f0,
                                                                      1e-4)
    for k in ("status", "max_velocity", "max_pressure"):
        assert torch.equal(getattr(sq, k), getattr(results, k))


def test_rollout_start_iter_offsets_sources():
    """start_iter shifts the iteration index the decaying sources see:
    4 then 4 more equals 8, and a dt schedule is read from its start
    (`test_diff_rollout.py:155-166`)."""
    grid, jgrid = _grids()
    step = make_euler_step(grid, NSParams(), torch.float64, "cpu")
    f0 = _port_field(_tg_arrays(jgrid))
    f8, _ = make_rollout(step, 8)(f0, 1e-4)
    f4, _ = make_rollout(step, 4)(f0, 1e-4)
    f44, _ = make_rollout(step, 4, start_iter=4)(f4, 1e-4)
    assert float((f44.u - f8.u).abs().max()) <= 1e-15
    dts = torch.full((4,), 1e-4, dtype=torch.float64)
    f44s, _ = make_rollout(step, 4, start_iter=4, remat="sqrt")(f4, dts)
    assert torch.equal(f44s.u, f44.u)


def test_rollout_validates_args():
    """The reference's checks: an unknown policy, n_steps < 1; the
    exports."""
    grid, _ = _grids()
    step = make_euler_step(grid, NSParams(), torch.float64, "cpu")
    with pytest.raises(ValueError):
        make_rollout(step, 3, remat="bogus")
    with pytest.raises(ValueError):
        make_rollout(step, 0)
    from cfd_tpu.solvers.ns import rollout as jr
    assert REMAT_POLICIES == jr.REMAT_POLICIES
    assert ns.make_rollout is make_rollout and "make_rollout" in ns.__all__
    make_rollout(step, 3, remat="none")
