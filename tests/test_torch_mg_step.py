"""The port's multigrid projection step (``poisson_method=
Method.MULTIGRID``) against the reference's, on the CPU.

* 3D at 17³ and 2D at 33² and 65×33, 3 steps: against the reference's
  jnp step in float64 (1e-9; the reference runs its jnp body on 2^k+1
  grids) and in float32 (the CG step's bars: u, v, w within atol 1e-4, p
  within rtol 1e-3 / atol 1e-4·max|p|);
* the 2D step goes through the whole-solve wrapper, the 3D one through
  the sweep wrapper on every level;
* a V-cycle cap that stops short fails the step with −7, as the
  reference's;
* the repair of ``Precond.MULTIGRID`` in the CG step: it runs plain CG,
  as the reference's step does, equal to the port's own
  ``Precond.NONE`` step.

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

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
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPParams
from cfd_tpu.solvers.poisson.base import Precond as JPrecond
from cfd_tpu_torch import Grid
from cfd_tpu_torch.interop import field_from_numpy
from cfd_tpu_torch.ops.kernels import mg_kernels as mgk
from cfd_tpu_torch.ops.kernels import vmem_mg
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                Precond)

torch.set_num_threads(min(2, torch.get_num_threads()))

FIELDS = ("u", "v", "w", "p")
DT = 0.001
PHYS = dict(source_amplitude_u=0.1, source_amplitude_v=0.05, mu=0.01)


def _random_numpy_field(shape, seed, np_dt, amp=0.1):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, amp, shape).astype(np_dt) for n in FIELDS}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = np.full(shape, 300.0, np_dt)
    return out


def _grids(shape):
    nz, ny, nx = shape
    if nz == 1:
        return Grid.uniform(nx, ny), JGrid.uniform(nx, ny)
    return (Grid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0),
            JGrid.uniform(nx, ny, nz, zmin=0.0, zmax=1.0))


def _run_both(shape, np_dt, n_steps, method=Method.MULTIGRID, pparams=None,
              seed=0):
    arrays = _random_numpy_field(shape, seed, np_dt)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    g, jg = _grids(shape)
    pparams = dict(pparams or {})
    jpp = dict(pparams)
    if "preconditioner" in jpp:
        jpp["preconditioner"] = JPrecond(int(jpp["preconditioner"]))
    jstep = jax.jit(j_make_step(jg, JParams(**PHYS), dtype=jdt,
                                poisson_method=JMethod(int(method)),
                                poisson_params=JPParams(**jpp),
                                use_pallas=False))
    step = make_projection_step(g, NSParams(**PHYS), dtype=tdt,
                                poisson_method=method,
                                poisson_params=PoissonParams(**pparams),
                                device="cpu")
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    tf = field_from_numpy(arrays, "cpu", tdt)
    out = []
    for i in range(n_steps):
        jf, jr = jstep(jf, DT, i)
        tf, tr = step(tf, DT, i)
        out.append((jf, jr, tf, tr))
    return out, step


def _assert_step_close(out, atol_uvw, p_rtol, p_atol_rel):
    for jf, jr, tf, tr in out:
        assert int(tr.status) == int(jr.status) == 0
        for n in ("u", "v", "w"):
            np.testing.assert_allclose(getattr(tf, n).numpy(),
                                       np.asarray(getattr(jf, n)), rtol=0,
                                       atol=atol_uvw, err_msg=n)
        p_ref = np.asarray(jf.p)
        np.testing.assert_allclose(tf.p.numpy(), p_ref, rtol=p_rtol,
                                   atol=p_atol_rel * np.abs(p_ref).max(),
                                   err_msg="p")
        np.testing.assert_allclose(float(tr.max_velocity),
                                   float(jr.max_velocity), rtol=1e-6)


SHAPES = [(17, 17, 17), (1, 33, 33), (1, 33, 65)]
IDS = ["3d_17^3", "2d_33^2", "2d_65x33"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_step_matches_jnp_reference_f64(shape):
    """3 steps, float64: fields within 1e-9, the solve's residual within
    1e-6 relative; the step's V-cycle counts are the reference's."""
    mgk.rb_sweep.launches = vmem_mg.mg_solve.launches = 0
    out, step = _run_both(shape, np.float64, 3)
    _assert_step_close(out, 1e-9, 0.0, 1e-9)
    for _, jr, _, tr in out:
        np.testing.assert_allclose(float(tr.residual), float(jr.residual),
                                   rtol=1e-6)
    assert 1 <= int(step.last_poisson.iterations) <= 12
    # on the CPU the wrappers run their plain versions and count nothing
    assert mgk.rb_sweep.launches == vmem_mg.mg_solve.launches == 0


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_step_matches_reference_f32(shape):
    """3 steps, float32, at the CG step's bars."""
    out, _ = _run_both(shape, np.float32, 3)
    _assert_step_close(out, 1e-4, 1e-3, 1e-4)


@pytest.mark.parametrize("shape", [(17, 17, 17), (1, 33, 33)],
                         ids=["3d", "2d"])
def test_step_calls_the_kernel_wrappers(shape, monkeypatch):
    """The 2D step's solve is the whole-solve wrapper, once a step; the
    3D one runs the sweep wrapper on every level, the coarsest
    included."""
    calls = []
    sweep, solve = mgk.rb_sweep, vmem_mg.mg_solve

    def count_sweep(x, b, lv, *a, **k):
        calls.append(tuple(lv.shape))
        return sweep(x, b, lv, *a, **k)

    def count_solve(*a, **k):
        calls.append("mg_solve")
        return solve(*a, **k)

    monkeypatch.setattr(mgk, "rb_sweep", count_sweep)
    monkeypatch.setattr(vmem_mg, "mg_solve", count_solve)
    g, _ = _grids(shape)
    step = make_projection_step(g, NSParams(**PHYS), dtype=torch.float32,
                                poisson_method=Method.MULTIGRID,
                                device="cpu")
    f = field_from_numpy(_random_numpy_field(shape, 1, np.float32), "cpu",
                         torch.float32)
    step(f, DT, 0)
    if shape[0] == 1:
        assert calls == ["mg_solve"]
    else:
        assert set(calls) == {(17, 17, 17), (9, 9, 9), (5, 5, 5)}


@pytest.mark.parametrize("shape", [(17, 17, 17), (1, 33, 33)],
                         ids=["3d", "2d"])
def test_unconverged_solve_fails_the_step(shape):
    """A cap of one V-cycle at a tight tolerance: −7 with the solve's
    residual, as the reference's step."""
    out, _ = _run_both(shape, np.float64, 1,
                       pparams=dict(max_iterations=1, tolerance=1e-12))
    jf, jr, tf, tr = out[0]
    assert int(tr.status) == int(jr.status) == -7
    np.testing.assert_allclose(float(tr.residual), float(jr.residual),
                               rtol=1e-8)


@pytest.mark.parametrize("shape", [(10, 20, 24), (1, 20, 24)],
                         ids=["3d_24x20x10", "2d_24x20"])
def test_cg_multigrid_preconditioner_runs_plain_cg(shape):
    """``Precond.MULTIGRID`` in the CG step is the reference's
    unpreconditioned CG (`krylov.py:37`, `:136-137`, `:215-216`): within
    1e-9 of its jnp step in float64 over 3 steps, and equal to the port's
    own ``Precond.NONE`` step."""
    pp = dict(preconditioner=Precond.MULTIGRID)
    out, _ = _run_both(shape, np.float64, 3, method=Method.CG, pparams=pp)
    _assert_step_close(out, 1e-9, 0.0, 1e-9)
    plain, _ = _run_both(shape, np.float64, 3, method=Method.CG)
    for (_, _, tf, tr), (_, _, pf, pr) in zip(out, plain):
        for n in FIELDS:
            assert torch.equal(getattr(tf, n), getattr(pf, n)), n
        assert torch.equal(tr.residual, pr.residual)
