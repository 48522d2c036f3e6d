"""The projection step with Boussinesq buoyancy and the energy equation
against the reference's:

* 3D (128×16×8) and 2D (128×32), FFT_DIRECT and CG, in float32 against
  the reference's fused step (interpret mode: the buoyant predictor
  kernels, the jnp energy post-step) after two steps, at its fused bar
  2e-5 on u, v, w, p and the same relative to T's scale (~300) on T;
* 3D (24×20×10) and 2D (40×24) in float64 against its jnp step within
  1e-9 (p of the CG step within 1e-6, its tolerance);
* a few steps of `tests/validation/test_natural_convection.py:run_dvd`'s
  de Vahl Davis Ra = 1e3 cavity (41², no-slip walls applied before and
  after each step, hot and cold Dirichlet walls, adiabatic top and
  bottom) in float64 against the reference's jnp step, within 1e-9;
* ``Simulation.create`` with thermal parameters steps (the facade passes
  them through).

Both packages get the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary import BCType as JB
from cfd_tpu.boundary import DirichletValues as JD
from cfd_tpu.boundary import ThermalBCConfig as JT
from cfd_tpu.boundary import apply_dirichlet_scalar as j_dirichlet
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch import Grid
from cfd_tpu_torch.api import Simulation
from cfd_tpu_torch.boundary import DirichletValues, apply_dirichlet_scalar
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "T")
DIAGS = ("max_velocity", "max_pressure", "max_temperature")
FACES = JT(left=JB.DIRICHLET, right=JB.NEUMANN, bottom=JB.NEUMANN,
           top=JB.DIRICHLET, back=JB.NEUMANN, front=JB.DIRICHLET,
           dirichlet_values=JD(left=301.0, top=299.0, front=302.0))
GRAVITY = {"3d": (0.0, -9.81, 1.0), "2d": (0.0, -9.81, 0.0)}


def _params(dim):
    jp = JParams(mu=0.01, alpha=1e-3, beta=3e-3, T_ref=300.0,
                 gravity=GRAVITY[dim], thermal_bc=FACES)
    return jp, NSParams.from_fields(jp)


def _grids(shape):
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    return JGrid.uniform(nx, ny, nz, **kw), Grid.uniform(nx, ny, nz, **kw)


def _arrays(shape, seed, np_dt):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, 0.1, shape).astype(np_dt) for n in "uvwp"}
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = (300.0 + rng.normal(0.0, 1.0, shape)).astype(np_dt)
    return out


def run_pair(shape, method, np_dt, fused, steps=2):
    dim = "3d" if shape[0] > 1 else "2d"
    jg, tg = _grids(shape)
    jp, tp = _params(dim)
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    jkw = dict(use_pallas=True, pallas_interpret=True) if fused else dict(
        use_pallas=False)
    jstep = jax.jit(j_make_step(jg, jp, dtype=jdt,
                                poisson_method=JMethod[method.name], **jkw))
    tstep = make_projection_step(tg, tp, dtype=tdt, poisson_method=method,
                                 device="cpu")
    a = _arrays(shape, 5, np_dt)
    jf = JField(**{n: jnp.asarray(x) for n, x in a.items()})
    tf = field_from_numpy(a, "cpu", tdt)
    for i in range(steps):
        jf, jr = jstep(jf, 1e-3, i)
        tf, tr = tstep(tf, 1e-3, i)
        assert int(jr.status) == int(tr.status) == 0
    return jf, jr, tf, tr


def assert_close(jf, jr, tf, tr, atol, p_atol, rtol_diag):
    out = field_to_numpy(tf)
    for n in NAMES:
        bar = {"T": atol * 300.0, "p": p_atol}.get(n, atol)
        np.testing.assert_allclose(out[n], np.asarray(getattr(jf, n)),
                                   rtol=0, atol=bar, err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=rtol_diag,
                                   err_msg=d)


CASES = {"3d_fft": ((8, 16, 128), Method.FFT_DIRECT),
         "3d_cg": ((8, 16, 128), Method.CG),
         "2d_fft": ((1, 32, 128), Method.FFT_DIRECT),
         "2d_cg": ((1, 32, 128), Method.CG)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_fused_reference_f32(case):
    shape, method = CASES[case]
    assert_close(*run_pair(shape, method, np.float32, True), 2e-5, 2e-5,
                 1e-5)


@pytest.mark.parametrize("shape,method", [
    ((10, 20, 24), Method.FFT_DIRECT), ((10, 20, 24), Method.CG),
    ((1, 24, 40), Method.FFT_DIRECT), ((1, 24, 40), Method.CG)],
    ids=["3d_fft", "3d_cg", "2d_fft", "2d_cg"])
def test_matches_jnp_reference_f64(shape, method):
    exact = method == Method.FFT_DIRECT
    assert_close(*run_pair(shape, method, np.float64, False), 1e-9,
                 1e-9 if exact else 1e-6, 1e-9 if exact else 1e-6)


def test_buoyancy_moves_the_fluid():
    """From rest with a T perturbation, the buoyant step moves v (and
    without buoyancy it would not)."""
    _, tg = _grids((1, 24, 40))
    tp = _params("2d")[1].replace(source_amplitude_u=0.0,
                                  source_amplitude_v=0.0)
    a = _arrays((1, 24, 40), 6, np.float64)
    for n in "uvwp":
        a[n][:] = 0.0
    f0 = field_from_numpy(a, "cpu", torch.float64)
    f1, _ = make_projection_step(tg, tp, torch.float64, Method.FFT_DIRECT,
                                 device="cpu")(f0, 1e-3, 0)
    f2, _ = make_projection_step(tg, tp.replace(beta=0.0), torch.float64,
                                 Method.FFT_DIRECT, device="cpu")(f0, 1e-3, 0)
    assert float(f1.v.abs().max()) > 1e-6
    assert float(f2.v.abs().max()) == 0.0


def test_dvd_ra1e3_steps_match_reference_f64():
    """`run_dvd(Ra=1e3, n=41, dt=0.002)`'s configuration: 20 steps (CG,
    the no-slip walls before and after each step) within 1e-9 of the
    reference's jnp step (p 1e-6)."""
    Ra, n, dt = 1e3, 41, 0.002
    t_hot, t_cold, beta, g, pr = 310.0, 290.0, 0.003333, 9.81, 0.71
    alpha = float(np.sqrt(g * beta * (t_hot - t_cold) / Ra / pr))
    jc = JT(left=JB.DIRICHLET, right=JB.DIRICHLET, top=JB.NEUMANN,
            bottom=JB.NEUMANN, dirichlet_values=JD(left=t_hot, right=t_cold))
    jp = JParams(dt=dt, mu=pr * alpha, alpha=alpha, beta=beta, T_ref=300.0,
                 gravity=(0.0, -g, 0.0), max_iter=1, source_amplitude_u=0.0,
                 source_amplitude_v=0.0, thermal_bc=jc)
    jg, tg = _grids((1, n, n))
    jstep = jax.jit(j_make_step(jg, jp, dtype=jnp.float64, use_pallas=False))
    tstep = make_projection_step(tg, NSParams.from_fields(jp),
                                 torch.float64, device="cpu")
    T0 = np.broadcast_to(t_hot - (t_hot - t_cold) * np.asarray(tg.x),
                         (1, n, n)).copy()
    a = {k: np.zeros((1, n, n)) for k in "uvwp"}
    a.update(rho=np.ones((1, n, n)), T=T0)
    jf = JField(**{k: jnp.asarray(x) for k, x in a.items()})
    tf = field_from_numpy(a, "cpu", torch.float64)

    def j_bc(f):
        return f.replace(u=j_dirichlet(f.u, JD()), v=j_dirichlet(f.v, JD()))

    def t_bc(f):
        return f.replace(u=apply_dirichlet_scalar(f.u, DirichletValues()),
                         v=apply_dirichlet_scalar(f.v, DirichletValues()))

    for i in range(20):
        jf, jr = jstep(j_bc(jf), dt, i)
        tf, tr = tstep(t_bc(tf), dt, i)
        jf, tf = j_bc(jf), t_bc(tf)
        assert int(jr.status) == int(tr.status) == 0
    assert float(tf.v.abs().max()) > 1e-5      # convection has started
    assert_close(jf, jr, tf, tr, 1e-9, 1e-6, 1e-6)


def test_simulation_with_thermal_params_steps():
    """The facade passes the thermal parameters through to its solver."""
    params = NSParams(dt=1e-3, mu=0.01, max_iter=1, alpha=1e-3, beta=3e-3,
                      T_ref=300.0, gravity=(0.0, -9.81, 0.0),
                      thermal_bc=NSParams.from_fields(
                          JParams(thermal_bc=FACES)).thermal_bc)
    for solver in ("explicit_euler", "rk2", "projection"):
        sim = Simulation.create(32, 16, solver_type=solver, params=params,
                                device="cpu", dtype=torch.float64)
        T0 = sim.field.T.clone()
        for _ in range(3):
            assert sim.step() == 0
        T = sim.field.T
        assert bool(torch.isfinite(T).all())
        np.testing.assert_array_equal(T[0, 1:-1, 0].numpy(), 301.0)
        assert not torch.equal(T, T0)
