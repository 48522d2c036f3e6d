"""The explicit steps on a stretched grid (3D) against the reference's
fused interpret kernels, float32, at the reference's grid (128×16×8,
tanh β = 1.5 in x and y) and bars (`tests/math/test_stretched_fused.py`):
Euler within 2e-5, RK2 / RK4 within 5e-5, three Euler steps within 1e-4;
the parity scheme (per-point forward spacings) with sources, the
consistent scheme (exact nonuniform weights) with Boussinesq buoyancy and
the energy equation.  T (≈ 300) is held at two float32 ulps of its
magnitude.  Each reference step is built once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.boundary.types import BCType as JB
from cfd_tpu.boundary.types import ThermalBCConfig as JT
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.euler import make_euler_step as j_euler
from cfd_tpu.solvers.ns.rk import make_rk2_step as j_rk2
from cfd_tpu.solvers.ns.rk import make_rk4_step as j_rk4
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.solvers.ns.euler import make_euler_step
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.rk import make_rk2_step, make_rk4_step

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")
MAKERS = {"euler": (j_euler, make_euler_step),
          "rk2": (j_rk2, make_rk2_step), "rk4": (j_rk4, make_rk4_step)}
SOURCES = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)
THERMAL = dict(alpha=1e-3, beta=3e-3, T_ref=300.0,
               gravity=(0.0, -9.81, 0.5),
               thermal_bc=JT(left=JB.DIRICHLET, right=JB.NEUMANN,
                             bottom=JB.NEUMANN, top=JB.DIRICHLET,
                             back=JB.NEUMANN, front=JB.PERIODIC))


def arrays_for(shape, seed, np_dt):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, 0.3, shape).astype(np_dt) for n in "uvw"}
    out["p"] = (1.0 + rng.normal(0.0, 0.3, shape)).astype(np_dt)
    out["rho"] = (1.0 + rng.normal(0.0, 0.01, shape)).astype(np_dt)
    out["T"] = (300.0 + rng.normal(0.0, 1.0, shape)).astype(np_dt)
    return out


def run_both(method, shape, scheme, extra, np_dt=np.float32, fused=True,
             steps=1, seed=0, dt=1e-4):
    """``steps`` steps of the reference (fused interpret or jnp) and of
    the port (CPU) from the same numpy field; returns (reference fields,
    port fields) as numpy dicts."""
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    jg = JGrid.stretched(nx, ny, nz, beta=1.5, stretch_axes="xy", **kw)
    jparams = JParams(nonuniform_scheme=scheme, **extra)
    jmk, tmk = MAKERS[method]
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    jstep = jax.jit(jmk(jg, jparams, jdt, use_pallas=fused,
                        pallas_interpret=fused))
    tstep = tmk(grid_from(jg), NSParams.from_fields(jparams), tdt, "cpu")
    arrays = arrays_for(shape, seed, np_dt)
    jf = JField(**{n: jnp.asarray(a) for n, a in arrays.items()})
    tf = field_from_numpy(arrays, "cpu", tdt)
    for i in range(steps):
        jf, jr = jstep(jf, dt, i)
        tf, tr = tstep(tf, dt, i)
        assert int(jr.status) == int(tr.status) == 0
        np.testing.assert_allclose(float(tr.max_velocity),
                                   float(jr.max_velocity), rtol=1e-5)
    return ({n: np.array(getattr(jf, n)) for n in NAMES},
            {n: getattr(tf, n).numpy() for n in NAMES})


def assert_fields(out, atol, names=NAMES):
    ref, got = out
    for n in names:
        tol = atol
        if n == "T":   # two ulps of T's magnitude (≈ 300)
            tol = max(atol, 2.0 * float(np.spacing(
                np.abs(ref[n]).max().astype(ref[n].dtype))))
        np.testing.assert_allclose(got[n], ref[n], rtol=0, atol=tol,
                                   err_msg=n)


SHAPE = (8, 16, 128)


@pytest.fixture(scope="module")
def euler_parity():
    return run_both("euler", SHAPE, "parity", SOURCES)


@pytest.fixture(scope="module")
def euler_consistent_thermal():
    return run_both("euler", SHAPE, "consistent", dict(SOURCES, **THERMAL),
                    steps=3)


@pytest.fixture(scope="module")
def rk2_parity_buoyant():
    return run_both("rk2", SHAPE, "parity",
                    dict(SOURCES, beta=3e-3, T_ref=300.0,
                         gravity=(0.0, -9.81, 0.0)))


@pytest.fixture(scope="module")
def rk4_consistent_thermal():
    return run_both("rk4", SHAPE, "consistent", dict(SOURCES, **THERMAL))


def test_euler_parity_matches_fused_reference(euler_parity):
    assert_fields(euler_parity, 2e-5)


def test_euler_consistent_energy_three_steps(euler_consistent_thermal):
    """Consistent weights, buoyancy and the unclamped consistent energy
    stencils with mixed thermal faces, three steps: within 1e-4."""
    assert_fields(euler_consistent_thermal, 1e-4)


def test_rk2_parity_buoyant_matches_fused_reference(rk2_parity_buoyant):
    assert_fields(rk2_parity_buoyant, 5e-5)


def test_rk4_consistent_energy_matches_fused_reference(
        rk4_consistent_thermal):
    assert_fields(rk4_consistent_thermal, 5e-5)
