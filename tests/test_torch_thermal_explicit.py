"""The explicit Euler, RK2 and RK4 steps with the energy equation,
Boussinesq buoyancy and thermal faces (Dirichlet, Neumann and periodic
faces mixed) against the reference's:

* against its fused steps (interpret mode, float32, 128×16×8 and 128×32,
  the reference kernels' gates) within the reference's fused bars (2e-6
  in 3D and 1e-6 in 2D for Euler, `tests/math/test_euler_fused.py:54`;
  5e-6 / 1e-6 for RK, the port's RK tests) on the velocities and p, and
  the same bars relative to T's scale (~300) on T, after two steps
  (RK2 and RK4 in `test_torch_thermal_rk2.py` and
  `test_torch_thermal_rk4.py`, on these helpers);
* against its jnp steps in float64 on small unaligned grids (8×6×5 and
  8×6), within 1e-12, with two face mixes; the corners and edges of the
  thermal faces included.

Gravity has a z component in 3D only.

Both packages get the same numpy inputs."""

import functools

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
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns import euler as jeuler
from cfd_tpu.solvers.ns import rk as jrk
from cfd_tpu_torch import Grid
from cfd_tpu_torch.interop import field_from_numpy, field_to_numpy
from cfd_tpu_torch.solvers.ns import euler, rk
from cfd_tpu_torch.solvers.ns.params import NSParams

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "rho", "T")
DIAGS = ("max_velocity", "max_pressure", "max_temperature")
SHAPES = {"3d": (8, 16, 128), "2d": (1, 32, 128)}
SMALL = {"3d": (5, 6, 8), "2d": (1, 6, 8)}
BARS = {("euler", "3d"): 2e-6, ("euler", "2d"): 1e-6,
        ("rk2", "3d"): 5e-6, ("rk2", "2d"): 1e-6,
        ("rk4", "3d"): 5e-6, ("rk4", "2d"): 1e-6}
MAKERS = {"euler": (jeuler.make_euler_step, euler.make_euler_step),
          "rk2": (jrk.make_rk2_step, rk.make_rk2_step),
          "rk4": (jrk.make_rk4_step, rk.make_rk4_step)}
# (left, right, bottom, top, back, front)
FACES = {"mixed": ("DIRICHLET", "NEUMANN", "NEUMANN", "DIRICHLET",
                   "NEUMANN", "DIRICHLET"),
         "mixed_periodic": ("NEUMANN", "PERIODIC", "DIRICHLET", "NEUMANN",
                            "PERIODIC", "NEUMANN")}
VALUES = dict(left=301.0, right=299.5, bottom=298.0, top=302.0,
              back=297.5, front=303.0)
THERMAL = dict(alpha=2e-2, beta=3e-3, T_ref=300.0)
GRAVITY = {"3d": (0.5, -9.81, 2.0), "2d": (0.5, -9.81, 0.0)}


def params_pair(faces="mixed", dim="3d"):
    names = ("left", "right", "bottom", "top", "back", "front")
    jc = JT(**{n: JB[t] for n, t in zip(names, FACES[faces])},
            dirichlet_values=JD(**VALUES))
    jp = JParams(**THERMAL, gravity=GRAVITY[dim], thermal_bc=jc)
    return jp, NSParams.from_fields(jp)


def _grids(shape):
    nz, ny, nx = shape
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    return JGrid.uniform(nx, ny, nz, **kw), Grid.uniform(nx, ny, nz, **kw)


def _arrays(shape, seed, np_dt, w_zero=False):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, 0.3, shape).astype(np_dt) for n in "uvwp"}
    if w_zero:
        out["w"] = np.zeros(shape, np_dt)
    out["rho"] = np.ones(shape, np_dt)
    out["T"] = (300.0 + rng.normal(0.0, 1.0, shape)).astype(np_dt)
    return out


def run_pair(method, shape, np_dt, fused, steps=2, faces="mixed",
             dt=5e-5, w_zero=False, seed=1):
    jg, tg = _grids(shape)
    jp, tp = params_pair(faces, "3d" if shape[0] > 1 else "2d")
    jdt = jnp.float32 if np_dt == np.float32 else jnp.float64
    tdt = torch.float32 if np_dt == np.float32 else torch.float64
    jkw = dict(use_pallas=True, pallas_interpret=True) if fused else dict(
        use_pallas=False)
    jstep = jax.jit(MAKERS[method][0](jg, jp, dtype=jdt, **jkw))
    tstep = MAKERS[method][1](tg, tp, dtype=tdt, device="cpu")
    a = _arrays(shape, seed, np_dt, w_zero)
    jf = JField(**{n: jnp.asarray(x) for n, x in a.items()})
    tf = field_from_numpy(a, "cpu", tdt)
    for i in range(steps):
        jf, jr = jstep(jf, dt, i)
        tf, tr = tstep(tf, dt, i)
        assert int(jr.status) == int(tr.status) == 0
    return jf, jr, tf, tr


def assert_close(jf, jr, tf, tr, atol, rtol_diag):
    out = field_to_numpy(tf)
    for n in NAMES:
        scale = 300.0 if n == "T" else 1.0
        np.testing.assert_allclose(out[n], np.asarray(getattr(jf, n)),
                                   rtol=0, atol=atol * scale, err_msg=n)
    for d in DIAGS:
        np.testing.assert_allclose(float(getattr(tr, d)),
                                   float(getattr(jr, d)), rtol=rtol_diag,
                                   err_msg=d)


def check_fused(method, dim):
    jf, jr, tf, tr = run_pair(method, SHAPES[dim], np.float32, True)
    assert_close(jf, jr, tf, tr, BARS[method, dim], 1e-6)


@pytest.mark.parametrize("dim", ["3d", "2d"])
def test_matches_fused_reference_f32(dim):
    check_fused("euler", dim)


@functools.lru_cache(maxsize=None)
def _jnp_pair(method, dim, faces):
    # the reference's jnp 2D Euler step wraps w's shells where its fused
    # kernel passes them through (the port follows the kernel; ROADMAP
    # §C): in 2D w starts at 0 and g_z = 0 keeps it there
    return run_pair(method, SMALL[dim], np.float64, False, faces=faces,
                    dt=1e-3, w_zero=dim == "2d")


@pytest.mark.parametrize("faces", sorted(FACES))
@pytest.mark.parametrize("dim", ["3d", "2d"])
@pytest.mark.parametrize("method", ["euler", "rk2", "rk4"])
def test_matches_jnp_reference_f64(method, dim, faces):
    """Two steps within 1e-12 (1e-12 relative on T)."""
    jf, jr, tf, tr = _jnp_pair(method, dim, faces)
    assert_close(jf, jr, tf, tr, 1e-12 / 300.0, 1e-12)


def test_energy_changes_the_temperature_and_faces_hold():
    """The update is not a no-op: T moves in the interior, the Dirichlet
    faces hold their values on the last writer's points, and the Neumann
    faces copy their neighbour."""
    jf, jr, tf, tr = _jnp_pair("euler", "3d", "mixed")
    a = _arrays(SMALL["3d"], 1, np.float64)
    T = tf.T.numpy()
    assert np.abs(T[1:-1, 1:-1, 1:-1] - a["T"][1:-1, 1:-1, 1:-1]).max() > 0
    np.testing.assert_array_equal(T[-1], VALUES["front"])        # z last
    np.testing.assert_array_equal(T[0], T[1])                    # back
    np.testing.assert_array_equal(T[1:-1, -1, :], VALUES["top"])  # y next
    np.testing.assert_array_equal(T[1:-1, 0, :], T[1:-1, 1, :])
    np.testing.assert_array_equal(T[1:-1, 1:-1, 0], VALUES["left"])
    np.testing.assert_array_equal(T[1:-1, 1:-1, -1], T[1:-1, 1:-1, -2])
