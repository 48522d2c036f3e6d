"""``nonuniform_scheme="consistent"`` on a uniform grid is the parity
step, in both packages (`projection.py:168-169`, `common.py:89`): the
two schemes coincide there.  The port raised ERROR_UNSUPPORTED for it
until the stretched-grid slice; here its projection (FFT_DIRECT, CG; 3D
and 2D), Euler, RK2 and RK4 steps with the consistent scheme give the
parity step's fields bit for bit, the energy equation included, as the
reference's do, and match the reference's within its float64 bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.euler import make_euler_step as j_euler
from cfd_tpu.solvers.ns.projection import make_projection_step as j_proj
from cfd_tpu.solvers.ns.rk import make_rk2_step as j_rk2
from cfd_tpu.solvers.ns.rk import make_rk4_step as j_rk4
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.solvers.ns.euler import make_euler_step
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.ns.rk import make_rk2_step, make_rk4_step
from cfd_tpu_torch.solvers.poisson.base import Method

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("u", "v", "w", "p", "T")
SHAPES = {"3d": (10, 20, 24), "2d": (1, 20, 24)}


def _proj(method):
    def j(g, p):
        return j_proj(g, p, jnp.float64, JMethod[method.name],
                      use_pallas=False)

    def t(g, p):
        return make_projection_step(g, p, torch.float64, method,
                                    device="cpu")
    return j, t


def _explicit(jmk, tmk):
    return (lambda g, p: jmk(g, p, jnp.float64, use_pallas=False),
            lambda g, p: tmk(g, p, torch.float64, "cpu"))


STEPS = {"projection_fft": _proj(Method.FFT_DIRECT),
         "projection_cg": _proj(Method.CG),
         "euler": _explicit(j_euler, make_euler_step),
         "rk2": _explicit(j_rk2, make_rk2_step),
         "rk4": _explicit(j_rk4, make_rk4_step)}


def _fields(shape):
    rng = np.random.default_rng(4)
    out = {n: rng.normal(0.0, 0.1, shape) for n in "uvw"}
    out["p"] = 1.0 + rng.normal(0.0, 0.1, shape)
    out["rho"] = np.ones(shape)
    out["T"] = 300.0 + rng.normal(0.0, 1.0, shape)
    return out


# every step in 3D and 2D, and in 3D with buoyancy and the energy
# equation
CASES = [(k, d, False) for k in sorted(STEPS) for d in sorted(SHAPES)] + [
    (k, "3d", True) for k in sorted(STEPS)]


@pytest.mark.parametrize("kind,dim,energy", CASES,
                         ids=[f"{k}-{d}-{'energy' if e else 'plain'}"
                              for k, d, e in CASES])
def test_consistent_on_uniform_grid_is_the_parity_step(kind, dim, energy):
    nz, ny, nx = SHAPES[dim]
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    jg = JGrid.uniform(nx, ny, nz, **kw)
    tg = grid_from(jg)
    extra = dict(source_amplitude_u=0.1, source_amplitude_v=0.05)
    if energy:
        extra.update(alpha=1e-3, beta=3e-3, T_ref=300.0,
                     gravity=(0.0, -9.81, 0.0))
    jmk, tmk = STEPS[kind]
    arrays = _fields(SHAPES[dim])
    out = {}
    for scheme in ("parity", "consistent"):
        jp = JParams(nonuniform_scheme=scheme, **extra)
        jstep = jax.jit(jmk(jg, jp))
        tstep = tmk(tg, NSParams.from_fields(jp))
        jf, jr = jstep(JField(**{n: jnp.asarray(a)
                                 for n, a in arrays.items()}), 1e-3, 0)
        tf, tr = tstep(field_from_numpy(arrays, "cpu", torch.float64), 1e-3,
                       0)
        assert int(jr.status) == int(tr.status) == 0
        out[scheme] = ({n: np.array(getattr(jf, n)) for n in NAMES},
                       {n: getattr(tf, n).numpy() for n in NAMES})
    for n in NAMES:
        # the same step in each package ...
        np.testing.assert_array_equal(out["consistent"][0][n],
                                      out["parity"][0][n], err_msg=n)
        np.testing.assert_array_equal(out["consistent"][1][n],
                                      out["parity"][1][n], err_msg=n)
        # ... and the port's against the reference's
        ref, got = out["consistent"]
        r, g = ref[n], got[n]
        if n == "w" and dim == "2d" and kind == "euler":
            r, g = r[:, 1:-1, 1:-1], g[:, 1:-1, 1:-1]   # jnp wraps w
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(r).max()),
                                   err_msg=n)
