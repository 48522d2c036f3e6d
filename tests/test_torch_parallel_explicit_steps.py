"""The decomposed explicit steps (`cfd_tpu_torch.parallel.fused_explicit`
through ``make_sharded_step(..., "explicit_euler" | "rk2" | "rk4")``,
plain versions on `LocalComm` CPU shards) against the reference's
single-device jnp step (``use_pallas=False``), float32, on the CPU.

Euler, RK2 and RK4 over 4 z-shards and over the (2, 2) mesh at
16×16×32 (4 and 8 planes, 8 rows a shard) and over 4 y-shards at 32×16
(4 rows a shard), random u, v, w, p and the default sources (the 2D
field with w = 0: the reference's jnp 2D step wraps w's shells, the
port passes them through), two steps of dt = 1e-4: the fields within
5e-6, the reference's own sharded-vs-jnp bar
(`tests/parallel/test_fused_sharded.py:222-224`; its RK4 case holds
1e-5), the diagnostics within rtol 1e-6.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.euler import make_euler_step as j_euler
from cfd_tpu.solvers.ns.rk import make_rk2_step as j_rk2
from cfd_tpu.solvers.ns.rk import make_rk4_step as j_rk4
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import make_mesh, make_sharded_step
from cfd_tpu_torch.solvers.ns.params import NSParams

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
NAMES = ("u", "v", "w", "p", "rho", "T")
J_MAKERS = {"explicit_euler": j_euler, "rk2": j_rk2, "rk4": j_rk4}
MESHES = {"4z": lambda: make_mesh([CPU] * 4, axes=("z",)),
          "2x2": lambda: make_mesh([CPU] * 4),
          "4y": lambda: make_mesh([CPU] * 4, axes=("y",))}
TOL = 5e-6


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    out = {n: rng.normal(0.0, 0.2, shape).astype(np.float32)
           for n in "uvwp"}
    if shape[0] == 1:
        out["w"] = np.zeros(shape, np.float32)
    out["rho"] = np.ones(shape, np.float32)
    out["T"] = np.full(shape, 300.0, np.float32)
    return out


def _jgrid(two_d):
    return (JGrid.uniform(32, 16) if two_d
            else JGrid.uniform(32, 16, 16, zmin=0.0, zmax=1.0))


@functools.lru_cache(maxsize=None)
def _reference(method, two_d):
    """The reference's two jnp steps from ``_arrays``: (field, result)."""
    jgrid = _jgrid(two_d)
    # eager: two steps of a small grid take less than the jit's compile
    jstep = J_MAKERS[method](jgrid, JParams(), dtype=jnp.float32,
                             use_pallas=False)
    jf = JField(**{n: jnp.asarray(a)
                   for n, a in _arrays(jgrid.shape, 3).items()})
    for it in range(2):
        jf, jres = jstep(jf, 1e-4, it)
    return jf, jres


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("method", list(J_MAKERS))
def test_sharded_explicit_step_matches_reference_jnp(method, mesh_name):
    two_d = mesh_name == "4y"
    jgrid = _jgrid(two_d)
    jf, jres = _reference(method, two_d)
    step, place = make_sharded_step(grid_from(jgrid), NSParams(),
                                    MESHES[mesh_name](), method,
                                    dtype=torch.float32)
    fs = place(field_from_numpy(_arrays(jgrid.shape, 3), "cpu",
                                torch.float32))
    for it in range(2):
        fs, res = step(fs, 1e-4, it)
    assert int(res.status) == int(jres.status) == 0
    g = fs.gather()
    for n in NAMES:
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jf, n)), rtol=0,
                                   atol=TOL, err_msg=n)
    for a in ("max_velocity", "max_pressure", "max_temperature"):
        np.testing.assert_allclose(float(getattr(res, a)),
                                   float(getattr(jres, a)), rtol=1e-6,
                                   err_msg=a)
