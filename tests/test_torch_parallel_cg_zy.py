"""The (z, y)-decomposed CG solve and step (`cfd_tpu_torch.parallel.
fused_cg` with Py > 1, plain versions on `LocalComm` CPU shards) against
the reference's on a (z, y) mesh of its 8 virtual devices, its kernels in
interpret mode.

* The solve at 128×32×8 float32, tolerance 1e-3, over (2, 4), (4, 2) and
  (2, 2) (`tests/parallel/test_fused_cg_sharded.py:159-178`): status 0,
  the reference's iteration count, x within 2e-5.
* Float64 against the port's one-device plain CG at a fixed 25
  iterations (``check_interval`` 25): the same count, x within 1e-10 —
  the Neumann faces on the edge shards, the global Dirichlet-0 space on
  global rows and the owned-point dots.
* The (2, 4) CG step against the reference's one-device CG step
  (`:180-215`): u, v, w within 1e-5, p within 2e-4, status 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.parallel.fused_cg import \
    make_cg_fused_sharded as j_make_cg_fused_sharded
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_projection_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import (gather_field, make_cg_fused_sharded,
                                    make_mesh, make_sharded_step)
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem)
from cfd_tpu_torch.solvers.poisson.krylov import make_cg

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = torch.device("cpu")
SHAPE = (8, 32, 128)              # (nz, ny, nx)
H = (1.0 / 127, 1.0 / 31, 1.0 / 7)
MESHES = [(2, 4), (4, 2), (2, 2)]


def _jmesh(pz, py):
    return JMesh(np.array(jax.devices()[:pz * py]).reshape(pz, py),
                 ("z", "y"))


def _mesh(pz, py):
    return make_mesh([CPU] * (pz * py), shape=(pz, py))


def _rhs(seed=5):
    """`tests/parallel/test_fused_cg_sharded.py:37-44`'s rhs."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0.0, 1.0, SHAPE)
    r[0] = r[-1] = 0.0
    r[:, 0] = r[:, -1] = 0.0
    r[:, :, 0] = r[:, :, -1] = 0.0
    r -= r[1:-1, 1:-1, 1:-1].mean()
    return r


@pytest.fixture(scope="module")
def reference_solves():
    rhs = jnp.asarray(_rhs(), jnp.float32)
    x0 = jnp.zeros(SHAPE, jnp.float32)
    out = {}
    for shape in MESHES:
        res = jax.jit(j_make_cg_fused_sharded(
            JProblem(128, 32, 8, *H), JPParams(tolerance=1e-3,
                                               max_iterations=400),
            _jmesh(*shape)))(x0, rhs)
        out[shape] = (int(res.status), int(res.iterations),
                      np.asarray(res.x))
    return out


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_zy_cg_matches_reference(reference_solves, shape):
    status, iters, x_ref = reference_solves[shape]
    solve = make_cg_fused_sharded(
        PoissonProblem(128, 32, 8, *H),
        PoissonParams(tolerance=1e-3, max_iterations=400), _mesh(*shape))
    res = solve(torch.zeros(SHAPE), torch.from_numpy(_rhs()).float())
    assert int(res.status) == status == 0
    assert int(res.iterations) == iters
    np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=0, atol=2e-5,
                               err_msg=f"mesh {shape}")


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_zy_cg_float64_is_the_one_device_cg(shape):
    prob = PoissonProblem(128, 32, 8, *H)
    params = PoissonParams(tolerance=0.0, max_iterations=25,
                           check_interval=25)
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.normal(size=SHAPE))
    rhs = torch.from_numpy(_rhs(seed=6))
    ref = make_cg(prob, params, device="cpu")(x0, rhs)
    res = make_cg_fused_sharded(prob, params, _mesh(*shape))(x0, rhs)
    assert int(res.iterations) == int(ref.iterations) == 25
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-10)
    assert float(res.final_residual) == pytest.approx(
        float(ref.final_residual), rel=1e-8)


def test_zy_cg_step_matches_reference_single_device():
    rng = np.random.default_rng(21)
    arrays = {n: rng.normal(0.0, 0.1, SHAPE).astype(np.float32)
              for n in "uvw"}
    jgrid = JGrid.uniform(128, 32, 8, zmin=0.0, zmax=1.0)
    jf = JField.initialize(jgrid, dtype=jnp.float32)
    jf = jf.replace(**{n: jnp.asarray(a) for n, a in arrays.items()})
    pparams = dict(tolerance=1e-6, max_iterations=800)
    fr, rr = jax.jit(j_make_projection_step(
        jgrid, JParams(), dtype=jnp.float32, poisson_method=JMethod.CG,
        poisson_params=JPParams(**pparams)))(jf, 1e-3, 0)
    grid = grid_from(jgrid)
    f = field_from_numpy({n: getattr(jf, n) for n in ("u", "v", "w", "p",
                                                      "rho", "T")},
                         device="cpu")
    step, place = make_sharded_step(
        grid, NSParams(), _mesh(2, 4), "projection",
        dtype=torch.float32, poisson_method=Method.CG,
        poisson_params=PoissonParams(**pparams))
    fs, res = step(place(f), 1e-3, 0)
    g = gather_field(fs)
    assert int(res.status) == int(rr.status) == 0
    for name in "uvw":
        np.testing.assert_allclose(getattr(g, name).numpy(),
                                   np.asarray(getattr(fr, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(g.p.numpy(), np.asarray(fr.p), rtol=0,
                               atol=2e-4)
