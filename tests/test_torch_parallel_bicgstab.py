"""The z-decomposed BiCGSTAB solve and step (`cfd_tpu_torch.parallel.
fused_bicgstab`, ``make_sharded_step(..., poisson_method=Method.BICGSTAB)``,
plain versions on `LocalComm` CPU shards) against the reference's
``make_bicgstab_fused_sharded`` and BiCGSTAB-backed sharded step on a z
mesh of P of the 8 virtual devices, its kernels in interpret mode.

BiCGSTAB's trajectory follows its dots' rounding (the port sums them in
float64, the reference in float32), so the solve is held as the
reference holds its own sharded solve against its one-device one
(`tests/parallel/test_fused_bicgstab_sharded.py:59-97`): status 0,
|Δiterations| ≤ max(5, 30%), x within 2e-5; over a short fixed budget
(8 iterations) the float64 plain solve tracks the reference's jnp loop
at 1e-10.  The step at tolerance 1e-4 (`:122-160`): u, v, w within 1e-4,
p within 2e-3; status −7 when the solve stops at its cap.
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
from cfd_tpu.parallel.fused_bicgstab import \
    make_bicgstab_fused_sharded as j_make_bicgstab_fused_sharded
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.krylov import make_bicgstab as j_make_bicgstab
from cfd_tpu_torch import Status
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.parallel import (
    bicgstab_fused_sharded_unsupported_reason, gather_field,
    make_bicgstab_fused_sharded, make_mesh, make_sharded_step)
from cfd_tpu_torch.solvers.ns.params import NSParams
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
    """The reference's `_rhs` (`test_fused_bicgstab_sharded.py:37-42`)."""
    rng = np.random.default_rng(seed)
    r = np.zeros(SHAPE)
    r[1:-1, 1:-1, 1:-1] = rng.normal(0.0, 1.0,
                                     tuple(s - 2 for s in SHAPE))
    r -= r[1:-1, 1:-1, 1:-1].mean()
    return r.astype(dtype)


def test_supported():
    prob, _ = _problems()
    assert bicgstab_fused_sharded_unsupported_reason(prob, 8) is None
    p2 = PoissonProblem(128, 16, 1, 0.01, 0.01, 0.0)
    assert "3D" in bicgstab_fused_sharded_unsupported_reason(p2, 8)
    p3 = PoissonProblem(128, 16, 12, 0.01, 0.01, 0.01)
    assert "divisible" in bicgstab_fused_sharded_unsupported_reason(p3, 8)
    # the (z, y) mesh is in the slice: ny = 16 over 4 y-shards
    assert bicgstab_fused_sharded_unsupported_reason(prob, 2, py=4) is None
    assert "y-shards" in bicgstab_fused_sharded_unsupported_reason(
        prob, 2, py=3)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_solve_matches_reference_sharded_bicgstab(P):
    prob, jprob = _problems()
    rhs = _rhs()
    x0 = np.zeros(SHAPE, np.float32)
    jres = jax.jit(j_make_bicgstab_fused_sharded(
        jprob, JPParams(tolerance=1e-3, max_iterations=400), _jmesh(P)))(
        jnp.asarray(x0), jnp.asarray(rhs))
    res = make_bicgstab_fused_sharded(
        prob, PoissonParams(tolerance=1e-3, max_iterations=400),
        _zmesh(P))(torch.from_numpy(x0), torch.from_numpy(rhs))
    assert int(res.status) == int(jres.status) == 0
    assert abs(int(res.iterations) - int(jres.iterations)) \
        <= max(5, int(0.3 * int(jres.iterations)))
    np.testing.assert_allclose(float(res.initial_residual),
                               float(jres.initial_residual), rtol=1e-5)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=2e-5)


def test_float64_plain_tracks_reference_jnp_bicgstab():
    """A fixed short budget from a random start: the plain sharded solve
    in float64 against the reference's jnp loop (shells kept)."""
    prob, jprob = _problems()
    params = dict(tolerance=0.0, absolute_tolerance=0.0, max_iterations=8,
                  check_interval=8)
    rhs = _rhs(seed=3, dtype=np.float64)
    x1 = np.random.default_rng(9).normal(0.0, 1.0, SHAPE)
    jres = jax.jit(j_make_bicgstab(jprob, JPParams(**params)))(
        jnp.asarray(x1), jnp.asarray(rhs))
    res = make_bicgstab_fused_sharded(prob, PoissonParams(**params),
                                      _zmesh(4))(torch.from_numpy(x1),
                                                 torch.from_numpy(rhs))
    assert res.x.dtype == torch.float64
    assert int(res.iterations) == int(jres.iterations) == 8
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10)


def _step_pair(P, pp, jpp, seed=31):
    """The port's and the reference's sharded BiCGSTAB steps at
    128×16×16 and the reference's random start."""
    jgrid = JGrid.uniform(128, 16, 16, zmin=0.0, zmax=1.0)
    rng = np.random.default_rng(seed)
    arrays = random_arrays(jgrid.shape, seed=seed)
    arrays.update({n: rng.normal(0, 0.1, jgrid.shape).astype(np.float32)
                   for n in "uvwp"})
    jstep, jplace = j_make_sharded_step(
        jgrid, JParams(), _jmesh(P), "projection", use_pallas=True,
        strict=True, dtype=jnp.float32, poisson_method=JMethod.BICGSTAB,
        poisson_params=jpp)
    step, place = make_sharded_step(
        grid_from(jgrid), NSParams(), _zmesh(P), "projection",
        use_pallas=True, strict=True, dtype=torch.float32,
        poisson_method=Method.BICGSTAB, poisson_params=pp)
    jf = jplace(JField(**{n: jnp.asarray(a) for n, a in arrays.items()}))
    fs = place(field_from_numpy(arrays, "cpu", torch.float32))
    return step, fs, jstep, jf


@pytest.mark.parametrize("P", [2, 4])
def test_step_matches_reference_sharded_bicgstab_step(P):
    step, fs, jstep, jf = _step_pair(
        P, PoissonParams(tolerance=1e-4, max_iterations=400),
        JPParams(tolerance=1e-4, max_iterations=400))
    fs, res = step(fs, 1e-3, 0)
    jf, jres = jstep(jf, 0.001, 0)
    assert int(res.status) == int(jres.status) == 0
    g = gather_field(fs)
    for n in "uvw":
        np.testing.assert_allclose(getattr(g, n).numpy(),
                                   np.asarray(getattr(jf, n)), rtol=0,
                                   atol=1e-4, err_msg=n)
    np.testing.assert_allclose(g.p.numpy(), np.asarray(jf.p), rtol=0,
                               atol=2e-3)


def test_step_reports_a_failed_solve_as_the_reference():
    step, fs, jstep, jf = _step_pair(
        2, PoissonParams(tolerance=1e-6, max_iterations=2),
        JPParams(tolerance=1e-6, max_iterations=2))
    _, res = step(fs, 1e-3, 0)
    _, jres = jstep(jf, 0.001, 0)
    assert int(res.status) == int(jres.status) == -7
    assert float(res.residual) > 0.0


@pytest.mark.parametrize("pc", [Precond.JACOBI, Precond.MULTIGRID])
def test_preconditioned_bicgstab_is_refused(pc):
    """The reference's sharded BiCGSTAB takes no preconditioner (its local
    body returns None); the port refuses with that reason."""
    grid = grid_from(JGrid.uniform(40, 16, 8, zmin=0.0, zmax=1.0))
    with pytest.raises(CFDError) as err:
        make_sharded_step(grid, NSParams(), _zmesh(2), "projection",
                          poisson_method=Method.BICGSTAB,
                          poisson_params=PoissonParams(preconditioner=pc))
    assert err.value.status == Status.ERROR_UNSUPPORTED
    assert "BiCGSTAB kernel build failed" in str(err.value)
