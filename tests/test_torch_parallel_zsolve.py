"""The sharded z-solve of the z-decomposed spectral step
(`cfd_tpu_torch.solvers.poisson.spectral.make_dst_fused_sharded_pieces`):
the y-pencil ``all_to_all``, the call-time-μ Thomas solve on each shard's
rows of the eigenvalue plane, the ``all_to_all`` back.

* Against the reference's ``make_dst_fused_sharded_pieces`` z-solve run
  inside ``shard_map`` over P = 2 and 4 virtual devices (float32, its
  Thomas kernel in interpret mode), at 1e-6 of max|x̂| (the same
  recurrence, the same float32 coefficients); its factors equal the
  reference's.
* Against the single-device port z-solve (`tdma.make_tdma_z` on the whole
  field) in float64: at most 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from cfd_tpu.parallel.mesh import make_mesh as j_make_mesh
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.spectral import \
    make_dst_fused_sharded_pieces as j_pieces
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.parallel import LocalComm
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem
from cfd_tpu_torch.solvers.poisson.spectral import (
    dst_fused_sharded_supported, make_dst_fused_pieces,
    make_dst_fused_sharded_pieces)

CPU = torch.device("cpu")
NX, NY, NZ = 128, 32, 16
H = (1.0 / (NX - 1), 1.0 / (NY - 1), 1.0 / (NZ - 1))


def _rhs(dtype, seed=5):
    rng = np.random.default_rng(seed)
    r = rng.normal(0.0, 1.0, (NZ, NY, NX)).astype(dtype)
    r[0] = r[-1] = 0.0          # zero global z-shells, as the step gives
    return r


@pytest.mark.parametrize("P", [2, 4])
def test_zsolve_matches_reference_sharded_zsolve(P):
    r = _rhs(np.float32)
    jmats, jzs = j_pieces(JProblem(NX, NY, NZ, *H), P, axis_name="z",
                          dtype=jnp.float32, interpret=True)
    mesh = j_make_mesh(jax.devices()[:P], axes=("z",))
    ref = np.asarray(jax.shard_map(jzs, mesh=mesh, in_specs=JP("z"),
                                   out_specs=JP("z"),
                                   check_vma=False)(jnp.asarray(r)))
    comm = LocalComm([CPU] * P)
    mats, zs = make_dst_fused_sharded_pieces(
        PoissonProblem(NX, NY, NZ, *H), P, comm, torch.float32)
    got = torch.cat(zs(list(torch.from_numpy(r).chunk(P)))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    for m, jm in zip(mats[0], jmats):
        np.testing.assert_array_equal(m.numpy(), jm)


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_zsolve_is_the_single_device_solve_float64(P):
    problem = PoissonProblem(NX, NY, NZ, *H)
    r = torch.from_numpy(_rhs(np.float64, seed=P))
    _, zsolve_1 = make_dst_fused_pieces(problem, torch.float64, CPU,
                                        fuse_fwd=False)
    _, zs = make_dst_fused_sharded_pieces(problem, P, LocalComm([CPU] * P),
                                          torch.float64)
    got = torch.cat(zs(list(r.chunk(P))))
    assert float((got - zsolve_1(r)).abs().max()) <= 1e-12


def test_sharded_pieces_gate():
    """The port's gate: nz and ny divisible by P, >= 2 planes a shard, 3D
    (the reference's nx % 128 / ny % 8 TPU gates are not kept)."""
    ok = PoissonProblem(20, 12, 8, 0.1, 0.1, 0.1)
    assert dst_fused_sharded_supported(ok, 4)
    assert not dst_fused_sharded_supported(ok, 8)       # 1 plane a shard
    assert not dst_fused_sharded_supported(
        PoissonProblem(20, 10, 8, 0.1, 0.1, 0.1), 4)    # ny % 4
    assert not dst_fused_sharded_supported(
        PoissonProblem(20, 12, 1, 0.1, 0.1), 1)         # 2D
    with pytest.raises(CFDError):
        make_dst_fused_sharded_pieces(
            PoissonProblem(20, 10, 8, 0.1, 0.1, 0.1), 4,
            LocalComm([CPU] * 4))
