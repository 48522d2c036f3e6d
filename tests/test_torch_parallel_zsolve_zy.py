"""The (z, y)-decomposed y/z spectral solve (`cfd_tpu_torch.solvers.
poisson.spectral.make_dst_fused_sharded_zy_pieces`) against the
reference's (`cfd_tpu/solvers/poisson/spectral.py:565-665`), on the CPU.

Composed with its own x transforms (b̃ · FxT, the solve, x̂ · GxT) on
each shard of (2, 4), (4, 2), (2, 2) and (1, 2) meshes — a degenerate z
axis included — it equals the reference's pieces in ``jax.shard_map`` on
the same mesh, and the single-device eigen pipeline, at 1e-11 in float64
(the model: `tests/parallel/test_fused_sharded.py:926-965`).  The
support gate keeps the transposes' divisibility and drops the TPU's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.spectral import \
    make_dst_fused_sharded_zy_pieces as j_pieces
from cfd_tpu_torch.core.status import CFDError
from cfd_tpu_torch.parallel import make_mesh
from cfd_tpu_torch.solvers.poisson import spectral
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem

NZ, NY, NX = 8, 32, 128
H = (0.05, 0.1, 0.1)
MESHES = [(2, 4), (4, 2), (2, 2), (1, 2)]
CPU = torch.device("cpu")


def _btilde():
    rng = np.random.default_rng(3)
    b = np.zeros((NZ, NY, NX))
    b[1:-1, 1:-1, 1:-1] = rng.normal(size=(NZ - 2, NY - 2, NX - 2))
    return b


def _reference(b, pz, py):
    mats_x, yz = j_pieces(JProblem(NX, NY, NZ, *H), pz, py,
                          dtype=jnp.float64)
    fxt, gxt = (jnp.asarray(m, jnp.float64) for m in mats_x)
    hi = lax.Precision.HIGHEST

    def full(bl):
        xh = yz(jnp.einsum("zyx,xa->zya", bl, fxt, precision=hi))
        return jnp.einsum("zyx,xa->zya", xh, gxt, precision=hi)

    mesh = JMesh(np.array(jax.devices()[:pz * py]).reshape(pz, py),
                 ("z", "y"))
    return np.asarray(jax.jit(jax.shard_map(
        full, mesh=mesh, in_specs=JP("z", "y", None),
        out_specs=JP("z", "y", None), check_vma=False))(jnp.asarray(b)))


def _port(b, pz, py):
    comm = make_mesh([CPU] * (pz * py), shape=(pz, py)).comm
    mats, yz = spectral.make_dst_fused_sharded_zy_pieces(
        PoissonProblem(NX, NY, NZ, *H), pz, py, comm, torch.float64)
    nzl, nyl = NZ // pz, NY // py
    blocks = [torch.from_numpy(np.ascontiguousarray(
        b[zi * nzl:(zi + 1) * nzl, yi * nyl:(yi + 1) * nyl]))
        for zi, yi in map(comm.coords, comm.shards)]
    xt = [blk @ m[0] for blk, m in zip(blocks, mats)]
    out = np.empty_like(b)
    for (zi, yi), xh, m in zip(map(comm.coords, comm.shards), yz(xt), mats):
        assert tuple(xh.shape) == (nzl, nyl, NX)
        out[zi * nzl:(zi + 1) * nzl, yi * nyl:(yi + 1) * nyl] = (
            xh @ m[1]).numpy()
    return out


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_yz_solve_matches_reference_and_single_device(shape):
    b = _btilde()
    got = _port(b, *shape)
    np.testing.assert_allclose(got, _reference(b, *shape), rtol=0,
                               atol=1e-11, err_msg=f"mesh {shape}")
    single = spectral.make_fft_btilde_solver(
        PoissonProblem(NX, NY, NZ, *H), z_mode="eigen")(torch.from_numpy(b))
    np.testing.assert_allclose(got, single.numpy(), rtol=0, atol=1e-11)


def test_support_keeps_the_transposes_divisibility_only():
    prob = PoissonProblem(NX, NY, NZ, *H)
    supported = spectral.dst_fused_sharded_zy_supported
    assert supported(prob, 2, 4)
    # the x-mode all_to_all over Pz = 3 cannot split nx = 128
    assert not supported(PoissonProblem(128, 32, 6, *H), 3, 2)
    # ny % Py, and the 2-row minimum of the predictor's halo
    assert not supported(prob, 2, 3)
    assert not supported(PoissonProblem(128, 32, 8, *H), 1, 32)
    # the TPU's gates are dropped: 4 rows a shard, nx not a multiple of 128
    assert supported(PoissonProblem(128, 16, 8, *H), 2, 4)
    assert supported(PoissonProblem(40, 16, 8, *H), 2, 4)
    with pytest.raises(CFDError, match="divisible"):
        spectral.make_dst_fused_sharded_zy_pieces(
            PoissonProblem(128, 32, 6, *H), 3, 2,
            make_mesh([CPU] * 6, shape=(3, 2)).comm, torch.float64)
