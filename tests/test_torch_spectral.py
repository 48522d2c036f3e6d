"""The port's spectral pieces against the reference: the DST-fused host
matrices, the Thomas twins, and the whole transform → Thomas → inverse
solve at a grid the reference's fused gate rejects.

Inputs come from ``np.random.default_rng``; both packages get the same
numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cfd_tpu.ops.pallas import tdma as jtdma
from cfd_tpu.solvers.poisson import spectral as jspec
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch.ops.kernels import rolling, tdma
from cfd_tpu_torch.solvers.poisson import spectral
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem

torch.set_num_threads(min(2, torch.get_num_threads()))


def _problems(nz, ny, nx):
    h = (1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1))
    return (PoissonProblem(nx, ny, nz, *h), JProblem(nx, ny, nz, *h))


@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
def test_dst_mats_equal_reference(np_dt):
    """Where the reference's gate holds (nx % 128, ny % 8) the port's
    matrices, μ plane and w are the reference's exactly (tolerance 0:
    both are the same float64 host formulas cast once)."""
    port, ref = _problems(8, 16, 128)
    assert jspec.dst_fused_supported(ref)
    mats, mu, w = spectral._dst_fused_mats(port, np_dt)
    rmats, rmu, rw = jspec._dst_fused_mats(ref, np_dt)
    for a, b in zip(mats, rmats):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mu, rmu)
    assert w == rw


def test_dst_pieces_equal_reference():
    """make_dst_fused_pieces hands the step the reference's float32
    factors and μ plane, as tensors (tolerance 0)."""
    port, ref = _problems(8, 16, 128)
    mats, (mu, w) = spectral.make_dst_fused_pieces(port, torch.float32)
    rmats, (rmu, rw), _ = jspec.make_dst_fused_pieces(
        ref, jnp.float32, use_kernel=False, fuse_fwd=True)
    for a, b in zip(mats, rmats):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(mu.numpy(), rmu)
    assert w == rw


def _zero_shell_rhs(rng, shape):
    r = rng.normal(0.0, 1.0, shape)
    r[0] = r[-1] = 0.0
    r[:, 0] = r[:, -1] = 0.0
    r[:, :, 0] = r[:, :, -1] = 0.0
    return r


@pytest.mark.parametrize("shape", [(8, 16, 128), (10, 20, 24)])
def test_thomas_twins_match_reference(shape):
    """Full Thomas solve and back substitution, float64: the same
    recurrence in the same operation order as the reference's scans, so
    agreement to rounding (rtol 1e-12)."""
    rng = np.random.default_rng(3)
    port, _ = _problems(*shape)
    _, mu, w = spectral._dst_fused_mats(port, np.float64)
    r = _zero_shell_rhs(rng, shape)

    x_ref = np.asarray(jtdma.tdma_z_reference(jnp.asarray(r),
                                              jnp.asarray(mu), w))
    x = tdma.tdma_z_reference(torch.tensor(r), torch.tensor(mu), w)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-12, atol=0)

    # the wrappers take the plain versions for CPU tensors
    d, t = tdma.tdma_z_fwd(torch.tensor(r), torch.tensor(mu), w)
    assert float(d[0].abs().max()) == float(t[-1].abs().max()) == 0.0
    xb = tdma.tdma_z_bwd(d, t)
    xb_ref = np.asarray(jtdma.tdma_z_bwd_reference(jnp.asarray(d.numpy()),
                                                   jnp.asarray(t.numpy())))
    np.testing.assert_allclose(xb.numpy(), xb_ref, rtol=1e-12, atol=0)
    np.testing.assert_allclose(xb.numpy(), x_ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("shape", [(10, 20, 24), (8, 16, 128)])
def test_transform_solve_matches_eigen_pipeline(shape):
    """Forward DST → Thomas → mirror-extended inverse DST, float64,
    against the reference's all-DST eigen pipeline (`_make_btilde_pipeline`)
    — two exact direct solves of one system, so they agree to rounding of
    the O(n) transform sums: atol 1e-10 on a unit-scale rhs.  At
    24×20×10 the reference's fused gate fails, so this holds the port's
    spare-mode padding (zero F rows / G columns) against the unpadded
    reference."""
    nz, ny, nx = shape
    rng = np.random.default_rng(7)
    port, ref = _problems(*shape)
    if nx % 128:
        assert not jspec.dst_fused_supported(ref)
    b = _zero_shell_rhs(rng, shape)

    x_ref = np.asarray(jspec._make_btilde_pipeline(
        ref, lax.Precision.HIGHEST)(jnp.asarray(b)))
    (fxt, fy, gxt, gy), (mu, w) = spectral.make_dst_fused_pieces(
        port, torch.float64)
    bhat = rolling.plane_dot(torch.tensor(b), fxt, fy)
    xhat = tdma.tdma_z_bwd(*tdma.tdma_z_fwd(bhat, mu, w))
    x = rolling.plane_dot(xhat, gxt, gy)
    assert x.shape == shape
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-10, rtol=0)
