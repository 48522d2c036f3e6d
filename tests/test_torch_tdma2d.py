"""The port's 2D spectral pieces against the reference: the y-line Thomas
solve (against the reference's Pallas kernel in interpret mode and its
jnp scan), the x-DST factors, and the whole y-solve (Thomas + dense
low-mode rescue) at 1024×32, where the rescue is narrower than mx so both
stages do work.

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
from cfd_tpu_torch import CFDError, Status
from cfd_tpu_torch.ops.kernels import rolling, tdma
from cfd_tpu_torch.solvers.poisson import spectral
from cfd_tpu_torch.solvers.poisson.base import PoissonProblem

torch.set_num_threads(min(2, torch.get_num_threads()))


def _problems(ny, nx):
    h = (1.0 / (nx - 1), 1.0 / (ny - 1))
    return PoissonProblem(nx, ny, 1, *h), JProblem(nx, ny, 1, *h)


def _line_system(ny, nx, seed, np_dt):
    """A zero-shell (ny, nx) rhs with zero spare-mode columns, and the
    per-mode μ (λx padded with its edge value) and w = 1/dy²."""
    port, _ = _problems(ny, nx)
    mx = nx - 2
    lx = spectral._dirichlet_eigenvalues(mx, port.inv_dx2)
    mu = np.pad(lx, (0, nx - mx), mode="edge").astype(np_dt)
    r = np.random.default_rng(seed).normal(0.0, 1.0, (ny, nx))
    r[0] = r[-1] = 0.0
    r[:, mx:] = 0.0
    return r.astype(np_dt), mu, float(port.inv_dy2)


def test_tdma_y_2d_matches_pallas_kernel():
    """float32 at ny = 32, Mx = 1024 against `make_tdma_y_2d` in interpret
    mode: the same recurrence in the same operation order, so agreement
    to rtol 1e-6 (with an absolute floor of 1e-6·max|x| for entries that
    cancel to near zero)."""
    r, mu, w = _line_system(32, 1024, 0, np.float32)
    fn = jtdma.make_tdma_y_2d(32, 1024, mu, w, jnp.float32, interpret=True)
    assert fn is not None
    x_ref = np.asarray(fn(jnp.asarray(r)))
    x = tdma.tdma_y_2d(torch.tensor(r), torch.tensor(mu), w)  # plain on CPU
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-6,
                               atol=1e-6 * np.abs(x_ref).max())


@pytest.mark.parametrize("shape", [(32, 1024), (24, 200), (3, 5),
                                   (23, 37), (37, 23)])
def test_tdma_y_2d_matches_scan_reference(shape):
    """float64 against the reference's `tdma_z_reference` on the same
    lines (rows as planes): agreement to rounding, rtol 1e-12; mirror
    y-shells.  The wrapper on a CPU tensor is the plain version bit for
    bit."""
    ny, nx = shape
    r, mu, w = _line_system(ny, nx, 1, np.float64)
    x_ref = np.asarray(jtdma.tdma_z_reference(
        jnp.asarray(r)[:, None, :], jnp.asarray(mu)[None, :], w))[:, 0, :]
    x = tdma.tdma_y_2d_reference(torch.tensor(r), torch.tensor(mu), w)
    assert torch.equal(tdma.tdma_y_2d(torch.tensor(r), torch.tensor(mu), w),
                       x)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(x[0].numpy(), x[1].numpy())
    np.testing.assert_array_equal(x[-1].numpy(), x[-2].numpy())


@pytest.mark.parametrize("shape,k", [((32, 1024), 128), ((24, 200), 128),
                                     ((32, 128), 126), ((33, 33), 31)])
def test_rescue_width_matches_reference(shape, k):
    """The rescue width is the reference's function of (mx, λx, w); at
    128×32 and 33² it covers every mode (K == mx: no Thomas launch)."""
    ny, nx = shape
    port, _ = _problems(ny, nx)
    lx = spectral._dirichlet_eigenvalues(nx - 2, port.inv_dx2)
    w = float(port.inv_dy2)
    assert spectral._tdma2d_rescue_width(nx - 2, lx, w) == k
    assert jspec._tdma2d_rescue_width(nx - 2, lx, w) == k


@pytest.fixture(scope="module")
def pieces_1024x32():
    port, ref = _problems(32, 1024)
    assert jspec.dst2d_fused_supported(ref)
    return (spectral.make_dst2d_fused_pieces(port, torch.float32),
            jspec.make_dst2d_fused_pieces(ref, jnp.float32, interpret=True))


def test_dst2d_factors_equal_reference(pieces_1024x32):
    """Where the reference's gate holds (nx % 1024 == 0) the port's x-DST
    factors are the reference's float32 matrices exactly (tolerance 0)."""
    (fxt, gxt, _), (rfxt, rgxt, _) = pieces_1024x32
    for a, b in ((fxt, rfxt), (gxt, rgxt)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


def test_ysolve_matches_reference(pieces_1024x32):
    """The y-solve at 1024×32 (K = 128 < mx = 1022: Thomas on every
    column, then the rescue on the first 128) against the reference's
    `make_dst2d_fused_pieces(...)[2]` with its Pallas Thomas kernel in
    interpret mode.  The Thomas columns agree to rounding; the rescue
    columns sum 30–32 terms in another order, so the bar is 1e-6 of
    max|x̂|."""
    (_, _, ysolve), (_, _, rysolve) = pieces_1024x32
    r, _, _ = _line_system(32, 1024, 2, np.float32)
    x_ref = np.asarray(rysolve(jnp.asarray(r)[None]))
    x = ysolve(torch.tensor(r)[None])
    assert x.shape == (1, 32, 1024)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=0,
                               atol=1e-6 * np.abs(x_ref).max())


@pytest.mark.parametrize("shape", [(24, 200), (16, 33)])
def test_dst2d_solve_matches_eigen_pipeline(shape):
    """x-DST → y-solve → mirror-extended inverse x-DST, float64, against
    the reference's all-DST 2D eigen pipeline (`_make_btilde_pipeline`) on
    grids the reference's fused gate rejects — two exact direct solves of
    one system, so agreement to rounding, atol 1e-10 on a unit-scale
    rhs.  200×24 runs Thomas and the rescue; 33×16 only the rescue."""
    ny, nx = shape
    port, ref = _problems(ny, nx)
    assert not jspec.dst2d_fused_supported(ref)
    b = np.random.default_rng(5).normal(0.0, 1.0, (1, ny, nx))
    b[:, 0] = b[:, -1] = 0.0
    b[:, :, 0] = b[:, :, -1] = 0.0
    x_ref = np.asarray(jspec._make_btilde_pipeline(
        ref, lax.Precision.HIGHEST)(jnp.asarray(b)))
    fxt, gxt, ysolve = spectral.make_dst2d_fused_pieces(port, torch.float64)
    x = rolling.right_dot(ysolve(rolling.right_dot(torch.tensor(b), fxt)),
                          gxt)
    assert x.shape == (1, ny, nx)
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-10, rtol=0)


def test_dst2d_pieces_refuse_3d():
    port = PoissonProblem(16, 16, 8, 1.0 / 15, 1.0 / 15, 1.0 / 7)
    assert not spectral.dst2d_fused_supported(port)
    with pytest.raises(CFDError) as err:
        spectral.make_dst2d_fused_pieces(port, torch.float32)
    assert err.value.status == Status.ERROR_UNSUPPORTED
