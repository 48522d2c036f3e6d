"""The spectral solver API against the reference's
(`cfd_tpu/solvers/poisson/spectral.py`, `frontend.py`), on the CPU:

* ``make_fft_direct`` (float64 at 1e-12, the shapes of
  `tests/solvers/test_spectral.py:30-43`; float32 at both precisions);
* ``make_fft_btilde_solver`` in its three ``z_mode``s on the shapes of
  `tests/solvers/test_tdma.py:132-166`, with its guards and the
  anisotropic "auto" choice;
* the front end: every ``Method`` inits and solves in both packages.

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.solvers.poisson import frontend as jfrontend
from cfd_tpu.solvers.poisson import spectral as jspec
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch import CFDError, Status
from cfd_tpu_torch.solvers.poisson import frontend, spectral
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem,
                                                PoissonStatus)

torch.set_num_threads(min(2, torch.get_num_threads()))


def _problems(shape, h):
    nz, ny, nx = shape
    return PoissonProblem(nx, ny, nz, *h), JProblem(nx, ny, nz, *h)


def _system(shape, h, seed=1, np_dt=np.float64):
    """(port problem, reference problem, x0, rhs): rhs with a zero shell,
    a random warm start."""
    port, ref = _problems(shape, h)
    rng = np.random.default_rng(seed)
    rhs = np.zeros(shape, np_dt)
    interior = (slice(1, -1) if shape[0] > 1 else slice(None),
                slice(1, -1), slice(1, -1))
    rhs[interior] = rng.standard_normal(rhs[interior].shape)
    x0 = rng.standard_normal(shape).astype(np_dt)
    return port, ref, x0, rhs


SHAPES = [((1, 33, 41), (0.03, 0.025, 0.0)),
          ((17, 21, 25), (0.03, 0.025, 0.04))]


@pytest.mark.parametrize("shape,h", SHAPES, ids=["2d", "3d"])
def test_fft_direct_matches_reference_f64(shape, h):
    """x within 1e-12·max|x|, one iteration, initial residual 0, status
    CONVERGED; the final (CG-convention) residual is rounding noise in
    both, below 1e-8·‖rhs‖ and within 1e-12·‖rhs‖ of each other."""
    port, ref, x0, rhs = _system(shape, h)
    res = spectral.make_fft_direct(port, PoissonParams())(
        torch.as_tensor(x0), torch.as_tensor(rhs))
    jres = jspec.make_fft_direct(ref, JParams())(jnp.asarray(x0),
                                                 jnp.asarray(rhs))
    want = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert int(res.iterations) == int(jres.iterations) == 1
    assert int(res.status) == int(jres.status) == PoissonStatus.CONVERGED
    assert float(res.initial_residual) == float(jres.initial_residual) == 0
    rhs_norm = float(np.sqrt((rhs ** 2).sum()))
    fr, jfr = float(res.final_residual), float(jres.final_residual)
    assert fr < 1e-8 * rhs_norm and jfr < 1e-8 * rhs_norm
    assert abs(fr - jfr) <= 1e-12 * rhs_norm
    off = spectral.make_fft_direct(port, PoissonParams(),
                                   compute_residuals=False)(
        torch.as_tensor(x0), torch.as_tensor(rhs))
    assert torch.equal(off.x, res.x) and float(off.final_residual) == 0.0


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("shape,h", SHAPES, ids=["2d", "3d"])
def test_fft_direct_f32_matches_reference(shape, h, precision):
    """float32: the port's products at "highest" (IEEE fp32) or "high"
    (3xTF32) against the reference's float32 solve, within 2e-5·max|x|
    (the SGEMM bar: another summation order)."""
    port, ref, x0, rhs = _system(shape, h, np_dt=np.float32)
    res = spectral.make_fft_direct(port, PoissonParams(), precision)(
        torch.as_tensor(x0), torch.as_tensor(rhs))
    want = np.asarray(jspec.make_fft_direct(ref, JParams())(
        jnp.asarray(x0), jnp.asarray(rhs)).x)
    assert res.x.dtype == torch.float32
    np.testing.assert_allclose(res.x.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


BTILDE_SHAPES = [((16, 10, 130), 0.07), ((8, 34, 258), 0.11),
                 ((1, 34, 130), 0.0), ((1, 9, 258), 0.0)]


def _btilde(shape, np_dt, seed=7):
    rng = np.random.default_rng(seed)
    bt = np.zeros(shape, np_dt)
    interior = (slice(1, -1) if shape[0] > 1 else slice(None),
                slice(1, -1), slice(1, -1))
    bt[interior] = rng.standard_normal(bt[interior].shape).astype(np_dt)
    return bt


@pytest.mark.parametrize("z_mode", ["eigen", "tdma", "auto"])
@pytest.mark.parametrize("shape,dz", BTILDE_SHAPES,
                         ids=["3d_130", "3d_258", "2d_130", "2d_258"])
def test_btilde_solver_matches_reference(shape, dz, z_mode):
    """Every ``z_mode`` against the reference's eigen pipeline: within
    5e-6·max|x| in float32 (the reference's own tdma-vs-eigen bar) and
    1e-12·max|x| in float64 (two exact solves of one system)."""
    nz, ny, nx = shape
    port, ref = _problems(shape, (0.05, 0.03, dz))
    fn = spectral.make_fft_btilde_solver(port, z_mode=z_mode)
    jfn = jspec.make_fft_btilde_solver(ref)
    for np_dt, tol in ((np.float32, 5e-6), (np.float64, 1e-12)):
        bt = _btilde(shape, np_dt)
        want = np.asarray(jfn(jnp.asarray(bt)))
        got = fn(torch.as_tensor(bt))
        assert got.dtype == torch.as_tensor(bt).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=str(np_dt))


def test_btilde_solver_guards():
    """The stage predicates keep the geometric conditions only; a problem
    that is neither 2D nor genuine 3D, or an unknown mode, raises."""
    p2d, j2d = _problems((1, 34, 130), (0.05, 0.03, 0.0))
    assert not spectral.tdma_z_supported(p2d)
    assert spectral.tdma_y_supported(p2d) == jspec.tdma_y_supported(j2d)
    p3d, j3d = _problems((16, 10, 130), (0.05, 0.03, 0.07))
    assert spectral.tdma_z_supported(p3d) == jspec.tdma_z_supported(j3d)
    assert not spectral.tdma_y_supported(p3d)
    flat, jflat = _problems((3, 9, 9), (0.1, 0.1, 0.0))
    assert spectral.spectral_supported(flat) == \
        jspec.spectral_supported(jflat) is False
    with pytest.raises(ValueError):
        spectral.make_fft_btilde_solver(flat)
    with pytest.raises(ValueError):
        spectral.make_fft_direct(flat, PoissonParams())
    with pytest.raises(ValueError):
        spectral.make_fft_btilde_solver(p2d, z_mode="fft")


def test_auto_keeps_eigen_on_anisotropic_grids():
    """dy ≪ dx drives every x-mode's y-line past the rescue threshold:
    "auto" returns the eigen pipeline (bit for bit), and a forced "tdma"
    degenerates to the full dense y-solve (eigen-class,
    `tests/solvers/test_tdma.py:148-184`)."""
    n = 258
    port, ref = _problems((1, n, n), (1.0, 1.0 / 32.0, 0.0))
    mx = n - 2
    lx = spectral._dirichlet_eigenvalues(mx, port.inv_dx2)
    assert spectral._tdma2d_rescue_width(mx, lx, port.inv_dy2) == mx == \
        jspec._tdma2d_rescue_width(mx, lx, float(ref.inv_dy2))
    bt = torch.as_tensor(_btilde((1, n, n), np.float32))
    eig = spectral.make_fft_btilde_solver(port)(bt)
    assert torch.equal(spectral.make_fft_btilde_solver(
        port, z_mode="auto")(bt), eig)
    td = spectral.make_fft_btilde_solver(port, z_mode="tdma")(bt)
    np.testing.assert_allclose(td.numpy(), eig.numpy(), rtol=0,
                               atol=5e-6 * float(eig.abs().max()))


def test_emit_btilde_pieces_solve_the_z_lines():
    """``make_dst_fused_pieces(fuse_fwd=False)``: the same matrices as the
    fused form and a whole Thomas z-stage, the reference's
    ``make_tdma_z`` arithmetic."""
    port, ref = _problems((9, 16, 128), (1 / 127, 1 / 15, 1 / 8))
    mats, zsolve = spectral.make_dst_fused_pieces(port, torch.float32,
                                                  "cpu", fuse_fwd=False)
    mats_f, (mu, w) = spectral.make_dst_fused_pieces(port, torch.float32,
                                                     "cpu")
    for a, b in zip(mats, mats_f):
        assert torch.equal(a, b)
    r = torch.as_tensor(_btilde((9, 16, 128), np.float32))
    from cfd_tpu.ops.pallas.tdma import tdma_z_reference
    want = np.asarray(tdma_z_reference(jnp.asarray(r.numpy()),
                                       jnp.asarray(mu.numpy()),
                                       np.float32(w)))
    np.testing.assert_allclose(zsolve(r).numpy(), want, rtol=0,
                               atol=5e-6 * np.abs(want).max())


def test_every_method_inits_and_solves_in_both_packages():
    """``create_solver(method).init(...).solve(...)`` for every
    ``Method`` on a 17² float64 problem (2^k+1, which multigrid needs;
    an interior-mean-free rhs, which the stationary solves need): the
    same status and iteration count as the reference's front end, x
    within 1e-8·max|x|."""
    n = 17
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(3)
    rhs = np.zeros((n, n))
    rhs[1:-1, 1:-1] = rng.standard_normal((n - 2, n - 2))
    rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()
    x0 = np.zeros((n, n))
    for method in Method:
        x, st = frontend.create_solver(method, device="cpu").init(
            n, n, 1, h, h).solve(torch.as_tensor(x0), torch.as_tensor(rhs))
        jx, jst = jfrontend.create_solver(JMethod(int(method))).init(
            n, n, 1, h, h).solve(jnp.asarray(x0), jnp.asarray(rhs))
        assert st.status == int(jst.status), method.name
        assert st.iterations == jst.iterations, method.name
        want = np.asarray(jx)
        np.testing.assert_allclose(x.numpy(), want, rtol=0,
                                   atol=1e-8 * np.abs(want).max(),
                                   err_msg=method.name)


def test_fft_direct_unsupported_geometry_raises():
    """nz = 3 with dz = 0 is neither 2D nor a genuine 3D problem: init
    raises ``ERROR_UNSUPPORTED``, as the reference's front end."""
    with pytest.raises(CFDError) as err:
        frontend.create_solver(Method.FFT_DIRECT, device="cpu").init(
            9, 9, 3, 0.1, 0.1, 0.0)
    assert err.value.status == Status.ERROR_UNSUPPORTED


@pytest.mark.parametrize("dtype,plain,wrapped", [
    (torch.float32, False, True), (torch.float32, True, False),
    (torch.float64, False, False)], ids=["f32", "f32_plain", "f64"])
def test_fft_direct_dispatch(monkeypatch, dtype, plain, wrapped):
    """The front end's FFT_DIRECT takes the GEMM wrappers (the kernels on
    the card) for float32 only; ``plain=True`` and other dtypes take the
    plain products, as every other method's plain solve.  Both forms give
    the same x on the CPU."""
    from cfd_tpu_torch.ops.kernels import rolling
    calls = []

    def spy(fn):
        def wrapper(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    for name in ("plane_dot", "right_dot", "left_dot"):
        monkeypatch.setattr(rolling, name, spy(getattr(rolling, name)))
    shape, h = SHAPES[1]
    nz, ny, nx = shape
    _, _, x0, rhs = _system(shape, h)
    x0, rhs = torch.as_tensor(x0, dtype=dtype), torch.as_tensor(rhs,
                                                                dtype=dtype)
    solver = frontend.create_solver(Method.FFT_DIRECT, device="cpu",
                                    plain=plain).init(nx, ny, nz, *h)
    x, st = solver.solve(x0, rhs)
    assert bool(calls) == wrapped, calls
    assert st.status == PoissonStatus.CONVERGED and st.iterations == 1
    want = spectral.make_fft_direct(PoissonProblem(nx, ny, nz, *h),
                                    PoissonParams(), plain=True)(x0, rhs).x
    assert torch.equal(x, want)
