"""The port's variable-coefficient Poisson problem against the reference's
(`cfd_tpu/solvers/poisson/nonuniform.py`), float64: the problem's
operator, volume-weighted dot and Jacobi weights, the generalized
eigenbasis, the face weights and the fused factors, the direct solve in
3D and 2D, and the plain CG and BiCGSTAB loops over the problem."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.poisson import nonuniform as jnu
from cfd_tpu.solvers.poisson.base import PoissonParams as JParams
from cfd_tpu.solvers.poisson.krylov import make_bicgstab as j_bicgstab
from cfd_tpu.solvers.poisson.krylov import make_cg as j_cg
from cfd_tpu_torch.interop import grid_from
from cfd_tpu_torch.solvers.poisson import nonuniform as nu
from cfd_tpu_torch.solvers.poisson.base import PoissonParams, PoissonStatus
from cfd_tpu_torch.solvers.poisson.krylov import make_bicgstab, make_cg

torch.set_num_threads(min(2, torch.get_num_threads()))

SHAPES = {"3d": (10, 20, 24), "2d": (1, 20, 24)}


def _problems(dim, axes="xy", beta=1.5):
    nz, ny, nx = SHAPES[dim]
    kw = dict(zmin=0.0, zmax=1.0) if nz > 1 else {}
    jg = JGrid.stretched(nx, ny, nz, beta=beta, stretch_axes=axes, **kw)
    return (nu.NonuniformPoissonProblem.from_grid(grid_from(jg)),
            jnu.NonuniformPoissonProblem.from_grid(jg))


def _interior(a, nz):
    return a[(slice(1, -1) if nz > 1 else slice(None)), 1:-1, 1:-1]


def _rhs(shape, seed):
    """A random rhs, zero on the shell."""
    out = np.zeros(shape)
    inner = np.random.default_rng(seed).normal(size=shape)
    sl = (slice(1, -1) if shape[0] > 1 else slice(None), slice(1, -1),
          slice(1, -1))
    out[sl] = inner[sl]
    return out


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_problem_operator_dot_and_weights_match_reference(dim):
    """laplacian on the interior, the volume-weighted dot and inv_factor
    within 1e-12 (relative to their scale)."""
    tp, jp = _problems(dim)
    shape = SHAPES[dim]
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=shape), rng.normal(size=shape)
    got = tp.laplacian(torch.tensor(a)).numpy()
    ref = np.asarray(jp.laplacian(jnp.asarray(a)))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(_interior(got, shape[0]),
                               _interior(ref, shape[0]), rtol=0,
                               atol=1e-12 * scale)
    shell = got.copy()
    shell[(slice(1, -1) if shape[0] > 1 else slice(None)), 1:-1, 1:-1] = 0
    assert not shell.any()   # the port's operator is zero on the shell
    d = float(tp.dot_interior(torch.tensor(a), torch.tensor(b)))
    jd = float(jp.dot_interior(jnp.asarray(a), jnp.asarray(b)))
    assert abs(d - jd) <= 1e-12 * float(
        jp.dot_interior(jnp.abs(jnp.asarray(a)), jnp.abs(jnp.asarray(b))))
    np.testing.assert_allclose(tp.inv_factor, jp.inv_factor, rtol=1e-12,
                               atol=0)
    assert (tp.nx, tp.ny, tp.nz, tp.dx, tp.dy, tp.dz) == (
        jp.nx, jp.ny, jp.nz, jp.dx, jp.dy, jp.dz)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_eigenbasis_matches_reference(axis):
    """λ equal; F and G the reference's (numpy's eigh, one process);
    F·G = I and −L = G·diag(λ)·F to 1e-12."""
    tp, jp = _problems("3d")
    gaps = getattr(tp, f"{axis}_gaps")
    lam, F, G = nu.nonuniform_eigenbasis(gaps)
    jlam, jF, jG = jnu.nonuniform_eigenbasis(gaps)
    np.testing.assert_array_equal(lam, jlam)
    np.testing.assert_array_equal(F, jF)
    np.testing.assert_array_equal(G, jG)
    m = lam.size
    np.testing.assert_allclose(F @ G, np.eye(m), rtol=0, atol=1e-12)
    # −L on the interior points, Dirichlet-0 ends, from the weights
    lm, lc, lp = (tp._wx if axis == "x" else tp._wy)[:3]
    L = (np.diag(lc[1:-1]) + np.diag(lm[2:-1], -1) + np.diag(lp[1:-2], 1))
    np.testing.assert_allclose(G @ np.diag(lam) @ F, -L, rtol=0,
                               atol=1e-12 * np.abs(L).max())


@pytest.mark.parametrize("axes", ["xy", "x"])
def test_face_coeffs_and_fused_mats_match_reference(axes):
    tp, jp = _problems("3d", axes)
    assert nu.nonuniform_face_coeffs(tp) == jnu.nonuniform_face_coeffs(jp)
    for np_dt in (np.float32, np.float64):
        mats, mu, w = nu._nonuniform_fused_mats(tp, np_dt)
        jmats, jmu, jw = jnu._nonuniform_fused_mats(jp, np_dt)
        for a, b in zip(mats, jmats):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(mu, jmu)
        assert w == jw
    assert nu.nonuniform_fused_supported(tp)
    mats_t, (mu_t, w_t) = nu.make_nonuniform_fused_pieces(
        tp, torch.float32, "cpu")
    jmats, (jmu, jw), _ = jnu.make_nonuniform_fused_pieces(
        jp, jnp.float32, use_kernel=False, fuse_fwd=True)
    for a, b in zip(mats_t, jmats):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(mu_t.numpy(), jmu)
    assert w_t == jw


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_direct_solve_matches_reference(dim):
    """make_nonuniform_direct, float64, within 1e-10 of the reference's
    (x of unit scale): x, the residual and the status."""
    tp, jp = _problems(dim)
    shape = SHAPES[dim]
    x0 = np.random.default_rng(5).normal(0.0, 0.1, shape)
    rhs = _rhs(shape, 6)
    res = nu.make_nonuniform_direct(tp, PoissonParams(), torch.float64,
                                    "cpu")(torch.tensor(x0),
                                           torch.tensor(rhs))
    jres = jnu.make_nonuniform_direct(jp, JParams(), jnp.float64)(
        jnp.asarray(x0), jnp.asarray(rhs))
    ref = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), ref, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(float(res.final_residual),
                               float(jres.final_residual), rtol=1e-6,
                               atol=1e-9)
    assert int(res.status) == int(jres.status) == PoissonStatus.CONVERGED
    # the residual is the solve's rounding: far below the rhs
    assert float(res.final_residual) < 1e-9 * np.abs(rhs).sum()


def test_direct_solve_plain_switch_and_float32():
    """``plain=True`` runs the same arithmetic (on the CPU the wrappers
    run their plain versions anyway); float32 stays within float32
    rounding of the float64 solve."""
    tp, _ = _problems("3d")
    shape = SHAPES["3d"]
    x0 = np.random.default_rng(5).normal(0.0, 0.1, shape)
    rhs = _rhs(shape, 6)
    a = nu.make_nonuniform_direct(tp, None, torch.float64, "cpu")(
        torch.tensor(x0), torch.tensor(rhs))
    b = nu.make_nonuniform_direct(tp, None, torch.float64, "cpu",
                                  plain=True)(torch.tensor(x0),
                                              torch.tensor(rhs))
    assert torch.equal(a.x, b.x)
    c = nu.make_nonuniform_direct(tp, None, torch.float32, "cpu")(
        torch.tensor(x0, dtype=torch.float32),
        torch.tensor(rhs, dtype=torch.float32))
    np.testing.assert_allclose(c.x.double().numpy(), a.x.numpy(), rtol=0,
                               atol=1e-4 * np.abs(a.x.numpy()).max())


# The two packages sum their dots in other orders, and on a β = 1.5 grid
# the stretched operator's conditioning grows that rounding along a
# Krylov trajectory (CG in 2D: 4e-13 apart after 15 iterations, 2e-5
# after 30; BiCGSTAB 1e-13 after 10, 1e-6 after 20).  So x is held at
# 1e-10 over runs capped at 10 iterations, and over runs converged to
# 1e-12, where both sit on the solution (BiCGSTAB's counts then differ
# by a few iterations: 129 against 133 in 2D).
KRYLOV = {"cg": (make_cg, j_cg), "bicgstab": (make_bicgstab, j_bicgstab)}


@pytest.mark.parametrize("name", sorted(KRYLOV))
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_krylov_on_the_problem_matches_reference(name, dim):
    maker, jmaker = KRYLOV[name]
    tp, jp = _problems(dim)
    shape = SHAPES[dim]
    x0 = np.random.default_rng(7).normal(0.0, 0.1, shape)
    rhs = _rhs(shape, 8)
    for kw in (dict(max_iterations=10), dict(tolerance=1e-12)):
        res = maker(tp, PoissonParams(**kw))(torch.tensor(x0),
                                             torch.tensor(rhs))
        jres = jmaker(jp, JParams(**kw))(jnp.asarray(x0), jnp.asarray(rhs))
        ref = np.asarray(jres.x)
        assert int(res.status) == int(jres.status)
        if "max_iterations" in kw or name == "cg":
            assert int(res.iterations) == int(jres.iterations)
        else:
            assert abs(int(res.iterations) - int(jres.iterations)) <= 10
        np.testing.assert_allclose(res.x.numpy(), ref, rtol=0, atol=1e-10)


def test_cg_jacobi_preconditioner_takes_the_per_point_diagonal():
    """Jacobi-PCG on the problem multiplies by the (ny, nx) inv_factor
    plane, as the reference's."""
    tp, jp = _problems("3d")
    shape = SHAPES["3d"]
    x0 = np.zeros(shape)
    rhs = _rhs(shape, 9)
    from cfd_tpu.solvers.poisson.base import Precond as JPrecond
    from cfd_tpu_torch.solvers.poisson.base import Precond
    res = make_cg(tp, PoissonParams(preconditioner=Precond.JACOBI,
                                    max_iterations=20))(
        torch.tensor(x0), torch.tensor(rhs))
    jres = j_cg(jp, JParams(preconditioner=JPrecond.JACOBI,
                            max_iterations=20))(jnp.asarray(x0),
                                                jnp.asarray(rhs))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_problem_tensors_are_made_once_per_dtype_and_device(dtype):
    """The operator's weight rows and the volume plane are built once for
    each (dtype, device) and reused by every later call (a host-to-device
    copy in each Krylov iteration would stall the loop on the card); the
    cached operator gives the same values on a second call."""
    tp, _ = _problems("3d")
    x = torch.tensor(_rhs(SHAPES["3d"], 4), dtype=dtype)
    first = tp._consts(x)
    lap1, dot1 = tp.laplacian(x), tp.dot_interior(x, x)
    assert tp._consts(x) is first
    assert all(r.dtype == dtype for r in first[0] + first[1])
    assert first[2].dtype == torch.float64
    assert torch.equal(tp.laplacian(x), lap1)
    assert torch.equal(tp.dot_interior(x, x), dot1)
    assert list(tp._tensors) == [(dtype, x.device)]
