"""The port's multigrid pressure solve against the reference's
(`cfd_tpu/solvers/poisson/multigrid.py`, `ops/pallas/mg_kernels.py`,
`ops/pallas/vmem_mg.py`, `solvers/poisson/frontend.py`), on the CPU.

* the checkerboard, the red-black sweep (red-first, red-first with the
  residual field, black-first) and the inter-level transfers against the
  reference's jnp twins in float64 (bit for bit), and the sweep against
  ``make_mg_rb_sweep`` in interpret mode in float32 (unpadded back);
* ``make_multigrid`` (3D 17³, 2D 33×65) against the jnp ``make_multigrid``
  in float64 (same iterations and status, x within 1e-9·max|x|) and, in
  3D, the fused reference in interpret mode in float32 (same iterations,
  atol 1e-5, `tests/math/test_multigrid.py:133-135`);
* the whole-solve twin (``make_multigrid_vmem``) against the reference's
  whole-solve kernel in interpret mode (float32, ±1 iteration,
  `tests/math/test_vmem_mg.py:53`) and the jnp ``make_multigrid``
  (float64, same iterations), and its float32 residual floor against the
  jnp one's;
* ``make_mg_cg`` at 17³ against the jnp one (float64) and the fused one
  in interpret mode (float32);
* the front end: ``create_solver(MULTIGRID)``, ``(CG, Precond.MULTIGRID)``,
  the non-coarsenable grid and the presets.

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops import stencils as jstencils
from cfd_tpu.ops.pallas.mg_kernels import make_mg_rb_sweep, pad_dims
from cfd_tpu.solvers.poisson import Method as JMethod
from cfd_tpu.solvers.poisson import PoissonParams as JParams
from cfd_tpu.solvers.poisson import Precond as JPrecond
from cfd_tpu.solvers.poisson import create_solver as j_create_solver
from cfd_tpu.solvers.poisson import multigrid as jmg
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu.solvers.poisson.frontend import SolverPreset as JPreset
from cfd_tpu.solvers.poisson.frontend import \
    poisson_solve as j_poisson_solve
from cfd_tpu_torch import CFDError, Status
from cfd_tpu_torch.ops import stencils
from cfd_tpu_torch.ops.kernels import mg_kernels as mgk
from cfd_tpu_torch.solvers.poisson import frontend
from cfd_tpu_torch.solvers.poisson import multigrid as mg
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem,
                                                PoissonStatus, Precond,
                                                result_to_stats)

torch.set_num_threads(min(2, torch.get_num_threads()))

SWEEP_SHAPE = (9, 33, 17)          # nx × ny × nz = 17 × 33 × 9
FIRST = {"red": ("red", "black"), "red_residual": ("red", "black"),
         "black": ("black", "red")}


def _problems(shape):
    nz, ny, nx = shape
    h = (1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1) if nz > 1 else 0.0)
    return PoissonProblem(nx, ny, nz, *h), JProblem(nx, ny, nz, *h)


def _levels(shape):
    prob, jprob = _problems(shape)
    return mg._build_levels(prob), jmg._build_levels(jprob)


def _zero_shell(a):
    out = np.zeros_like(a)
    sl = (slice(1, -1) if a.shape[0] > 1 else slice(None), slice(1, -1),
          slice(1, -1))
    out[sl] = a[sl]
    return out


def _system(shape, seed=0, np_dt=np.float64):
    """A zero-shell normal right-hand side and a small random start."""
    rng = np.random.default_rng(seed)
    rhs = _zero_shell(rng.normal(size=shape))
    x0 = rng.normal(0.0, 0.1, shape)
    return x0.astype(np_dt), rhs.astype(np_dt)


def test_levels_match_reference():
    for shape in ((17, 17, 17), (1, 33, 65), SWEEP_SHAPE, (1, 129, 129)):
        lv, jlv = _levels(shape)
        assert [dataclass_tuple(a) for a in lv] == [
            dataclass_tuple(b) for b in jlv]
    assert _levels((1, 30, 30)) == (None, None)


def dataclass_tuple(lv):
    return (tuple(lv.shape), lv.inv_dx2, lv.inv_dy2, lv.inv_dz2,
            lv.inv_factor)


@pytest.mark.parametrize("shape", [SWEEP_SHAPE, (1, 33, 17)],
                         ids=["3d", "2d"])
def test_checkerboard_matches_reference(shape):
    for parity in (0, 1):
        np.testing.assert_array_equal(
            stencils.checkerboard_mask(shape, parity).numpy(),
            np.asarray(jstencils.checkerboard_mask(shape, parity)))


@pytest.mark.parametrize("shape", [SWEEP_SHAPE, (1, 33, 17)],
                         ids=["3d", "2d"])
@pytest.mark.parametrize("variant", sorted(FIRST))
def test_sweep_matches_reference_f64(variant, shape):
    """The sweep twin (what ``rb_sweep`` runs on a CPU tensor) equals the
    reference's ``_rb_sweep`` bit for bit, and the residual field its
    ``_zero_shell(b − A x)``: the same operations in the same order."""
    (lv, *_), (jlv, *_) = _levels(shape)
    x, b = _system(shape, seed=2)
    xt, bt = torch.tensor(x), torch.tensor(b)
    r = torch.empty_like(xt) if variant == "red_residual" else None
    mgk.rb_sweep(xt, bt, lv, first=FIRST[variant][0], residual=r)
    jx = jmg._rb_sweep(jnp.asarray(x), jnp.asarray(b), jlv, FIRST[variant])
    np.testing.assert_array_equal(xt.numpy(), np.asarray(jx))
    if r is not None:
        jr = jmg._zero_shell(jnp.asarray(b) - jmg._A(jx, jlv))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def _pad(a, nyp, nxp):
    nz, ny, nx = a.shape
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, nyp - ny), (0, nxp - nx)))


@pytest.mark.parametrize("variant", sorted(FIRST))
def test_sweep_matches_reference_kernel_f32(variant):
    """The sweep against ``make_mg_rb_sweep`` in interpret mode (lane-
    padded, unpadded back), float32: x and the residual within
    1e-6·max."""
    (lv, *_), (jlv, *_) = _levels(SWEEP_SHAPE)
    nz, ny, nx = SWEEP_SHAPE
    x, b = _system(SWEEP_SHAPE, seed=3, np_dt=np.float32)
    x = _zero_shell(x)   # the kernel's inputs keep zero shells
    emit = variant == "red_residual"
    kern = make_mg_rb_sweep(nz, ny, nx, jlv.inv_dx2, jlv.inv_dy2,
                            jlv.inv_dz2, jlv.inv_factor, emit, jnp.float32,
                            True, first_color=FIRST[variant][0])
    nyp, nxp = pad_dims(ny, nx)
    out = kern(_pad(x, nyp, nxp), _pad(b, nyp, nxp))
    outs = out if emit else (out,)
    ref = [np.asarray(o)[:, :ny, :nx] for o in outs]
    xt, bt = torch.tensor(x), torch.tensor(b)
    r = torch.empty_like(xt) if emit else None
    mgk.rb_sweep(xt, bt, lv, first=FIRST[variant][0], residual=r)
    got = [xt.numpy()] + ([r.numpy()] if emit else [])
    for name, g, rf in zip(("x", "r"), got, ref):
        np.testing.assert_allclose(g, rf, rtol=0,
                                   atol=1e-6 * np.abs(rf).max(),
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(17, 17, 17), (1, 33, 65)],
                         ids=["3d", "2d"])
def test_transfers_match_reference_f64(shape):
    """Restriction and prolongation equal the reference's ``_restrict`` /
    ``_prolong`` bit for bit (the same separable operation order)."""
    (f, c, *_), (jf, jc, *_) = _levels(shape)
    rng = np.random.default_rng(5)
    r = _zero_shell(rng.normal(size=f.shape))
    e = _zero_shell(rng.normal(size=c.shape))
    np.testing.assert_array_equal(
        mgk.restrict(torch.tensor(r), c.shape).numpy(),
        np.asarray(jmg._restrict(jnp.asarray(r), jf, jc)))
    np.testing.assert_array_equal(
        mgk.prolong(torch.tensor(e)).numpy(),
        np.asarray(jmg._prolong(jnp.asarray(e), jf, jc)))


def _assert_results(res, jres, x_rel, same_iterations=True):
    stats = result_to_stats(res)
    if same_iterations:
        assert stats.iterations == int(jres.iterations)
    else:
        assert abs(stats.iterations - int(jres.iterations)) <= 1
    assert int(stats.status) == int(jres.status) == PoissonStatus.CONVERGED
    jx = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), jx, rtol=0,
                               atol=x_rel * np.abs(jx).max())
    return stats


@pytest.mark.parametrize("shape", [(17, 17, 17), (1, 33, 65)],
                         ids=["3d_17^3", "2d_33x65"])
def test_make_multigrid_matches_jnp_f64(shape):
    prob, jprob = _problems(shape)
    x0, rhs = _system(shape)
    pp, jpp = PoissonParams(tolerance=1e-6), JParams(tolerance=1e-6)
    res = mg.make_multigrid(prob, pp)(torch.tensor(x0), torch.tensor(rhs))
    jres = jmg.make_multigrid(jprob, jpp, use_pallas=False)(
        jnp.asarray(x0), jnp.asarray(rhs))
    stats = _assert_results(res, jres, 1e-9)
    assert 3 <= stats.iterations <= 12
    np.testing.assert_allclose(stats.final_residual,
                               float(jres.final_residual), rtol=1e-8)


def test_make_multigrid_matches_fused_reference_f32():
    """Against the reference's fused V-cycle (the sweep kernels in
    interpret mode on every level above the coarsest)."""
    shape = (17, 17, 17)
    prob, jprob = _problems(shape)
    x0, rhs = _system(shape, np_dt=np.float32)
    x0 = np.zeros_like(x0)
    pp, jpp = PoissonParams(tolerance=1e-6), JParams(tolerance=1e-6)
    res = mg.make_multigrid(prob, pp)(torch.tensor(x0), torch.tensor(rhs))
    jres = jmg.make_multigrid(jprob, jpp, use_pallas=True,
                              pallas_interpret=True, min_fused_nx=0)(
        jnp.asarray(x0), jnp.asarray(rhs))
    stats = result_to_stats(res)
    assert stats.iterations == int(jres.iterations)
    assert int(stats.status) == int(jres.status) == 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("ci", [1, 3])
@pytest.mark.parametrize("shape", [(1, 33, 33), (1, 33, 65)],
                         ids=["33^2", "65x33"])
def test_whole_solve_matches_reference_kernel_f32(shape, ci):
    """The whole-solve twin against ``make_multigrid_vmem`` in interpret
    mode: ±1 V-cycle (the reference kernel's matmul transfers sum in
    another order, `tests/math/test_vmem_mg.py:53`), x within rtol 5e-4 /
    atol 5e-5 (`:57-58`)."""
    prob, jprob = _problems(shape)
    x0, rhs = _system(shape, seed=1, np_dt=np.float32)
    kw = dict(tolerance=1e-5, absolute_tolerance=1e-12, max_iterations=50,
              check_interval=ci)
    res = mg.make_multigrid_vmem(prob, PoissonParams(**kw))(
        torch.tensor(x0), torch.tensor(rhs))
    jres = jmg.make_multigrid_vmem(jprob, JParams(**kw), interpret=True)(
        jnp.asarray(x0), jnp.asarray(rhs))
    stats = result_to_stats(res)
    assert abs(stats.iterations - int(jres.iterations)) <= 1
    assert int(stats.status) == int(jres.status) == 0
    np.testing.assert_allclose(stats.initial_residual,
                               float(jres.initial_residual), rtol=1e-5)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("ci", [1, 3])
@pytest.mark.parametrize("shape", [(1, 33, 33), (1, 33, 65)],
                         ids=["33^2", "65x33"])
def test_whole_solve_matches_jnp_f64(shape, ci):
    """The whole-solve twin computes the jnp ``make_multigrid``'s body:
    the same iterations and status in float64, x within 1e-9·max|x|."""
    prob, jprob = _problems(shape)
    x0, rhs = _system(shape, seed=1)
    kw = dict(tolerance=1e-8, check_interval=ci)
    res = mg.make_multigrid_vmem(prob, PoissonParams(**kw))(
        torch.tensor(x0), torch.tensor(rhs))
    jres = jmg.make_multigrid(jprob, JParams(**kw), use_pallas=False)(
        jnp.asarray(x0), jnp.asarray(rhs))
    _assert_results(res, jres, 1e-9)


@pytest.mark.parametrize("n", [33, 65])
def test_float32_residual_floor_matches_reference(n):
    """A multigrid solve recomputes its residual each V-cycle, so in
    float32 it stalls at a floor; for the smoothest rhs that floor lies
    above the default relative tolerance 1e-6 and grows with the grid.
    The whole-solve twin stalls where the reference's jnp
    ``make_multigrid`` does, and both report MAX_ITER."""
    prob, jprob = _problems((1, n, n))
    s = np.sin(np.pi * np.linspace(0.0, 1.0, n))
    rhs = _zero_shell((1e3 * s[None, :, None] * s[None, None, :])
                      .astype(np.float32))
    x0 = np.zeros_like(rhs)
    kw = dict(tolerance=0.0, max_iterations=20)
    res = mg.make_multigrid_vmem(prob, PoissonParams(**kw))(
        torch.tensor(x0), torch.tensor(rhs))
    jres = jmg.make_multigrid(jprob, JParams(**kw), use_pallas=False)(
        jnp.asarray(x0), jnp.asarray(rhs))
    floor = float(res.final_residual) / float(res.initial_residual)
    jfloor = float(jres.final_residual) / float(jres.initial_residual)
    assert int(res.status) == int(jres.status) == PoissonStatus.MAX_ITER
    assert floor > 1e-6 * (n - 1) / 16
    np.testing.assert_allclose(floor, jfloor, rtol=1e-3)


def test_mg_cg_matches_reference():
    """MG-preconditioned CG at 17³: the jnp one in float64 (same
    iterations, x within 1e-9 relative), the fused one (black-first post
    sweeps in interpret mode) in float32 (same iterations, atol 1e-5)."""
    shape = (17, 17, 17)
    prob, jprob = _problems(shape)
    x0, rhs = _system(shape, seed=4)
    pp, jpp = PoissonParams(tolerance=1e-8), JParams(tolerance=1e-8)
    res = mg.make_mg_cg(prob, pp)(torch.tensor(x0), torch.tensor(rhs))
    jres = jmg.make_mg_cg(jprob, jpp, use_pallas=False)(jnp.asarray(x0),
                                                        jnp.asarray(rhs))
    stats = _assert_results(res, jres, 1e-9)
    assert 3 <= stats.iterations <= 12
    x32, r32 = np.zeros(shape, np.float32), rhs.astype(np.float32)
    pp, jpp = PoissonParams(tolerance=1e-6), JParams(tolerance=1e-6)
    res = mg.make_mg_cg(prob, pp)(torch.tensor(x32), torch.tensor(r32))
    jres = jmg.make_mg_cg(jprob, jpp, use_pallas=True, pallas_interpret=True,
                          min_fused_nx=0)(jnp.asarray(x32), jnp.asarray(r32))
    assert result_to_stats(res).iterations == int(jres.iterations)
    assert int(res.status) == int(jres.status) == 0
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-5)


FRONTEND_CASES = {
    "multigrid_2d": (Method.MULTIGRID, dict(), (1, 65, 65)),
    "multigrid_3d": (Method.MULTIGRID, dict(), (17, 17, 17)),
    "mg_cg_2d": (Method.CG, dict(preconditioner=Precond.MULTIGRID),
                 (1, 65, 65)),
    "cg_2d": (Method.CG, dict(), (1, 33, 33)),
}


@pytest.mark.parametrize("case", sorted(FRONTEND_CASES))
def test_frontend_matches_reference(case):
    """``create_solver`` → ``init`` → ``solve`` on the same (x, rhs) as the
    reference's front end, float64: the same stats (iterations, status,
    residuals) and x within 1e-9·max|x|; a 2D problem passed as planes."""
    method, kw, shape = FRONTEND_CASES[case]
    nz, ny, nx = shape
    prob, _ = _problems(shape)
    x0, rhs = _system(shape, seed=6)
    if nz == 1:
        x0, rhs = x0[0], rhs[0]
    jkw = {k: JPrecond(int(v)) for k, v in kw.items()}
    s = frontend.create_solver(method, PoissonParams(**kw), device="cpu")
    s.init(nx, ny, nz, prob.dx, prob.dy, prob.dz)
    js = j_create_solver(JMethod(int(method)), JParams(**jkw))
    js.init(nx, ny, nz, prob.dx, prob.dy, prob.dz)
    assert s.name == js.name
    x, stats = s.solve(x0, rhs)
    jx, jstats = js.solve(jnp.asarray(x0), jnp.asarray(rhs))
    assert (stats.iterations, int(stats.status)) == (
        jstats.iterations, int(jstats.status))
    for a in ("initial_residual", "final_residual"):
        np.testing.assert_allclose(getattr(stats, a), getattr(jstats, a),
                                   rtol=1e-8, err_msg=a)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(jx)).max())
    np.testing.assert_allclose(s.compute_residual(x, rhs),
                               js.compute_residual(jx, rhs), rtol=1e-8)


def test_frontend_float32_takes_the_kernel_solve():
    """A float32 2D multigrid solve goes through the whole-solve wrapper
    (its plain version on the CPU) and agrees with the float64 one."""
    x0, rhs = _system((1, 33, 33), seed=8)
    s = frontend.create_solver(Method.MULTIGRID, device="cpu")
    s.init(33, 33, 1, 1 / 32, 1 / 32)
    assert s._fused_fn is not s._solve_fn
    x32, st32 = s.solve(x0.astype(np.float32), rhs.astype(np.float32))
    x64, st64 = s.solve(x0, rhs)
    assert x32.dtype == torch.float32 and st32.status == st64.status == 0
    assert abs(st32.iterations - st64.iterations) <= 1
    np.testing.assert_allclose(x32.numpy(), x64.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("method,kw", [
    (Method.MULTIGRID, dict()),
    (Method.CG, dict(preconditioner=Precond.MULTIGRID))],
    ids=["multigrid", "mg_cg"])
def test_non_coarsenable_grid_raises(method, kw):
    """(n − 1) = 29 is odd: ``ERROR_UNSUPPORTED``, as the reference's
    `tests/math/test_multigrid.py:89-93`."""
    s = frontend.create_solver(method, PoissonParams(**kw), device="cpu")
    with pytest.raises(CFDError) as err:
        s.init(30, 30, 1, 0.1, 0.1, 0.0)
    assert err.value.status == Status.ERROR_UNSUPPORTED


def test_unported_methods_and_default_preset_raise():
    """The methods of later slices raise at ``init``; so does the cached
    API with its default preset (Red-Black SOR)."""
    for method in (Method.JACOBI, Method.SOR, Method.REDBLACK_SOR,
                   Method.BICGSTAB, Method.FFT_DIRECT):
        s = frontend.create_solver(method, device="cpu")
        assert s.name == j_create_solver(JMethod(int(method))).name
        with pytest.raises(CFDError) as err:
            s.init(33, 33)
        assert err.value.status == Status.ERROR_UNSUPPORTED
    frontend.clear_cache()
    with pytest.raises(CFDError) as err:
        frontend.poisson_solve(np.zeros((33, 33)), np.zeros((33, 33)), 33,
                               33, 1 / 32, 1 / 32, device="cpu")
    assert err.value.status == Status.ERROR_UNSUPPORTED


def test_cached_cg_preset_matches_reference():
    """``poisson_solve`` with a CG preset: the same (x, iterations) as the
    reference's cached API."""
    x0, rhs = _system((1, 33, 33), seed=9)
    frontend.clear_cache()
    x, it = frontend.poisson_solve(x0[0], rhs[0], 33, 33, 1 / 32, 1 / 32,
                                   frontend.SolverPreset.CG_SCALAR,
                                   device="cpu")
    jx, jit = j_poisson_solve(jnp.asarray(x0[0]), jnp.asarray(rhs[0]), 33,
                              33, 1 / 32, 1 / 32, JPreset.CG_SCALAR)
    assert it == jit > 0
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(jx)).max())
