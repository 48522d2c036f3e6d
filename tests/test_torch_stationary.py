"""The port's Red-Black SOR and Jacobi pressure solves and the Poisson front
end's new methods against the reference's (`cfd_tpu/solvers/poisson/
stationary.py`, `base.py`, `frontend.py`, `ops/pallas/rbsor_kernels.py`,
`ops/pallas/vmem_small.py`), on the CPU.

* ``optimal_omega`` / ``resolve_omega``: equal floats;
* the clamped-gather mirror against ``apply_neumann_scalar``: bit-equal;
* one Red-Black SOR sweep against the jnp sweep (float64) and the TPU
  sweep kernel in interpret mode (float32);
* the five makers against the reference's jnp makers (float64: the same
  iterations and status, x within 1e-12·max|x|) and the fused and
  whole-solve makers against the reference's in interpret mode (float32,
  at the reference's own bars);
* the front end: JACOBI, REDBLACK_SOR and BICGSTAB against the
  reference's, Jacobi's factory defaults, the kernel choice, and the
  cached ``poisson_solve`` with its default preset.

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.ops.pallas.rbsor_kernels import make_rbsor_sweep
from cfd_tpu.solvers.poisson import frontend as jfrontend
from cfd_tpu.solvers.poisson import stationary as jstationary
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch.boundary import apply_neumann_scalar
from cfd_tpu_torch.ops.kernels import bicgstab_kernels as bk
from cfd_tpu_torch.ops.kernels import rbsor_kernels as sk
from cfd_tpu_torch.ops.kernels import vmem_small
from cfd_tpu_torch.solvers.poisson import frontend, krylov, stationary
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem,
                                                PoissonStatus)

torch.set_num_threads(min(2, torch.get_num_threads()))


def _problems(shape, h=None):
    nz, ny, nx = shape
    if h is None:
        h = (1.0 / (nx - 1), 1.0 / (ny - 1),
             1.0 / (nz - 1) if nz > 1 else 0.0)
    return PoissonProblem(nx, ny, nz, *h), JProblem(nx, ny, nz, *h)


def _sor_consts(prob, omega):
    return sk.SORConsts(*prob.shape, prob.inv_dx2, prob.inv_dy2,
                        prob.inv_dz2, prob.inv_factor, omega)


def _system(shape, seed=1, np_dt=np.float64):
    """A normal rhs and a small normal start, as the reference's tests
    (`tests/math/test_vmem_small.py:21-25`)."""
    rng = np.random.default_rng(seed)
    rhs = rng.normal(0.0, 1.0, shape).astype(np_dt)
    x0 = rng.normal(0.0, 0.1, shape).astype(np_dt)
    return x0, rhs


@pytest.mark.parametrize("shape,omega", [
    ((1, 100, 100), 0.0), ((1, 33, 65), -1.0), ((6, 16, 128), 0.0),
    ((11, 23, 37), 1.3)], ids=["100x100", "65x33", "128x16x6",
                               "37x23x11_given"])
def test_omega_matches_reference(shape, omega):
    prob, jprob = _problems(shape, (0.1, 0.2, 0.15) if shape[0] > 1
                            else None)
    assert prob.optimal_omega() == jprob.optimal_omega()
    assert prob.resolve_omega(omega) == jprob.resolve_omega(omega)


@pytest.mark.parametrize("shape", [(1, 3, 3), (1, 7, 12), (3, 3, 3),
                                   (5, 9, 4), (11, 23, 37)])
def test_clamped_gather_is_the_neumann_mirror(shape):
    """The sweep kernel's mirror, x[clamp(k), clamp(j), clamp(i)], is the
    x → y → z face copy bit for bit, corners and edges included."""
    x = torch.tensor(np.random.default_rng(2).normal(size=shape))
    assert torch.equal(sk.neumann_gather(x), apply_neumann_scalar(x))


# ---- one sweep ------------------------------------------------------------------

def _jnp_rb_sweep(jprob, x, rhs, omega):
    """One reference RB sweep + Neumann BC, the jnp solver's body
    (`tests/math/test_fused_solvers.py:43-55`)."""
    red = jstationary._checkerboard(jprob, 0)
    black = jstationary._checkerboard(jprob, 1)

    def half(x, mask):
        nb = ((jnp.roll(x, -1, -1) + jnp.roll(x, 1, -1)) * jprob.inv_dx2
              + (jnp.roll(x, -1, -2) + jnp.roll(x, 1, -2)) * jprob.inv_dy2
              + (jnp.roll(x, -1, -3) + jnp.roll(x, 1, -3)) * jprob.inv_dz2)
        gs = -(rhs - nb) * jprob.inv_factor
        return jnp.where(mask, x + omega * (gs - x), x)

    return jprob.neumann_bc(half(half(x, red), black))


@pytest.mark.parametrize("nz", [3, 4, 6])
def test_rbsor_sweep_matches_reference(nz):
    """Float64: x and the residual equal to the jnp sweep's.  Float32: the
    TPU kernel in interpret mode, its bars (`test_fused_solvers.py:66-80`):
    x within atol 2e-6 / rtol 1e-6, the residual within 1e-3."""
    shape = (nz, 8, 128)
    prob, jprob = _problems(shape, (0.1, 0.2, 0.15))
    omega = prob.resolve_omega(0.0)
    x, rhs = (np.random.default_rng(s).normal(size=shape) for s in (0, 1))
    c = _sor_consts(prob, omega)
    got, res = sk.rbsor_sweep(torch.tensor(x), torch.tensor(rhs), c)
    ref = _jnp_rb_sweep(jprob, jnp.asarray(x), jnp.asarray(rhs), omega)
    ref_res = float(jprob.residual_inf(ref, jnp.asarray(rhs)))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-14 * np.abs(ref).max())
    np.testing.assert_allclose(float(res), ref_res, rtol=1e-13)
    x32, rhs32 = x.astype(np.float32), rhs.astype(np.float32)
    sweep = make_rbsor_sweep(*shape, jprob.inv_dx2, jprob.inv_dy2,
                             jprob.inv_dz2, jprob.inv_factor, omega,
                             interpret=True)
    kx, kres = sweep(jnp.asarray(x32), jnp.asarray(rhs32))
    got32, res32 = sk.rbsor_sweep(torch.tensor(x32), torch.tensor(rhs32), c)
    np.testing.assert_allclose(got32.numpy(), np.asarray(kx), atol=2e-6,
                               rtol=1e-6)
    assert abs(float(res32) - float(kres)) < 1e-3


def test_residual_keeps_nan():
    """A NaN in x gives a NaN residual, as jnp.max and torch.amax keep it."""
    shape = (5, 9, 12)
    prob, _ = _problems(shape)
    x = torch.zeros(shape)
    x[2, 4, 5] = float("nan")
    _, res = sk.rbsor_sweep(x, torch.zeros(shape),
                            _sor_consts(prob, prob.resolve_omega(0.0)))
    assert torch.isnan(res)


# ---- the solves ------------------------------------------------------------------

PLAIN = {"redblack_sor": jstationary.make_redblack_sor,
         "jacobi": jstationary.make_jacobi}
MAKERS = [("make_redblack_sor", "redblack_sor"),
          ("make_redblack_sor_fused", "redblack_sor"),
          ("make_redblack_sor_vmem", "redblack_sor"),
          ("make_jacobi", "jacobi"), ("make_jacobi_vmem", "jacobi")]


# the fused sweep is for 3D grids; 2D takes the whole-solve kernel
SOLVE_CASES = [(m, ref, shape, ci) for m, ref in MAKERS
               for shape in ((11, 23, 37), (1, 33, 65)) for ci in (1, 5)
               if not (m.endswith("_fused") and shape[0] == 1)]


@pytest.mark.parametrize(
    "maker,ref,shape,ci", SOLVE_CASES,
    ids=[f"{m}-{'x'.join(map(str, s[::-1]))}-{c}"
         for m, _, s, c in SOLVE_CASES])
def test_makers_match_reference_f64(maker, ref, shape, ci):
    """Against the reference's jnp loop in float64: the same sweeps, so
    the same iterations and status, x within 1e-12·max|x|."""
    prob, jprob = _problems(shape)
    kw = dict(tolerance=1e-3, absolute_tolerance=1e-12,
              max_iterations=200, check_interval=ci)
    x0, rhs = _system(shape)
    res = getattr(stationary, maker)(prob, PoissonParams(**kw),
                                     torch.float64, "cpu")(
        torch.tensor(x0), torch.tensor(rhs))
    jres = PLAIN[ref](jprob, JParams(**kw))(jnp.asarray(x0),
                                            jnp.asarray(rhs))
    assert (int(res.iterations), int(res.status)) == (
        int(jres.iterations), int(jres.status))
    exp = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), exp, rtol=0,
                               atol=1e-12 * np.abs(exp).max())
    for a in ("initial_residual", "final_residual"):
        np.testing.assert_allclose(float(getattr(res, a)),
                                   float(getattr(jres, a)), rtol=1e-10)


def test_fused_matches_reference_kernel_f32():
    """Against the reference's fused solve in interpret mode, its bar
    (`tests/math/test_fused_solvers.py:83-98`): the same iterations and
    status, x within 1e-6, the final residual within rtol 1e-4."""
    shape = (6, 16, 128)
    prob, jprob = _problems(shape, (0.05, 0.05, 0.05))
    kw = dict(tolerance=1e-4, max_iterations=400, check_interval=5)
    rhs = np.zeros(shape, np.float32)
    rhs[3, 8, 60], rhs[1, 2, 20] = 100.0, -40.0
    x0 = np.zeros(shape, np.float32)
    jres = jstationary.make_redblack_sor_fused(
        jprob, JParams(**kw), interpret=True)(jnp.asarray(x0),
                                              jnp.asarray(rhs))
    res = stationary.make_redblack_sor_fused(prob, PoissonParams(**kw),
                                             torch.float32, "cpu")(
        torch.tensor(x0), torch.tensor(rhs))
    assert (int(res.iterations), int(res.status)) == (
        int(jres.iterations), int(jres.status))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=1e-6)
    np.testing.assert_allclose(float(res.final_residual),
                               float(jres.final_residual), rtol=1e-4)


VMEM = [("make_redblack_sor_vmem", (1, 100, 100), 1),
        ("make_redblack_sor_vmem", (1, 100, 100), 10),
        ("make_redblack_sor_vmem", (1, 33, 65), 7),
        ("make_redblack_sor_vmem", (16, 16, 16), 4),
        ("make_redblack_sor_vmem", (8, 20, 33), 4),
        ("make_jacobi_vmem", (1, 100, 100), 10),
        ("make_jacobi_vmem", (16, 16, 16), 10)]


@pytest.mark.parametrize("maker,shape,ci", VMEM,
                         ids=[f"{m[5:-5]}-{'x'.join(map(str, s[::-1]))}-{c}"
                              for m, s, c in VMEM])
def test_vmem_matches_reference_kernel_f32(maker, shape, ci):
    """Against the reference's whole-solve kernels in interpret mode, their
    bars (`tests/math/test_vmem_small.py:40-57`, `:210-229`, `:268-288`):
    the same iterations and status, r0 within rtol 1e-5, the final
    residual within rtol 1e-3, x within rtol / atol 2e-5."""
    prob, jprob = _problems(shape)
    kw = dict(tolerance=1e-3, absolute_tolerance=1e-12,
              max_iterations=300 if shape[0] == 1 else 200,
              check_interval=ci)
    x0, rhs = _system(shape, seed=0 if shape[0] == 1 else 1,
                      np_dt=np.float32)
    if maker == "make_jacobi_vmem":
        x0 = np.zeros(shape, np.float32)
    jres = jax.jit(getattr(jstationary, maker)(
        jprob, JParams(**kw), dtype=jnp.float32, interpret=True))(
        jnp.asarray(x0), jnp.asarray(rhs))
    res = getattr(stationary, maker)(prob, PoissonParams(**kw),
                                     torch.float32, "cpu")(
        torch.tensor(x0), torch.tensor(rhs))
    assert (int(res.iterations), int(res.status)) == (
        int(jres.iterations), int(jres.status))
    np.testing.assert_allclose(float(res.initial_residual),
                               float(jres.initial_residual), rtol=1e-5)
    np.testing.assert_allclose(float(res.final_residual),
                               float(jres.final_residual), rtol=1e-3)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("maker", ["make_redblack_sor",
                                   "make_redblack_sor_fused",
                                   "make_redblack_sor_vmem", "make_jacobi",
                                   "make_jacobi_vmem"])
def test_closing_rules(maker):
    """A start below the absolute tolerance: 0 iterations, CONVERGED, the
    initial residual; a budget of 37 sweeps in chunks of 5: 37 (the last
    chunk clipped), MAX_ITER (`tests/math/test_vmem_small.py:60-82`)."""
    shape = (6, 10, 12)
    prob, _ = _problems(shape)
    mk = getattr(stationary, maker)
    zeros = torch.zeros(shape, dtype=torch.float64)
    r = mk(prob, PoissonParams(absolute_tolerance=1e-2))(
        zeros, torch.full(shape, 1e-5, dtype=torch.float64))
    assert (int(r.iterations), int(r.status)) == (0, 0)
    assert float(r.final_residual) == float(r.initial_residual)
    x0, rhs = _system(shape)
    r = mk(prob, PoissonParams(tolerance=0.0, absolute_tolerance=0.0,
                               max_iterations=37, check_interval=5))(
        torch.tensor(x0), torch.tensor(rhs))
    assert (int(r.iterations), int(r.status)) == (37, PoissonStatus.MAX_ITER)


def test_fused_loop_chunks_agree(monkeypatch):
    """Sweeps queued past a converged chunk are frozen no-ops: chunks of 1
    and 16 sweeps give the same count, residual and x."""
    shape = (9, 12, 14)
    prob, _ = _problems(shape)
    x0, rhs = _system(shape)
    params = PoissonParams(tolerance=1e-2, max_iterations=300,
                           check_interval=3)
    out = []
    for chunk in (1, 16):
        monkeypatch.setattr(krylov, "CHUNK", chunk)
        out.append(stationary.make_redblack_sor_fused(prob, params)(
            torch.tensor(x0), torch.tensor(rhs)))
    a, b = out
    assert int(a.iterations) == int(b.iterations) < 300
    assert int(a.iterations) % 3 == 0 and int(a.status) == int(b.status)
    assert torch.equal(a.final_residual, b.final_residual)
    assert torch.equal(a.x, b.x)


# ---- the front end ------------------------------------------------------------

@pytest.mark.parametrize("method", [Method.JACOBI, Method.REDBLACK_SOR,
                                    Method.BICGSTAB])
@pytest.mark.parametrize("shape", [(1, 33, 65), (6, 16, 128)],
                         ids=["65x33", "128x16x6"])
def test_frontend_matches_reference(method, shape):
    """float64 takes the plain solve, float32 the kernel solve, in both
    packages (the reference's with ``use_pallas=True`` in interpret mode):
    the same (x, stats) at the bars of the makers above."""
    prob, _ = _problems(shape, (0.05, 0.05, 0.05 if shape[0] > 1 else 0.0))
    pp = PoissonParams(tolerance=1e-3, max_iterations=400)
    dims = dict(nx=shape[2], ny=shape[1], nz=shape[0], dx=prob.dx,
                dy=prob.dy, dz=prob.dz)
    s = frontend.create_solver(method, pp, device="cpu").init(**dims)
    js = jfrontend.create_solver(JMethod(int(method)), JParams(
        tolerance=1e-3, max_iterations=400))
    js.init(**dims, use_pallas=True)
    x0, rhs = _system(shape, seed=4)
    x64_tol = 1e-12
    if method == Method.BICGSTAB:
        # a smooth rhs, zero start: BiCGSTAB's float64 trajectories under
        # two summation orders part after ~30 iterations of a rough one
        # (tests/test_torch_bicgstab.py::_rhs)
        nz, ny, nx = shape
        y = np.linspace(0, 1, ny)[None, :, None]
        xs = np.linspace(0, 1, nx)[None, None, :]
        rhs = np.sin(np.pi * xs) * np.sin(np.pi * y) * np.ones(shape) \
            + 0.005 * rhs
        x0, x64_tol = np.zeros(shape), 1e-9
    for np_dt, x_tol in ((np.float64, x64_tol), (np.float32, 1e-3)):
        x, st = s.solve(x0.astype(np_dt), rhs.astype(np_dt))
        jx, jst = js.solve(jnp.asarray(x0.astype(np_dt)),
                           jnp.asarray(rhs.astype(np_dt)))
        assert x.dtype == (torch.float64 if np_dt == np.float64
                           else torch.float32)
        assert st.status == jst.status
        slack = 3 if method == Method.BICGSTAB and np_dt == np.float32 \
            else 0
        assert abs(st.iterations - jst.iterations) <= slack
        ref = np.asarray(jx)
        np.testing.assert_allclose(x.numpy(), ref, rtol=0,
                                   atol=x_tol * np.abs(ref).max())


def test_jacobi_factory_defaults():
    """``max_iterations=2000`` and ``check_interval=10`` when the user gave
    no params, never over user params (`frontend.py:189-199`,
    `:254-258`); the params after ``init`` equal the reference's."""
    def fields(p):
        return {f.name: getattr(p, f.name)
                for f in dataclasses.fields(PoissonParams)}

    user = PoissonParams(max_iterations=77)
    cases = [(dict(), None), (dict(params=user), None), (dict(), user)]
    for create_kw, init_params in cases:
        s = frontend.create_solver(Method.JACOBI, device="cpu",
                                   **create_kw).init(9, 9, params=init_params)
        jkw = {} if "params" not in create_kw else dict(
            params=JParams(max_iterations=77))
        js = jfrontend.create_solver(JMethod.JACOBI, **jkw)
        js.init(9, 9, params=None if init_params is None
                else JParams(max_iterations=77))
        assert fields(s.params) == {k: (int(v) if k == "preconditioner"
                                        else v)
                                    for k, v in fields(js.params).items()}
    assert s.params.max_iterations == 77 and s.params.check_interval == 1
    s = frontend.create_solver(Method.JACOBI, device="cpu").init(9, 9)
    assert (s.params.max_iterations, s.params.check_interval) == (2000, 10)
    s.init(11, 11)                    # a re-init keeps them
    assert (s.params.max_iterations, s.params.check_interval) == (2000, 10)
    s = frontend.create_solver(Method.REDBLACK_SOR, device="cpu").init(9, 9)
    assert s.params == PoissonParams()


def test_frontend_kernel_choice(monkeypatch):
    """float32 takes the whole-solve wrappers on 2D grids (and Jacobi's on
    3D ones), the BiCGSTAB passes and the Red-Black SOR sweep on 3D
    ones."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((vmem_small, "rbsor_solve"),
                         (vmem_small, "jacobi_solve"),
                         (vmem_small, "bicgstab_solve"),
                         (sk, "rbsor_sweep_plain"),
                         (bk, "pass_pv_plain")):
        spy(module, name)
    expect = {(Method.REDBLACK_SOR, 1): "rbsor_solve",
              (Method.REDBLACK_SOR, 5): "rbsor_sweep_plain",
              (Method.JACOBI, 1): "jacobi_solve",
              (Method.JACOBI, 5): "jacobi_solve",
              (Method.BICGSTAB, 1): "bicgstab_solve",
              (Method.BICGSTAB, 5): "pass_pv_plain"}
    for (method, nz), name in expect.items():
        calls.clear()
        s = frontend.create_solver(method, PoissonParams(max_iterations=3),
                                   device="cpu").init(9, 9, nz, 0.1, 0.1,
                                                      0.1 if nz > 1 else 0)
        shape = (nz, 9, 9)
        s.solve(np.zeros(shape, np.float32), np.ones(shape, np.float32))
        assert set(calls) == {name}, (method, nz, calls)
        calls.clear()
        s.solve(np.zeros(shape), np.ones(shape))
        assert not calls                 # float64: the plain solve


@pytest.mark.parametrize("preset", ["default", "JACOBI_SIMD"])
def test_cached_presets_match_reference(preset):
    """``poisson_solve`` with the default preset (Red-Black SOR) and with
    ``JACOBI_SIMD`` (Jacobi's factory defaults) at 33²: the same (x,
    iterations) as the reference's cached API."""
    x0, rhs = _system((33, 33), seed=9)
    kw = {} if preset == "default" else dict(
        preset=frontend.SolverPreset[preset])
    jkw = {} if preset == "default" else dict(
        preset=jfrontend.SolverPreset[preset])
    frontend.clear_cache()
    jfrontend.clear_cache()
    x, it = frontend.poisson_solve(x0, rhs, 33, 33, 1 / 32, 1 / 32,
                                   device="cpu", **kw)
    jx, jit = jfrontend.poisson_solve(jnp.asarray(x0), jnp.asarray(rhs), 33,
                                      33, 1 / 32, 1 / 32, **jkw)
    assert it == jit
    ref = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
