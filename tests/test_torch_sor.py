"""SOR and Gauss-Seidel against the reference's ``make_sor``
(`cfd_tpu/solvers/poisson/stationary.py:286-374`) and its cached presets
(`frontend.py`), on the CPU, in float64:

* the row recurrence's log-depth scan against a sequential loop;
* one sweep, 2D and 3D, SOR's ω and Gauss-Seidel's ω = 1: within
  1e-14·max|x|;
* the whole solve (2D 33², 3D 17×13×9, ``max_iterations`` capped at 200):
  the same iterations and status, x within 1e-12·max|x|;
* ``poisson_solve`` with the two SOR presets: the same (x, iterations).

Both packages get the same numpy inputs from ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu.solvers.poisson import frontend as jfrontend
from cfd_tpu.solvers.poisson import stationary as jstationary
from cfd_tpu.solvers.poisson.base import PoissonParams as JParams
from cfd_tpu.solvers.poisson.base import PoissonProblem as JProblem
from cfd_tpu_torch.solvers.poisson import frontend, stationary
from cfd_tpu_torch.solvers.poisson.base import (Method, PoissonParams,
                                                PoissonProblem)

torch.set_num_threads(min(2, torch.get_num_threads()))

SHAPES = [(1, 33, 33), (9, 13, 17)]
IDS = ["2d_33x33", "3d_17x13x9"]


def _problems(shape):
    nz, ny, nx = shape
    h = (1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1) if nz > 1 else 0.0)
    return PoissonProblem(nx, ny, nz, *h), JProblem(nx, ny, nz, *h)


def _system(shape, seed):
    """A normal start and a normal rhs whose interior sums to zero (a
    stationary solve stalls on any other: its Neumann problem has no
    solution)."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(0.0, 0.1, shape)
    rhs = rng.normal(0.0, 1.0, shape)
    interior = (slice(1, -1) if shape[0] > 1 else slice(None),
                slice(1, -1), slice(1, -1))
    rhs[interior] -= rhs[interior].mean()
    return x0, rhs


def test_linear_scan_matches_sequential_recurrence():
    """y[i] = a[i]·y[i−1] + c[i] on a batch of rows of every length from
    1 to 40 (odd lengths and powers of two)."""
    rng = np.random.default_rng(0)
    for n in range(1, 41):
        a = torch.as_tensor(rng.uniform(-0.9, 0.9, (3, n)))
        c = torch.as_tensor(rng.standard_normal((3, n)))
        want = torch.empty_like(c)
        y = torch.zeros(3, dtype=c.dtype)
        for i in range(n):
            y = a[:, i] * y + c[:, i]
            want[:, i] = y
        got = stationary._linear_scan(a, c)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-14 * float(want.abs().max()))


def _solve_both(shape, seed, **params):
    prob, jprob = _problems(shape)
    x0, rhs = _system(shape, seed)
    res = stationary.make_sor(prob, PoissonParams(**params))(
        torch.as_tensor(x0), torch.as_tensor(rhs))
    jres = jstationary.make_sor(jprob, JParams(**params))(
        jnp.asarray(x0), jnp.asarray(rhs))
    return res, jres


@pytest.mark.parametrize("omega", [0.0, 1.0], ids=["sor", "gauss_seidel"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_one_sweep_matches_reference(shape, omega):
    """One sweep and the mirror (``max_iterations=1``): x within
    1e-14·max|x| of the reference's sweep, SOR's optimal ω and
    Gauss-Seidel's ω = 1."""
    res, jres = _solve_both(shape, 4, omega=omega, max_iterations=1,
                            tolerance=0.0)
    assert int(res.iterations) == int(jres.iterations) == 1
    want = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("omega", [0.0, 1.0], ids=["sor", "gauss_seidel"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_make_sor_matches_reference(shape, omega):
    """The whole solve at the default tolerance, at most 200 sweeps: the
    same iterations and status, x within 1e-12·max|x|, and the ∞-norm
    residuals within 1e-12 of the initial one (a residual's rounding
    scales with ‖A‖·‖x‖, not with the residual)."""
    res, jres = _solve_both(shape, 5, omega=omega, max_iterations=200)
    assert int(res.iterations) == int(jres.iterations)
    assert int(res.status) == int(jres.status)
    r0 = float(jres.initial_residual)
    for name in ("initial_residual", "final_residual"):
        np.testing.assert_allclose(float(getattr(res, name)),
                                   float(getattr(jres, name)), rtol=0,
                                   atol=1e-12 * r0)
    want = np.asarray(jres.x)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_front_end_gauss_seidel_is_sor():
    """The front end's GAUSS_SEIDEL is the SOR maker with ω resolved as
    for SOR (the reference's `frontend.py:61-62`): the two solves are the
    same, with no kernel solve."""
    shape = SHAPES[0]
    x0, rhs = _system(shape, 6)
    out = {}
    for method in (Method.SOR, Method.GAUSS_SEIDEL):
        s = frontend.create_solver(method, PoissonParams(max_iterations=50),
                                   device="cpu").init(33, 33, 1, 1 / 32,
                                                      1 / 32)
        assert s._fused_fn is None
        out[method] = s.solve(torch.as_tensor(x0[0]), torch.as_tensor(
            rhs[0]))
    (xs, ss), (xg, sg) = out.values()
    assert torch.equal(xs, xg) and ss.iterations == sg.iterations == 50


@pytest.mark.parametrize("preset", ["SOR_SCALAR", "SOR_SIMD"])
def test_cached_sor_presets_match_reference(preset):
    """``poisson_solve`` with an SOR preset at 33²: the same (x,
    iterations) as the reference's cached API."""
    x0, rhs = _system((1, 33, 33), 9)
    frontend.clear_cache()
    jfrontend.clear_cache()
    x, it = frontend.poisson_solve(x0[0], rhs[0], 33, 33, 1 / 32, 1 / 32,
                                   frontend.SolverPreset[preset],
                                   device="cpu")
    jx, jit = jfrontend.poisson_solve(jnp.asarray(x0[0]),
                                      jnp.asarray(rhs[0]), 33, 33, 1 / 32,
                                      1 / 32,
                                      jfrontend.SolverPreset[preset])
    assert it == jit and it > 0
    ref = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
