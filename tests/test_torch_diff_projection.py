"""The plain differentiable projection step (``make_projection_step(...,
differentiable=True)`` on the CPU) against the reference's
(`use_pallas=False, differentiable=True`), float64, mirroring
`tests/solvers/test_adjoint.py:136-190` and `:250-275`.

The step swaps its pressure solve for the adjoint one
(`poisson.adjoint.make_adjoint_poisson`; FFT_DIRECT and the eigenbasis
solve as they are), so ``torch.autograd`` differentiates it end to end.
Gradients are held to ``jax.grad`` of the reference's step at 1e-9 of
max|grad|: the same solves to 1e-12 in both, in other summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import FlowField as JField
from cfd_tpu import Grid as JGrid
from cfd_tpu.solvers.ns import NSParams as JParams
from cfd_tpu.solvers.ns.projection import \
    make_projection_step as j_make_step
from cfd_tpu.solvers.poisson.base import Method as JMethod
from cfd_tpu.solvers.poisson.base import PoissonParams as JPoisson
from cfd_tpu_torch import Grid
from cfd_tpu_torch.interop import field_from_numpy, grid_from
from cfd_tpu_torch.solvers.ns import NSParams, make_rollout
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from cfd_tpu_torch.solvers.poisson.base import Method, PoissonParams

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(min(2, torch.get_num_threads()))

TIGHT = dict(tolerance=1e-12, absolute_tolerance=1e-13, max_iterations=4000)
NO_SOURCES = dict(source_amplitude_u=0.0, source_amplitude_v=0.0)


def _tg_arrays(jgrid):
    """`test_adjoint.py:120-127`'s Taylor-Green field."""
    X, Y, _ = jgrid.coordinate_arrays(jnp.float64)
    shape = (jgrid.nz, jgrid.ny, jgrid.nx)
    return dict(u=np.broadcast_to(np.sin(X) * np.cos(Y), shape).copy(),
                v=np.broadcast_to(-np.cos(X) * np.sin(Y), shape).copy(),
                w=np.zeros(shape), p=np.zeros(shape), rho=np.ones(shape),
                T=np.zeros(shape))


def _grids():
    jg = JGrid.uniform(17, 17, xmin=0, xmax=2 * np.pi, ymin=0,
                       ymax=2 * np.pi)
    return grid_from(jg), jg


def _steps(grid, jgrid, method, params=None, jparams=None):
    port = make_projection_step(
        grid, params or NSParams(**NO_SOURCES), torch.float64, method,
        PoissonParams(**TIGHT), device="cpu", differentiable=True)
    ref = j_make_step(jgrid, jparams or JParams(**NO_SOURCES),
                      poisson_method=JMethod(int(method)),
                      poisson_params=JPoisson(**TIGHT), use_pallas=False,
                      differentiable=True)
    return port, ref


def _ke(f):
    return 0.5 * (f.u ** 2 + f.v ** 2).sum()


def _close(got, want, rtol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"max abs deviation {err:.3e} of max {scale:.3e}")
    assert err <= rtol * scale


def _grad_one_step(port, ref, arrays, dt):
    f0 = field_from_numpy(arrays, "cpu", torch.float64)
    u = f0.u.clone().requires_grad_()
    f, res = port(f0.replace(u=u), dt, 0)
    assert int(res.status) == 0
    _ke(f).backward()
    jf0 = JField(**{k: jnp.asarray(a) for k, a in arrays.items()})
    want = jax.grad(lambda u0: 0.5 * jnp.sum(
        (lambda g: g.u ** 2 + g.v ** 2)(ref(jf0.replace(u=u0), dt, 0)[0])))(
        jf0.u)
    return u.grad, want


@pytest.mark.parametrize("method", [Method.CG, Method.FFT_DIRECT],
                         ids=["cg", "fft_direct"])
def test_grad_through_projection_step(method):
    """One differentiable projection step's d(KE)/du0 on the 17²
    Taylor-Green field (`test_adjoint.py:130-153`): CG through its adjoint
    solve, FFT_DIRECT through its products."""
    grid, jgrid = _grids()
    port, ref = _steps(grid, jgrid, method)
    got, want = _grad_one_step(port, ref, _tg_arrays(jgrid), 0.01)
    assert np.isfinite(got.numpy()).all()
    _close(got, want)


def test_grad_through_rollout_wrt_viscosity():
    """A tensor μ through a 4-step CG rollout (`test_adjoint.py:156-190`):
    more viscosity, faster decay, so d(KE)/dμ < 0, and it matches the
    reference's."""
    grid, jgrid = _grids()
    arrays = _tg_arrays(jgrid)
    mu = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    step = make_projection_step(grid, NSParams(mu=mu, **NO_SOURCES),
                                torch.float64, Method.CG,
                                PoissonParams(**TIGHT), device="cpu",
                                differentiable=True)
    f, _ = make_rollout(step, 4)(field_from_numpy(arrays, "cpu",
                                                  torch.float64), 0.01)
    _ke(f).backward()
    jf0 = JField(**{k: jnp.asarray(a) for k, a in arrays.items()})

    def ke_after(m):
        jstep = j_make_step(jgrid, JParams(mu=m, **NO_SOURCES),
                            poisson_method=JMethod.CG,
                            poisson_params=JPoisson(**TIGHT),
                            use_pallas=False, differentiable=True)

        def body(g, i):
            return jstep(g, 0.01, i)[0], ()

        g, _ = jax.lax.scan(body, jf0, jnp.arange(4))
        return 0.5 * jnp.sum(g.u ** 2 + g.v ** 2)

    want = float(jax.grad(ke_after)(0.05))
    assert float(mu.grad) < 0.0
    assert float(mu.grad) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("method", [Method.CG, Method.BICGSTAB,
                                    Method.FFT_DIRECT],
                         ids=["cg", "bicgstab", "fft_direct"])
def test_grad_through_consistent_projection_step(method):
    """The consistent scheme on a tanh-stretched (β = 1.5) 17² grid
    (`test_adjoint.py:250-275`): the volume-conjugated adjoint CG /
    BiCGSTAB, or the eigenbasis direct solve, from a random field."""
    jgrid = JGrid.stretched(17, 17, beta=1.5, stretch_axes="xy")
    grid = grid_from(jgrid)
    kw = dict(nonuniform_scheme="consistent", **NO_SOURCES)
    port, ref = _steps(grid, jgrid, method, NSParams(**kw), JParams(**kw))
    rng = np.random.default_rng(3)
    arrays = _tg_arrays(jgrid)
    arrays.update(u=rng.normal(0, 0.1, jgrid.shape),
                  v=rng.normal(0, 0.1, jgrid.shape))
    got, want = _grad_one_step(port, ref, arrays, 0.005)
    _close(got, want)


def test_plain_differentiable_step_routing():
    """The plain differentiable step runs the plain versions around its
    solve (the kernels' wrappers are not on its path), reports the solve's
    status, and its value equals the non-differentiable step's within the
    solves' tolerance."""
    grid, jgrid = _grids()
    arrays = _tg_arrays(jgrid)
    f0 = field_from_numpy(arrays, "cpu", torch.float64)
    diff = make_projection_step(grid, NSParams(**NO_SOURCES), torch.float64,
                                Method.CG, PoissonParams(**TIGHT),
                                device="cpu", differentiable=True)
    fwd = make_projection_step(grid, NSParams(**NO_SOURCES), torch.float64,
                               Method.CG, PoissonParams(**TIGHT),
                               device="cpu")
    fd, rd = diff(f0, 0.01, 0)
    ff, rf = fwd(f0, 0.01, 0)
    assert int(rd.status) == int(rf.status) == 0
    for k in ("u", "v", "p"):
        _close(getattr(fd, k), getattr(ff, k), 1e-10)
