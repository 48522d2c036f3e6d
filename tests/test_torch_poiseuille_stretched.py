"""The reference's stretched Poiseuille channel on the port
(`tests/validation/test_poiseuille.py:110-165`,
`examples/poiseuille_stretched_grid.c:210-232`): 40×32, 500 steps of the
default (parity, CG) projection step with no-slip walls, the parabolic
inlet and the zero-gradient outlet, β = 0, 1.5 and 2.0.  The port's
outlet L2 error against the parabola is within 1e-5 of the reference's
run (float64, both on the CPU), under the reference's bars 0.05 / 0.20 /
0.30, uniform below stretched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfd_tpu import Grid as JGrid
from cfd_tpu_torch import FlowField
from cfd_tpu_torch.boundary import (InletConfig, OutletConfig, apply_inlet,
                                    apply_noslip, apply_outlet_velocity)
from cfd_tpu_torch.interop import grid_from
from cfd_tpu_torch.solvers.ns.params import NSParams
from cfd_tpu_torch.solvers.ns.projection import make_projection_step
from tests.validation.test_poiseuille import (HEIGHT, LENGTH,
                                              NU_STRETCHED, U_MAX,
                                              analytic_u,
                                              run_poiseuille_stretched)

torch.set_num_threads(min(2, torch.get_num_threads()))

BARS = {0.0: 0.05, 1.5: 0.20, 2.0: 0.30}


def run_port(beta, nx=40, ny=32, steps=500, device="cpu",
             dtype=torch.float64):
    """The reference harness's run_case on the port: the same grid (from
    the reference's constructor), dt, BCs and L2."""
    if beta:
        jg = JGrid.stretched(nx, ny, xmax=LENGTH, ymax=HEIGHT, beta=beta)
    else:
        jg = JGrid.uniform(nx, ny, xmax=LENGTH, ymax=HEIGHT)
    grid = grid_from(jg)
    min_dy = float(np.min(grid.dy))
    dt = min(5e-4, 0.25 * min_dy * min_dy / NU_STRETCHED)
    params = NSParams(dt=dt, mu=NU_STRETCHED, max_iter=1,
                      source_amplitude_u=0.0, source_amplitude_v=0.0)
    step = make_projection_step(grid, params, dtype=dtype, device=device)
    inlet = InletConfig.parabolic(U_MAX)
    outlet = OutletConfig.zero_gradient()
    Y = np.broadcast_to(np.asarray(grid.y)[None, :, None], grid.shape)
    field = FlowField.quiescent(nx, ny, dtype=dtype, device=device)
    field = field.replace(u=torch.as_tensor(analytic_u(Y), dtype=dtype,
                                            device=device))
    worst = 0
    for i in range(steps):
        u, v = apply_noslip(field.u, field.v)
        u, v = apply_inlet(u, v, inlet)
        u, v = apply_outlet_velocity(u, v, outlet)
        field, res = step(field.replace(u=u, v=v), dt, i)
        worst = max(worst, abs(int(res.status)))
    u_num = field.u[0, 1:-1, -2].double().cpu().numpy()
    u_ana = analytic_u(np.asarray(grid.y))[1:-1]
    return float(np.sqrt(np.mean((u_num - u_ana) ** 2))), worst, field


@pytest.fixture(scope="module")
def l2s():
    out = {}
    for beta in BARS:
        l2, worst, field = run_port(beta)
        jl2, _, jfield = run_poiseuille_stretched(beta)
        out[beta] = (l2, worst, jl2, field, jfield)
    return out


@pytest.mark.parametrize("beta", sorted(BARS))
def test_stretched_poiseuille_matches_reference(l2s, beta):
    l2, worst, jl2, field, jfield = l2s[beta]
    assert worst == 0
    assert abs(l2 - jl2) < 1e-5
    assert l2 < BARS[beta]
    u = field.u[0].numpy()
    assert np.abs(u[0]).max() == 0.0 and np.abs(u[-1]).max() == 0.0
    assert np.abs(field.v.numpy()).max() < 0.05


def test_stretched_poiseuille_ordering(l2s):
    """Uniform below stretched under the parity scheme's uniform-index
    stencils, as the reference's table shows."""
    assert l2s[0.0][0] < l2s[1.5][0] < l2s[2.0][0]
