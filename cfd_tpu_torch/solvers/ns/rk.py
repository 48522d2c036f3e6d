"""RK2 (Heun) and RK4 (classical) integrators (counterpart of
`cfd_tpu/solvers/ns/rk.py`).

A step chains the fused stage kernel (`ops.kernels.rk_kernels.rk_stage`
in 3D, `ops.kernels.rk2d.rk2d_stage` in 2D) as the reference's
`_make_fused_rk_step` / `_make_fused_rk2d_step` (`rk.py:119-255`) do, with
(factor, acc_mix, weight) per stage:

* RK2: (dt, 0, 1), then the final stage (dt/2, 1, 0) —
  Q ← Q⁰ + (dt/2)(k1 + k2);
* RK4: (dt/2, 0, 1), (dt/2, 0, 2), (dt, 0, 2), then (dt/6, 1, 0) —
  Q ← Q⁰ + (dt/6)(k1 + 2k2 + 2k3 + k4).

The RHS uses periodic-interior stencils, no BCs are applied between
stages, and the final stage emits the periodic wrap of every field and
the step's maxima (`solver_rk2.c`, `solver_rk4.c`).  Boussinesq buoyancy
(β ≠ 0) joins every stage's sources with the step-start T; the energy
equation (α > 0) runs in the final stage on the final velocities, then
the thermal faces (`rk.py:119-186`).  No dt cap.  The step never reads a
device value on the host.
"""

from __future__ import annotations

import torch

from ...core.field import FlowField
from ...core.grid import Grid
from ...ops.kernels.rk2d import rk2d_stage
from ...ops.kernels.rk_kernels import (momentum_rhs_plain, rk_stage,
                                       rk_stage_plain)
from .common import iterate_with_divergence_guard, kernel_step, runs_plain
from .euler import as_scalar, explicit_result, explicit_setup
from .hybrid import pair_vjp
from .params import NSParams, source_amplitudes

# (dt divisor giving the factor, acc_mix, weight) of each stage
_TABLEAUS = {
    2: ((1, 0.0, 1.0), (2, 1.0, 0.0)),
    4: ((2, 0.0, 1.0), (2, 0.0, 2.0), (1, 0.0, 2.0), (6, 1.0, 0.0)),
}


def make_momentum_rhs(grid: Grid, params: NSParams, dtype=None,
                      device=None):
    """The shared semi-discrete RHS (`rk.py:52-116`): ``rhs(u, v, w, p,
    rho, T, iter_idx, dt) -> (k_u, k_v, k_w, k_p)``, nonzero on interior
    points only, in plain PyTorch."""
    dtype, device, consts, (sy, sx) = explicit_setup(
        "RK", grid, params, dtype, device, True)

    def rhs(u, v, w, p, rho, T, iter_idx, dt):
        dt = as_scalar(dt, dtype, u.device)
        su, sv = source_amplitudes(params, iter_idx * dt)
        return momentum_rhs_plain(u, v, w, p, rho, sy, sx, su, sv, consts,
                                  T)

    return rhs


def _make_rk_step(grid: Grid, params: NSParams, order: int, dtype, device,
                  differentiable: bool, plain: bool):
    if differentiable and kernel_step(dtype, device, plain):
        # the hybrid step (`rk.py:264-270`): the stage kernels' value, the
        # plain step's adjoint
        return pair_vjp(
            _make_rk_step(grid, params, order, dtype, device, False, False),
            _make_rk_step(grid, params, order, dtype, device, False, True))
    dtype, device, consts, (sy, sx) = explicit_setup(
        f"RK{order}", grid, params, dtype, device, plain)
    if runs_plain(dtype, plain):
        stage = rk_stage_plain
    else:
        stage = rk_stage if grid.nz > 1 else rk2d_stage
    tableau = _TABLEAUS[order]

    def step(field: FlowField, dt, iter_idx):
        dt = as_scalar(dt, dtype, field.device)
        su, sv = source_amplitudes(params, iter_idx * dt)
        one = torch.ones_like(dt)
        q0 = (field.u, field.v, field.w, field.p)
        state, acc = q0, None
        for n, (div, acc_mix, weight) in enumerate(tableau):
            scal = torch.stack([dt / div, acc_mix * one, weight * one, su,
                                sv, dt])
            final = n == len(tableau) - 1
            outs = stage(state, q0, field.rho, field.T, acc, sy, sx, scal,
                         consts, final)
            if not final:
                state, acc = outs[:4], outs[4:]
        u, v, w, p, rho, T, m2, pmax, pabs, tmax = outs
        return (FlowField(u, v, w, p, rho, T),
                explicit_result(m2, pmax, pabs, tmax))

    return step


def make_rk2_step(grid: Grid, params: NSParams, dtype=None, device=None,
                  differentiable: bool = False, plain: bool = False):
    """Build the RK2 (Heun) ``step(field, dt, iter_idx)`` on a 3D (nz ≥ 3)
    or 2D grid, uniform or stretched in x/y, on the card by default;
    the stretched weights, ``plain=True`` and ``differentiable=True`` (the
    hybrid step on the card, the plain step otherwise) as in
    `euler.make_euler_step`."""
    return _make_rk_step(grid, params, 2, dtype, device, differentiable,
                         plain)


def make_rk4_step(grid: Grid, params: NSParams, dtype=None, device=None,
                  differentiable: bool = False, plain: bool = False):
    """Build the classical RK4 ``step(field, dt, iter_idx)``; as
    :func:`make_rk2_step`."""
    return _make_rk_step(grid, params, 4, dtype, device, differentiable,
                         plain)


def _make_solve(maker, grid, params, dtype, device):
    step = maker(grid, params, dtype, device)

    def solve(field: FlowField, dt):
        return iterate_with_divergence_guard(step, field, dt, params.max_iter)

    return solve


def make_rk2_solve(grid: Grid, params: NSParams, dtype=None, device=None):
    return _make_solve(make_rk2_step, grid, params, dtype, device)


def make_rk4_solve(grid: Grid, params: NSParams, dtype=None, device=None):
    return _make_solve(make_rk4_step, grid, params, dtype, device)
