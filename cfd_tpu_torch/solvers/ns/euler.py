"""Explicit Euler integrator (counterpart of `cfd_tpu/solvers/ns/euler.py`).

One step is one kernel launch: the fused Euler step
(`ops.kernels.euler_kernels.euler_step` in 3D, `ops.kernels.euler2d.
euler2d_step` in 2D) with the reference's semantics
(`cpu/solver_explicit_euler.c:337-582`):

* the conservative dt cap ``min(dt, 1e-4)``;
* derivative / update / velocity clamps (±100, ±1000, ±1, ±100);
* the artificial pressure coupling dp = −0.1·dt·ρ·clamp(div);
* per-point ρ ≤ 1e-10 guards that keep the old values;
* the boundary dance: periodic wrap of p, ρ and T (x → y → z), the
  caller's velocity shells kept;
* with ``params.beta != 0`` the Boussinesq sources −β(T − T_ref)·g, with
  ``params.alpha > 0`` the energy equation (T advected by the updated
  velocities) and then the thermal faces of ``params.thermal_bc``, all in
  the same kernel (`euler.py:176-221`);
* on a stretched x/y grid the parity scheme's per-point forward spacings
  or the consistent scheme's exact nonuniform weights
  (``params.nonuniform_scheme``, `common.spacing_operators`).

The step is `_make_fused_euler_step` / `_make_fused_euler2d_step` of the
reference (`euler.py:226-320`) with both wraps inside the kernel.  It
never reads a device value on the host: the capped dt, the decayed
source amplitudes and the diagnostics stay 0-d device tensors.  The
plain version is differentiable as it is (tensor μ, α, β included);
``differentiable=True`` on the card pairs the kernel's value with its
autograd adjoint (`hybrid.pair_vjp`).

Anything outside this slice raises ``CFDError(ERROR_UNSUPPORTED)``.
"""

from __future__ import annotations

import torch

from ...config import device_of, resolve_device, resolve_dtype
from ...core.field import FlowField
from ...core.grid import Grid
from ...core.status import CFDError, Status
from ...ops.kernels.euler2d import euler2d_step
from ...ops.kernels.euler_kernels import (ExplicitConsts, Spacing,
                                          ThermalConsts, euler_step,
                                          euler_step_plain)
from ..energy import validate_thermal_bc
from .common import (iterate_with_divergence_guard, kernel_step,
                     runs_plain, source_basis, step_result, stretch_gate,
                     validate_grid_for_solver)
from .hybrid import check_params, pair_vjp
from .params import (DT_CONSERVATIVE_LIMIT, NSParams, param_value,
                     source_amplitudes)


def check_explicit_slice(name: str, grid: Grid, params: NSParams, dtype,
                         device):
    """Raise ``CFDError(ERROR_UNSUPPORTED)`` outside the explicit
    integrators' ported slice (each exclusion is a later slice in
    ROADMAP.md) and on the configurations the reference refuses; returns
    `common.stretch_gate`'s ``stretch`` tuple (None on a uniform grid)."""
    def unsupported(what):
        raise CFDError(Status.ERROR_UNSUPPORTED,
                       f"{name} step: {what} is not ported yet")

    stretch, reason = stretch_gate(grid, params)
    if reason is not None:
        # degenerate spacing, or parity + stretched + energy, which the
        # reference's energy step refuses (`energy.py:57-61`)
        raise CFDError(Status.ERROR_UNSUPPORTED, f"{name} step: {reason}")
    if params.heat_source_func is not None:
        unsupported("a heat_source_func")
    if params.source_func is not None:
        unsupported("a custom source_func")
    return stretch


def explicit_setup(name: str, grid: Grid, params: NSParams, dtype, device,
                   plain: bool):
    """Checks shared by the explicit step builders; returns (dtype,
    device, kernel constants, (sin πy, sin 2πx)).  A stretched x/y grid
    takes the weights of ``params.nonuniform_scheme`` (`ops.kernels.
    stretch`); the consistent scheme on a uniform grid is the parity step
    (`common.py:89`).  A kernel step (on the card, not ``plain``) refuses
    ``params`` that require grad (`hybrid.check_params`)."""
    device = device_of(device)
    dtype = resolve_dtype(dtype, device)
    stretch = check_explicit_slice(name, grid, params, dtype, device)
    if device.type == "cuda" and not runs_plain(dtype, plain):
        check_params(params, f"{name} step")
    validate_grid_for_solver(grid, grid.shape)
    if params.energy_enabled:
        validate_thermal_bc(params.thermal_bc, grid)
    device = resolve_device(device)
    spacing = None
    if stretch is not None:
        spacing = Spacing.of(stretch, params.nonuniform_scheme, dtype, device)
    consts = ExplicitConsts(grid.nz, grid.ny, grid.nx, grid.dx0, grid.dy0,
                            grid.dz0, param_value(params.mu),
                            param_value(params.pressure_coupling),
                            ThermalConsts.from_params(params, dtype),
                            spacing)
    return dtype, device, consts, source_basis(grid, dtype, device)


def as_scalar(dt, dtype, device) -> torch.Tensor:
    """``dt`` as a 0-d tensor on the field's device (a fill, not a
    host-to-device copy, which would synchronise; a tensor is moved)."""
    if torch.is_tensor(dt):
        return dt.to(device=device, dtype=dtype)
    return torch.full((), dt, dtype=dtype, device=device)


def explicit_result(m2, pmax, pabs, tmax):
    """StepResult from a kernel's four maxima over the new field."""
    finite = torch.isfinite(m2) & torch.isfinite(pabs)
    return step_result(finite, torch.sqrt(m2), pmax, tmax)


def make_euler_step(grid: Grid, params: NSParams, dtype=None, device=None,
                    differentiable: bool = False, plain: bool = False):
    """Build ``step(field, dt, iter_idx) -> (field, StepResult)`` on a 3D
    (nz ≥ 3) or 2D (nz == 1) grid, uniform or stretched in x/y (the
    reference's dispatch through `common.stretch_mode`, `euler.py:75-110`:
    ``params.nonuniform_scheme`` picks the parity or the consistent
    weights; parity with the energy equation raises, as the reference's
    energy step does).

    On the card (the default) the step launches the fused Euler kernel;
    with ``device="cpu"`` the same wrapper runs its plain version.
    ``plain=True`` runs the plain version on a CUDA device too (so
    ``chip_smoke.py`` can hold the kernel step against it and time both).

    The plain step is reverse- and forward-mode differentiable as it is,
    w.r.t. the field, dt and tensor-valued ``params`` fields (μ, α, β).
    ``differentiable=True`` maps as the reference maps it with
    ``use_pallas`` (`euler.py:60-66`): on the card (``plain=False``) it
    builds the hybrid step, the kernel's value and the plain step's
    adjoint (`hybrid.pair_vjp`; reverse mode, w.r.t. the field and dt);
    on the CPU or with ``plain=True`` the plain step.
    """
    if differentiable and kernel_step(dtype, device, plain):
        return pair_vjp(
            make_euler_step(grid, params, dtype, device),
            make_euler_step(grid, params, dtype, device, plain=True))
    dtype, device, consts, (sy, sx) = explicit_setup(
        "explicit Euler", grid, params, dtype, device, plain)
    if runs_plain(dtype, plain):
        fused = euler_step_plain
    else:
        fused = euler_step if grid.nz > 1 else euler2d_step

    def step(field: FlowField, dt, iter_idx):
        cdt = torch.clamp_max(as_scalar(dt, dtype, field.device),
                              DT_CONSERVATIVE_LIMIT)
        su, sv = source_amplitudes(params, iter_idx * cdt)
        u, v, w, p, rho, T, m2, pmax, pabs, tmax = fused(
            field.u, field.v, field.w, field.p, field.T, field.rho, sy, sx,
            torch.stack([cdt, su, sv]), consts)
        return (FlowField(u, v, w, p, rho, T),
                explicit_result(m2, pmax, pabs, tmax))

    return step


def make_euler_solve(grid: Grid, params: NSParams, dtype=None, device=None):
    """``solve(field, dt)``: ``params.max_iter`` steps with the divergence
    guard (explicit_euler_impl's iteration loop)."""
    step = make_euler_step(grid, params, dtype, device)

    def solve(field: FlowField, dt):
        return iterate_with_divergence_guard(step, field, dt, params.max_iter)

    return solve
