"""Chorin projection step (counterpart of `cfd_tpu/solvers/ns/projection.py`,
the DST-fused single-device branches: 3D `:544-657`, 2D `:659-717`).

A 3D step is the reference's two-kernel spectral projection:

* A1 (`ProjectionKernels.predictor_poisson_input`): predictor
  u* = clamp(u + dt(−u·∇u + ν∇²u + f)) with caller shells passed through,
  b̃ = face_coeff·p − (ρ/dt)∇·u*, forward xy DST and the Thomas forward
  sweep along z;
* A2 (`ProjectionKernels.corrector_bwd_diag`): Thomas back substitution,
  inverse xy DST to the pressure (mirror shells), corrector
  u = clamp(u* − (dt/ρ)∇p), and the diagnostics' interior maxima;

then two z-shell face maxima complete max|u|², max p and max|p| exactly
as `field_status_and_diagnostics` would over the whole field.

A 2D step (nz == 1) is the reference's DST-fused 2D form on every grid:
`Projection2DKernels.predictor_and_poisson_input` (predictor and b̃·FxT),
the y-line solve of `make_dst2d_fused_pieces` (Thomas + dense low-mode
rescue), `Projection2DKernels.corrector` (p = x̂·GxT, corrector); w = w*,
and the diagnostics come from `field_status_and_diagnostics` over the new
field, as the reference's 2D step does.

ρ is taken from the first grid point, floored at 1e-10 → 1.0.  The step
never reads a device value on the host: dt, the decayed source
amplitudes, ρ and every diagnostic stay 0-d device tensors.

Anything outside this slice raises ``CFDError(ERROR_UNSUPPORTED)``; each
exclusion is a later slice in ROADMAP.md.
"""

from __future__ import annotations

import torch

from ...config import device_of, resolve_device, resolve_dtype
from ...core.field import FlowField
from ...core.grid import Grid
from ...core.status import CFDError, Status
from ...ops.kernels.projection2d import Projection2DKernels
from ...ops.kernels.projection_kernels import ProjectionKernels
from ..poisson.base import Method, PoissonProblem
from ..poisson.spectral import make_dst2d_fused_pieces, make_dst_fused_pieces
from .common import (field_status_and_diagnostics, step_result,
                     validate_grid_for_solver)
from .params import NSParams


def _unsupported(what: str):
    raise CFDError(Status.ERROR_UNSUPPORTED,
                   f"projection step: {what} is not ported yet")


def _check_slice(grid: Grid, params: NSParams, poisson_method,
                 spectral_precision, differentiable, bc_refresh,
                 dtype, device):
    if Method(poisson_method) != Method.FFT_DIRECT:
        _unsupported(f"poisson_method {Method(poisson_method).name}")
    if 1 < grid.nz < 4:
        _unsupported("nz < 4 (the three-pass form)")
    if not grid.is_uniform():
        _unsupported("a stretched grid")
    if params.nonuniform_scheme == "consistent":
        _unsupported("the consistent nonuniform scheme")
    if params.energy_enabled or params.heat_source_func is not None:
        _unsupported("the energy equation")
    if params.buoyancy_enabled:
        _unsupported("Boussinesq buoyancy")
    if params.source_func is not None:
        _unsupported("a custom source_func")
    if bc_refresh is not None:
        _unsupported("bc_refresh")
    if differentiable:
        _unsupported("the differentiable step")
    if spectral_precision not in (None, "highest"):
        _unsupported(f"spectral_precision={spectral_precision!r} "
                     f"(only 'highest', IEEE fp32, is ported)")
    if device.type == "cuda" and dtype != torch.float32:
        _unsupported(f"{dtype} on CUDA (the kernels are float32)")


def make_projection_step(grid: Grid, params: NSParams, dtype=None,
                         poisson_method: Method = Method.FFT_DIRECT,
                         device=None, spectral_precision=None,
                         differentiable: bool = False, bc_refresh=None,
                         plain: bool = False):
    """Build ``step(field, dt, iter_idx) -> (field, StepResult)`` for a 3D
    (nz ≥ 4) or 2D (nz == 1) uniform grid.

    On the card (the default, ``device=None``) the step launches the
    hand-written kernels; with ``device="cpu"`` the same wrappers run
    their plain PyTorch versions.  Without a CUDA device the default
    raises (`config.resolve_device`).

    ``plain=True`` is a reference switch for checks on the card only: it
    runs the plain versions on a CUDA device too, so ``chip_smoke.py`` can
    hold the kernel step against them and time both.  On the CPU both
    settings run the same code; callers leave it False.
    """
    device = device_of(device)
    dtype = resolve_dtype(dtype, device)
    _check_slice(grid, params, poisson_method, spectral_precision,
                 differentiable, bc_refresh, dtype, device)
    validate_grid_for_solver(grid, grid.shape)
    device = resolve_device(device)

    problem = PoissonProblem(grid.nx, grid.ny, grid.nz, grid.dx0,
                             grid.dy0, grid.dz0)
    with_sources = (params.source_amplitude_u != 0.0
                    or params.source_amplitude_v != 0.0)
    decay_rate = params.source_decay_rate
    amp_u, amp_v = params.source_amplitude_u, params.source_amplitude_v

    def scalars(field: FlowField, dt, iter_idx):
        """(dt, su, sv, ρ) as 0-d tensors on the field's device."""
        # a fill, not a host-to-device copy (which would synchronise)
        dt = (dt.to(dtype) if torch.is_tensor(dt)
              else torch.full((), dt, dtype=dtype, device=field.device))
        decay = torch.exp((-decay_rate * iter_idx) * dt)
        rho0 = field.rho[0, 0, 0]
        rho0 = torch.where(rho0 < 1e-10, torch.ones_like(rho0), rho0)
        return dt, amp_u * decay, amp_v * decay, rho0

    if grid.nz == 1:
        fxt, gxt, ysolve = make_dst2d_fused_pieces(problem, dtype, device,
                                                   plain=plain)
        pk2 = Projection2DKernels(
            grid.ny, grid.nx, grid.dx0, grid.dy0, grid.xmin, grid.ymin,
            params.mu, (fxt, gxt), with_sources=with_sources, plain=plain)

        def step_2d(field: FlowField, dt, iter_idx):
            dt, su, sv, rho0 = scalars(field, dt, iter_idx)
            us, vs, ws, bt_x = pk2.predictor_and_poisson_input(
                field.u, field.v, field.w, field.p, dt, su, sv, rho0 / dt)
            u, v, p = pk2.corrector(us, vs, ysolve(bt_x), dt / rho0)
            # the w-correction is identically zero in 2D (inv_dz2 = 0)
            new_field = field.replace(u=u, v=v, w=ws, p=p)
            return new_field, step_result(
                *field_status_and_diagnostics(new_field))

        return step_2d

    mats, tdma_fwd = make_dst_fused_pieces(problem, dtype, device)
    pk = ProjectionKernels(
        grid.nz, grid.ny, grid.nx, grid.dx0, grid.dy0, grid.dz0,
        grid.xmin, grid.ymin, params.mu, mats, tdma_fwd,
        with_sources=with_sources, plain=plain)

    def step(field: FlowField, dt, iter_idx):
        dt, su, sv, rho0 = scalars(field, dt, iter_idx)
        us, vs, ws, d, t = pk.predictor_poisson_input(
            field.u, field.v, field.w, field.p, dt, su, sv, rho0 / dt)
        u, v, w, p, m2i, pmaxi, pabsi = pk.corrector_bwd_diag(
            us, vs, ws, d, t, dt / rho0)
        new_field = field.replace(u=u, v=v, w=w, p=p)

        # the kernels' maxima cover planes 1..nz−2; fold in the z-shells
        def m2_face(k):
            return torch.amax(u[k] ** 2 + v[k] ** 2 + w[k] ** 2)

        faces = (0, -1)
        m2 = torch.maximum(m2i, torch.maximum(*map(m2_face, faces)))
        pmax = torch.maximum(pmaxi, torch.maximum(
            *(torch.amax(p[k]) for k in faces)))
        pabs = torch.maximum(pabsi, torch.maximum(
            *(torch.amax(torch.abs(p[k])) for k in faces)))
        finite = torch.isfinite(m2) & torch.isfinite(pabs)
        return new_field, step_result(finite, torch.sqrt(m2), pmax,
                                  torch.amax(field.T))

    return step
