"""The explicit Euler step's fused kernel (counterpart of
`cfd_tpu/ops/pallas/euler_kernels.py`, E3 ``make_euler_fused``).

Only the configuration the main path runs is ported: single device,
uniform grid, the built-in decaying sources, no energy equation, no
buoyancy.  The TPU kernel (one streaming pass on the rolling engine,
compute `euler_kernels.py:240-351`) becomes one CUDA kernel plus a
one-block reduction, ``cfd_euler_step`` in
``cfd_tpu_torch/csrc/euler_kernels.cu``: one thread per point, each
thread evaluating the update at its own periodic-wrap source so the p/ρ/T
faces need no second pass.  The 2D form (`euler2d.py`) is the same
kernel's nz == 1 instantiation.

:func:`euler_step` launches the kernel on a CUDA tensor and runs
:func:`euler_step_plain` on a CPU tensor; its ``launches`` attribute
counts kernel launches.  Both return
``(u, v, w, p, rho, T, max|u|², max p, max|p|, max T)`` with the maxima
over the whole output (NaN propagates).

Kernel note: a stencil at ~60 flops per 40 bytes moved (6 fields in, 6
out) is bound by device-memory bandwidth; neighbours come from L1/L2.
Clamps, max(ρ, 1e-10), min(ν, 1) and the maxima are selects that keep
NaN, as ``jnp.clip`` and ``jnp.max`` do.
"""

from __future__ import annotations

import dataclasses

import torch

from ...boundary.apply import apply_periodic_scalar
from ...solvers.ns.common import clamp
from ...solvers.ns.params import (MAX_DERIVATIVE_LIMIT, MAX_DIVERGENCE_LIMIT,
                                  MAX_SECOND_DERIVATIVE_LIMIT,
                                  MAX_VELOCITY_LIMIT, UPDATE_LIMIT)
from ..stencils import (d2dz2, interior_mask, sx_m, sx_p, sy_m, sy_p, sz_m,
                        sz_p)
from . import native


@dataclasses.dataclass(frozen=True)
class ExplicitConsts:
    """Constants of one uniform grid for the explicit kernels (the
    reference bakes the same Python floats into its kernels; the CUDA
    kernels take them as float32 arguments).  On a 2D grid (nz == 1) the
    z constants are 0."""

    nz: int
    ny: int
    nx: int
    dx: float
    dy: float
    dz: float
    mu: float
    pressure_coupling: float

    def derivs(self):
        """(1/2dx, 1/2dy, 1/2dz, 1/dx², 1/dy², 1/dz²)."""
        z = self.nz > 1
        return (1.0 / (2.0 * self.dx), 1.0 / (2.0 * self.dy),
                1.0 / (2.0 * self.dz) if z else 0.0,
                1.0 / (self.dx * self.dx), 1.0 / (self.dy * self.dy),
                1.0 / (self.dz * self.dz) if z else 0.0)

    def kernel_args(self):
        """The trailing scalar arguments of the C entry points."""
        return (self.nz, self.ny, self.nx, self.mu, self.pressure_coupling,
                *self.derivs())


def check_inputs(c: ExplicitConsts, fields, sy, sx, scal):
    """(nz, ny, nx) float32 fields, the (ny,) and (nx,) source vectors and
    the scalars, contiguous on one CUDA device."""
    native.check_cuda(*fields, sy, sx, scal)
    for f in fields:
        if tuple(f.shape) != (c.nz, c.ny, c.nx):
            raise ValueError(f"expected fields of shape "
                             f"{(c.nz, c.ny, c.nx)}, got {tuple(f.shape)}")
    if tuple(sy.shape) != (c.ny,) or tuple(sx.shape) != (c.nx,):
        raise ValueError("source vectors must be (ny,) and (nx,)")


def maxima_buffers(c: ExplicitConsts, like: torch.Tensor):
    """Per-block partials and the four maxima the kernels write."""
    n_part = native.library().cfd_explicit_partials(c.nz, c.ny, c.nx)
    return (torch.empty(4 * n_part, dtype=like.dtype, device=like.device),
            torch.empty(4, dtype=like.dtype, device=like.device))


def viscosity(mu: float, rho: torch.Tensor) -> torch.Tensor:
    """ν = min(μ / max(ρ, 1e-10), 1), a true division (``scalar / tensor``
    would multiply by a reciprocal)."""
    mu_t = torch.full((), mu, dtype=rho.dtype, device=rho.device)
    return torch.clamp_max(mu_t / torch.clamp_min(rho, 1e-10), 1.0)


def maxima(u, v, w, p, T):
    """(max|u|², max p, max|p|, max T) over the whole field."""
    m2 = torch.amax((u * u + v * v) + w * w)
    return m2, torch.amax(p), torch.amax(torch.abs(p)), torch.amax(T)


def euler_step_plain(u, v, w, p, T, rho, sy, sx, scal, c: ExplicitConsts):
    """The Euler step in plain PyTorch: the reference's jnp body
    (`cfd_tpu/solvers/ns/euler.py:119-221`) in the kernel's operation
    order.  ``scal`` = [cdt, su, sv] (the decayed source amplitudes);
    ``sy`` = sin(πy), ``sx`` = sin(2πx).  Velocity shells pass through
    (the wrap-then-restore of the reference's boundary dance); p, ρ and T
    take the periodic wrap of the updated field.  Also the plain version
    of the 2D kernel: on a one-plane field every z term is dropped."""
    cdt, su_eff, sv_eff = scal[0], scal[1], scal[2]
    i2x, i2y, i2z, ix2, iy2, iz2 = c.derivs()
    three_d = c.nz > 1

    def d1(a):
        return clamp(a, MAX_DERIVATIVE_LIMIT)

    def d2(a):
        return clamp(a, MAX_SECOND_DERIVATIVE_LIMIT)

    def grads(f):
        return (d1((sx_p(f) - sx_m(f)) * i2x), d1((sy_p(f) - sy_m(f)) * i2y),
                d1((sz_p(f) - sz_m(f)) * i2z) if three_d else None)

    def lap(f):
        c2 = 2.0 * f
        out = (d2(((sx_p(f) - c2) + sx_m(f)) * ix2)
               + d2(((sy_p(f) - c2) + sy_m(f)) * iy2))
        return out + d2(d2dz2(f, iz2)) if three_d else out

    du_dx, du_dy, du_dz = grads(u)
    dv_dx, dv_dy, dv_dz = grads(v)
    dw_dx, dw_dy, dw_dz = grads(w)
    dp_dx, dp_dy, dp_dz = grads(p)
    nu = viscosity(c.mu, rho)
    su = su_eff * sy[None, :, None]
    sv = sv_eff * sx[None, None, :]

    tu = -u * du_dx - v * du_dy
    tv = -u * dv_dx - v * dv_dy
    tw = -u * dw_dx - v * dw_dy
    div = du_dx + dv_dy
    if three_d:
        tu = tu - w * du_dz
        tv = tv - w * dv_dz
        tw = (tw - w * dw_dz) - dp_dz / rho
        div = div + dw_dz
    du = cdt * (((tu - dp_dx / rho) + nu * lap(u)) + su)
    dv = cdt * (((tv - dp_dy / rho) + nu * lap(v)) + sv)
    dw = cdt * (tw + nu * lap(w))

    upd = (interior_mask(u.shape, torch.bool, u.device)
           & (rho > 1e-10))     # interior, per-point ρ guard (NaN too)

    def vel(f, df):
        return torch.where(upd, clamp(f + clamp(df, UPDATE_LIMIT),
                                      MAX_VELOCITY_LIMIT), f)

    dp = clamp(((-c.pressure_coupling * cdt) * rho)
               * clamp(div, MAX_DIVERGENCE_LIMIT), UPDATE_LIMIT)
    uo, vo, wo = vel(u, du), vel(v, dv), vel(w, dw)
    po = apply_periodic_scalar(torch.where(upd, p + dp, p))
    To = apply_periodic_scalar(T)
    return (uo, vo, wo, po, apply_periodic_scalar(rho), To,
            *maxima(uo, vo, wo, po, To))


def launch_euler(c: ExplicitConsts, u, v, w, p, T, rho, sy, sx, scal):
    """One ``cfd_euler_step`` launch (the 3D or the 2D instantiation, by
    ``c.nz``); returns the outputs in :func:`euler_step_plain`'s order."""
    check_inputs(c, (u, v, w, p, T, rho), sy, sx, scal)
    outs = [torch.empty_like(u) for _ in range(6)]
    partials, red = maxima_buffers(c, u)
    native.launch("cfd_euler_step", u.device, *map(native.ptr, (
        u, v, w, p, T, rho, sy, sx, scal, *outs, partials, red)),
        *c.kernel_args())
    return (*outs, red[0], red[1], red[2], red[3])


def euler_step(u, v, w, p, T, rho, sy, sx, scal, c: ExplicitConsts):
    """E3, the whole 3D Euler step — ``euler_kernel<true>`` on CUDA."""
    if native.on_cpu(u):
        return euler_step_plain(u, v, w, p, T, rho, sy, sx, scal, c)
    if c.nz < 3:
        raise ValueError("euler_step is the 3D kernel (nz >= 3)")
    out = launch_euler(c, u, v, w, p, T, rho, sy, sx, scal)
    euler_step.launches += 1
    return out


euler_step.launches = 0
