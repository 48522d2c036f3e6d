"""The RK2 / RK4 stage kernel (counterpart of
`cfd_tpu/ops/pallas/rk_kernels.py`, RK3 ``make_rk_stage``).

Single device, a uniform or stretched x/y grid (``ExplicitConsts.
spacing``, as in `euler_kernels`), the built-in decaying sources, with or
without Boussinesq buoyancy (every stage, with the step-start T) and the
energy equation with its thermal faces (the final stage; T advected by
the final velocities, `rk_kernels.py:325-360`).  One stage, with
(factor, acc_mix, weight) choosing its Butcher position:

    k    = RHS(stage state)    periodic-interior stencils, zero on the
                               shell and where ρ ≤ 1e-10
    next = clamp(q0 + factor·(acc_mix·acc + k))   velocities ±100
    acc' = acc + weight·k

A mid stage returns (next u, v, w, p, acc′ u, v, w, p); the final stage
returns the finished state (next, ρ, T with the periodic wrap x → y → z,
velocities included) and the step maxima
``(max|u|², max p, max|p|, max T)``.  ``acc=None`` is a zero accumulator
(the first stage), which the kernel does not read.

The TPU kernel (one streaming pass per stage on the rolling engine,
compute `rk_kernels.py:186-359`, z-wrap planes as pinned inputs) becomes
one CUDA kernel, ``cfd_rk_stage`` in ``cfd_tpu_torch/csrc/rk_kernels.cu``:
one thread per point, the periodic-interior neighbours as index maps (no
pins), the final stage's faces evaluated at their wrap sources.  The 2D
form (`rk2d.py`) is the same kernel's nz == 1 instantiation.

:func:`rk_stage` launches the kernel on a CUDA tensor and runs
:func:`rk_stage_plain` on a CPU tensor; its ``launches`` attribute counts
kernel launches (mid and final stages alike).  Kernel note: ~13 fields in
and 8 (mid) or 6 (final) out per stage, bound by device-memory bandwidth.
"""

from __future__ import annotations

import ctypes

import torch

from ...boundary.apply import apply_periodic_scalar
from ...solvers.ns.common import clamp
from ...solvers.ns.params import (MAX_DERIVATIVE_LIMIT, MAX_DIVERGENCE_LIMIT,
                                  MAX_SECOND_DERIVATIVE_LIMIT,
                                  MAX_VELOCITY_LIMIT)
from ..stencils import (interior_mask, sx_m_periodic_interior,
                        sx_p_periodic_interior, sy_m_periodic_interior,
                        sy_p_periodic_interior, sz_m_periodic_interior,
                        sz_p_periodic_interior)
from . import native
from .euler_kernels import (ExplicitConsts, buoyant_sources, check_inputs,
                            energy_update_plain, maxima, maxima_buffers,
                            thermal_output, viscosity)


def momentum_rhs_plain(u, v, w, p, rho, sy, sx, su_eff, sv_eff,
                       c: ExplicitConsts, T=None):
    """(k_u, k_v, k_w, k_p): the semi-discrete RHS with periodic-interior
    stencils (`cfd_tpu/solvers/ns/rk.py:52-116`) in the kernel's
    operation order; zero on the shell, and ×0 where ρ ≤ 1e-10; with
    buoyancy (``c.thermal``) ``T`` adds the buoyant sources.  On a
    one-plane field every z term is dropped."""
    _, _, i2z, _, _, iz2 = c.derivs()
    three_d = c.nz > 1
    dx1, dy1, dx2, dy2 = c.xy_operators()

    def d1(a):
        return clamp(a, MAX_DERIVATIVE_LIMIT)

    def d2(a):
        return clamp(a, MAX_SECOND_DERIVATIVE_LIMIT)

    def terms(f):
        """(∂x f, ∂y f, ∂z f, ∇²f) from the periodic-interior
        neighbours, each derivative and each second-derivative term
        clamped; on a stretched grid with the weights of the point."""
        xl, xr = sx_m_periodic_interior(f), sx_p_periodic_interior(f)
        yd, yu = sy_m_periodic_interior(f), sy_p_periodic_interior(f)
        lap = d2(dx2(xl, f, xr)) + d2(dy2(yd, f, yu))
        dz = None
        if three_d:
            zb, zf = sz_m_periodic_interior(f), sz_p_periodic_interior(f)
            dz = d1((zf - zb) * i2z)
            lap = lap + d2(((zf - 2.0 * f) + zb) * iz2)
        return d1(dx1(xl, f, xr)), d1(dy1(yd, f, yu)), dz, lap

    du_dx, du_dy, du_dz, lap_u = terms(u)
    dv_dx, dv_dy, dv_dz, lap_v = terms(v)
    dw_dx, dw_dy, dw_dz, lap_w = terms(w)
    dp_dx, dp_dy, dp_dz, _ = terms(p)
    nu = viscosity(c.mu, rho)
    su, sv, sw = buoyant_sources(su_eff * sy[None, :, None],
                                 sv_eff * sx[None, None, :], T, c)

    tu = -u * du_dx - v * du_dy
    tv = -u * dv_dx - v * dv_dy
    tw = -u * dw_dx - v * dw_dy
    div = du_dx + dv_dy
    if three_d:
        tu = tu - w * du_dz
        tv = tv - w * dv_dz
        tw = (tw - w * dw_dz) - dp_dz / rho
        div = div + dw_dz
    ok = (rho > 1e-10).to(u.dtype)
    interior = interior_mask(u.shape, torch.bool, u.device)

    def on_interior(k):
        return torch.where(interior, k * ok, 0.0)

    rw = tw + nu * lap_w
    return (on_interior(((tu - dp_dx / rho) + nu * lap_u) + su),
            on_interior(((tv - dp_dy / rho) + nu * lap_v) + sv),
            on_interior(rw if sw is None else rw + sw),
            on_interior((-c.pressure_coupling * rho)
                        * clamp(div, MAX_DIVERGENCE_LIMIT)))


def rk_stage_plain(state, q0, rho, T, acc, sy, sx, scal, c: ExplicitConsts,
                   final: bool):
    """One RK stage in plain PyTorch, in the kernel's operation order.
    ``state``, ``q0`` and ``acc`` are (u, v, w, p) tuples (``acc`` may be
    None); ``scal`` = [factor, acc_mix, weight, su, sv, dt] (dt read by
    the final stage's energy update only).  Also the plain version of the
    2D kernel."""
    factor, acc_mix, weight = scal[0], scal[1], scal[2]
    ks = momentum_rhs_plain(*state, rho, sy, sx, scal[3], scal[4], c, T)
    accs = (0.0,) * 4 if acc is None else acc
    nxt = [q + factor * (acc_mix * a + k) for q, a, k in zip(q0, accs, ks)]
    nxt[:3] = [clamp(f, MAX_VELOCITY_LIMIT) for f in nxt[:3]]
    if not final:
        return (*nxt, *(a + weight * k for a, k in zip(accs, ks)))
    T_upd = (energy_update_plain(T, *nxt[:3], scal[5], c)
             if c.thermal.energy else T)
    uo, vo, wo, po, rho_o = (apply_periodic_scalar(f) for f in (*nxt, rho))
    T_o = thermal_output(T_upd, c)
    return (uo, vo, wo, po, rho_o, T_o, *maxima(uo, vo, wo, po, T_o))


def launch_rk(state, q0, rho, T, acc, sy, sx, scal, c: ExplicitConsts,
              final: bool):
    """One ``cfd_rk_stage`` launch (3D or 2D instantiation, by ``c.nz``);
    returns the outputs in :func:`rk_stage_plain`'s order."""
    check_inputs(c, (*state, *q0, rho, T, *(acc or ())), sy, sx, scal)
    if final and c.thermal.energy and scal.numel() < 6:
        raise ValueError("the final stage's energy update reads dt, "
                         "scal[5]")
    u = state[0]
    outs = [torch.empty_like(u) for _ in range(6 if final else 8)]
    partials, red = maxima_buffers(c, u) if final else (None, None)

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*(
            None if t is None else native.ptr(t) for t in ts))

    ins = ptrs((*state, *q0, rho, T, *(acc or (None,) * 4), sy, sx, scal))
    out_arr = ptrs((*outs, *(None,) * (8 - len(outs))))
    native.launch("cfd_rk_stage", u.device, ins, out_arr,
                  None if partials is None else native.ptr(partials),
                  None if red is None else native.ptr(red),
                  *c.kernel_args(), int(final), *c.thermal.kernel_args(),
                  *c.kernel_spacing())
    if not final:
        return tuple(outs)
    return (*outs, red[0], red[1], red[2], red[3])


def rk_stage(state, q0, rho, T, acc, sy, sx, scal, c: ExplicitConsts,
             final: bool):
    """RK3, one 3D stage — ``rk_kernel<true, final, *>`` on CUDA."""
    if native.on_cpu(state[0]):
        return rk_stage_plain(state, q0, rho, T, acc, sy, sx, scal, c, final)
    if c.nz < 3:
        raise ValueError("rk_stage is the 3D kernel (nz >= 3)")
    out = launch_rk(state, q0, rho, T, acc, sy, sx, scal, c, final)
    native.count_launch(rk_stage, c.scheme)
    return out


native.reset_counts(rk_stage)
