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

On a decomposed shard's block (``rk_stage(..., shard=ShardBlock(...),
pins=...)``; `parallel.fused_explicit`) the stage is
``rk_shard_kernel`` through ``cfd_rk_stage_shard``, in the reference's
``global_nz`` mode (whole rows; the z neighbours of global planes 1 and
nz − 2 from pin planes; on ``global_nz_launches``) or ``global_nz`` +
``global_ny`` / 2D ``global_ny`` mode (the y neighbours by global row
over a periodic 2-row ring; on ``global_ny_launches``);
:func:`rk_stage_shard_plain` is its plain version.  Both return
``(fields, maxima)``: the stage's fields as the rows of one tensor
(a mid stage's eight, next state and accumulator, block-shaped; the
final stage's six, owned) and, for the final stage, its four maxima as
one (4,) tensor (None for a mid stage).

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
from .euler_kernels import (ExplicitConsts, ShardBlock, buoyant_sources,
                            check_inputs, energy_update_plain, maxima,
                            maxima_buffers, maxima_off, thermal_output,
                            viscosity)


def _periodic_interior(f, q):
    """(y down, y up, z back, z front) periodic-interior neighbours."""
    return (sy_m_periodic_interior(f), sy_p_periodic_interior(f),
            sz_m_periodic_interior(f), sz_p_periodic_interior(f))


def momentum_rhs_plain(u, v, w, p, rho, sy, sx, su_eff, sv_eff,
                       c: ExplicitConsts, T=None, neighbours=None,
                       interior=None):
    """(k_u, k_v, k_w, k_p): the semi-discrete RHS with periodic-interior
    stencils (`cfd_tpu/solvers/ns/rk.py:52-116`) in the kernel's
    operation order; zero on the shell, and ×0 where ρ ≤ 1e-10; with
    buoyancy (``c.thermal``) ``T`` adds the buoyant sources.  On a
    one-plane field every z term is dropped.  A shard's block gives its
    own y and z ``neighbours(f, q)`` (q: 0-3 for u, v, w, p) and
    ``interior`` mask (:func:`shard_neighbours`)."""
    _, _, i2z, _, _, iz2 = c.derivs()
    three_d = c.nz > 1
    dx1, dy1, dx2, dy2 = c.xy_operators()
    neighbours = neighbours or _periodic_interior

    def d1(a):
        return clamp(a, MAX_DERIVATIVE_LIMIT)

    def d2(a):
        return clamp(a, MAX_SECOND_DERIVATIVE_LIMIT)

    def terms(f, q):
        """(∂x f, ∂y f, ∂z f, ∇²f) from the periodic-interior
        neighbours, each derivative and each second-derivative term
        clamped; on a stretched grid with the weights of the point."""
        xl, xr = sx_m_periodic_interior(f), sx_p_periodic_interior(f)
        yd, yu, zb, zf = neighbours(f, q)
        lap = d2(dx2(xl, f, xr)) + d2(dy2(yd, f, yu))
        dz = None
        if three_d:
            dz = d1((zf - zb) * i2z)
            lap = lap + d2(((zf - 2.0 * f) + zb) * iz2)
        return d1(dx1(xl, f, xr)), d1(dy1(yd, f, yu)), dz, lap

    du_dx, du_dy, du_dz, lap_u = terms(u, 0)
    dv_dx, dv_dy, dv_dz, lap_v = terms(v, 1)
    dw_dx, dw_dy, dw_dz, lap_w = terms(w, 2)
    dp_dx, dp_dy, dp_dz, _ = terms(p, 3)
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
    if interior is None:
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


def shard_neighbours(c: ExplicitConsts, shard: ShardBlock, pins):
    """``(neighbours, interior)`` of :func:`momentum_rhs_plain` on a
    shard's block (the sharded modes, ``rk_shard_kernel``): the z
    neighbours of global planes 1 and nz_g − 2 from ``pins`` (planes of
    the block's rows: u, v, w, p at global plane nz_g − 2, then at global
    plane 1), the y neighbours of a global-row block (``shard.rows``) by
    global row: at global row 1 (ny_g − 2) the row three below (above),
    which the periodic 2-row halo ring makes global row ny_g − 2 (1);
    else the block's own periodic-interior rows.  ``interior``: the owned
    points off the x faces and off the global faces the wrapper rewrites
    (on a whole-row block, off the y faces too)."""
    three_d = c.nz > 1

    def neighbours(f, q):
        kgf = (shard.z_base - shard.hz
               + torch.arange(c.nz, device=f.device))[:, None, None]
        jgf = (shard.y_base - shard.hy
               + torch.arange(c.ny, device=f.device))[None, :, None]
        if shard.rows:
            yd = torch.where(jgf == 1, torch.roll(f, 3, -2),
                             torch.roll(f, 1, -2))
            yu = torch.where(jgf == shard.ny_g - 2, torch.roll(f, -3, -2),
                             torch.roll(f, -1, -2))
        else:
            yd, yu = sy_m_periodic_interior(f), sy_p_periodic_interior(f)
        if not three_d:
            return yd, yu, None, None
        zb, zf = torch.roll(f, 1, -3), torch.roll(f, -1, -3)
        if pins is not None:
            zb = torch.where(kgf == 1, pins[q], zb)
            zf = torch.where(kgf == shard.nz_g - 2, pins[4 + q], zf)
        return yd, yu, zb, zf

    def interior(device):
        inner = torch.zeros((c.nz, c.ny, c.nx), dtype=torch.bool,
                            device=device)
        zs, ys = shard.window(c)
        inner[zs, ys] = ~shard.faces(c, device)
        inner[..., 0] = inner[..., -1] = False
        if not shard.rows:
            inner[:, 0] = inner[:, -1] = False
        return inner

    return neighbours, interior


def rk_stage_shard_plain(state, q0, rho, T, acc, sy, sx, scal,
                         c: ExplicitConsts, final: bool, shard: ShardBlock,
                         pins=None):
    """One stage on a shard's block in plain PyTorch (the reference's
    ``make_rk_stage(global_nz=, global_ny=)``, `rk_kernels.py:61-125`,
    and ``make_rk2d_stage(global_ny=)``, `rk2d.py:56-91`): every input
    the block of ``c``'s dims, ``pins`` as :func:`shard_neighbours`'
    (None on a shard that holds neither global plane 1 nor nz_g − 2).
    A mid stage returns ``(fields, None)``, fields the (8, …) block-shaped
    stack of (next, acc′), of which the owned window is the stage's (the
    wrapper fills the halos); the final stage ``(fields, maxima)``,
    fields the (6, …) stack of the owned window of the finished state:
    off the rewritten global faces the single-device stage's value on
    the block (its x wrap, and on a whole-row block its y wrap, are the
    block's own), on them k = 0 at the point itself, ρ and T passed
    through; maxima the (4,) stack of its maxima off those faces."""
    nb, interior = shard_neighbours(c, shard, pins)
    ks = momentum_rhs_plain(*state, rho, sy, sx, scal[3], scal[4], c, T, nb,
                            interior(state[0].device))
    factor, acc_mix, weight = scal[0], scal[1], scal[2]
    accs = (0.0,) * 4 if acc is None else acc
    nxt = [q + factor * (acc_mix * a + k) for q, a, k in zip(q0, accs, ks)]
    nxt[:3] = [clamp(f, MAX_VELOCITY_LIMIT) for f in nxt[:3]]
    if not final:
        return torch.stack(
            [*nxt, *(a + weight * k for a, k in zip(accs, ks))]), None
    T_upd = (energy_update_plain(T, *nxt[:3], scal[5], c)
             if c.thermal.energy else T)
    wrapped = [apply_periodic_scalar(f) for f in (*nxt, rho)]
    wrapped.append(thermal_output(T_upd, c))
    win = shard.window(c)
    face = shard.faces(c, T.device)
    outs = [torch.where(face, a[win], b[win])
            for a, b in zip((*nxt, rho, T), wrapped)]
    return torch.stack(outs), torch.stack(maxima_off(*outs[:4], outs[5],
                                                     face))


def launch_rk_shard(state, q0, rho, T, acc, sy, sx, scal, c: ExplicitConsts,
                    final: bool, shard: ShardBlock, pins):
    """One ``cfd_rk_stage_shard`` launch; returns ``(fields, maxima)`` as
    :func:`rk_stage_shard_plain` (a mid stage's halos unwritten)."""
    check_inputs(c, (*state, *q0, rho, T, *(acc or ())), sy, sx, scal)
    if pins is not None:
        native.check_cuda(pins)
        if tuple(pins.shape) != (8, c.ny, c.nx):
            raise ValueError("the pins must be (8, ny, nx) block planes")
    if final and c.thermal.energy and scal.numel() < 6:
        raise ValueError("the final stage's energy update reads dt, "
                         "scal[5]")
    nzl, nyl = shard.owned(c)
    u = state[0]
    shape = (nzl, nyl, c.nx) if final else tuple(u.shape)
    fields = torch.empty((6 if final else 8, *shape), dtype=u.dtype,
                         device=u.device)
    partials, red = (maxima_buffers(c, u, (nzl, nyl)) if final
                     else (None, None))
    ins = _ptrs((*state, *q0, rho, T, *(acc or (None,) * 4), sy, sx, scal,
                 pins))
    out_arr = _ptrs((*fields.unbind(), *(None,) * (8 - len(fields))))
    native.launch("cfd_rk_stage_shard", u.device, ins, out_arr,
                  None if partials is None else native.ptr(partials),
                  None if red is None else native.ptr(red),
                  nzl, nyl, c.nx, *c.kernel_args()[3:], int(final),
                  *c.thermal.kernel_args(), *c.kernel_spacing(),
                  *shard.args())
    return fields, red


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(
        None if t is None else native.ptr(t) for t in ts))


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

    ins = _ptrs((*state, *q0, rho, T, *(acc or (None,) * 4), sy, sx, scal))
    out_arr = _ptrs((*outs, *(None,) * (8 - len(outs))))
    native.launch("cfd_rk_stage", u.device, ins, out_arr,
                  None if partials is None else native.ptr(partials),
                  None if red is None else native.ptr(red),
                  *c.kernel_args(), int(final), *c.thermal.kernel_args(),
                  *c.kernel_spacing())
    if not final:
        return tuple(outs)
    return (*outs, red[0], red[1], red[2], red[3])


def rk_stage(state, q0, rho, T, acc, sy, sx, scal, c: ExplicitConsts,
             final: bool, shard: ShardBlock = None, pins=None):
    """RK3, one 3D stage — ``rk_kernel<true, final, *>`` on CUDA.  With
    ``shard`` a z-decomposed shard's block: ``global_nz`` (whole rows,
    ``rk_shard_kernel<true, *, *, *, kZ>``, counted on
    ``global_nz_launches``) or, with ``shard.rows``, ``global_nz`` +
    ``global_ny`` (``kRows``, on ``global_ny_launches``), which returns
    ``(fields, maxima)`` (:func:`rk_stage_shard_plain`)."""
    if shard is not None:
        return _shard_stage(rk_stage, state, q0, rho, T, acc, sy, sx, scal,
                            c, final, shard, pins)
    if native.on_cpu(state[0]):
        return rk_stage_plain(state, q0, rho, T, acc, sy, sx, scal, c, final)
    if c.nz < 3:
        raise ValueError("rk_stage is the 3D kernel (nz >= 3)")
    out = launch_rk(state, q0, rho, T, acc, sy, sx, scal, c, final)
    native.count_launch(rk_stage, c.scheme)
    return out


def _shard_stage(wrapper, state, q0, rho, T, acc, sy, sx, scal, c, final,
                 shard, pins):
    """A stage wrapper's sharded mode: the plain version on the CPU, else
    the launch, counted on ``global_ny_launches`` (a global-row block) or
    ``global_nz_launches``."""
    if native.on_cpu(state[0]):
        return rk_stage_shard_plain(state, q0, rho, T, acc, sy, sx, scal, c,
                                    final, shard, pins)
    if (c.nz > 1) != (shard.nz_g > 1) or (c.nz == 1 and not shard.rows):
        raise ValueError("a shard block's dims and its mode disagree")
    out = launch_rk_shard(state, q0, rho, T, acc, sy, sx, scal, c, final,
                          shard, pins)
    native.count_launch(wrapper, "global_ny" if shard.rows else "global_nz")
    return out


native.reset_counts(rk_stage)
