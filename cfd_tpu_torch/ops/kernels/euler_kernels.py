"""The explicit Euler step's fused kernel (counterpart of
`cfd_tpu/ops/pallas/euler_kernels.py`, E3 ``make_euler_fused``).

Single device, the built-in decaying sources, with or without Boussinesq
buoyancy and the energy equation with its thermal faces
(``ExplicitConsts.thermal``), on a uniform grid or a stretched x/y grid
(``ExplicitConsts.spacing``: the parity scheme's per-point forward
spacings or the consistent scheme's exact nonuniform weights, as per-axis
weight rows, `ops.kernels.stretch`; parity has no energy equation there,
as in the reference, `euler_kernels.py:110-113`).  The TPU kernel (one streaming pass
on the rolling engine, compute `euler_kernels.py:240-351`) becomes one
CUDA kernel plus a one-block reduction, ``cfd_euler_step`` in
``cfd_tpu_torch/csrc/euler_kernels.cu``: one thread per point, each
thread evaluating the update at its own periodic-wrap source so the p/ρ/T
faces need no second pass; a thermal face thread evaluates it also at the
point its T comes from (a Neumann face's neighbour).  The 2D form
(`euler2d.py`) is the same kernel's nz == 1 instantiation.

The global-row mode of a decomposed shard's block (E3's and E2's
``global_ny``, `euler_kernels.py:78-86`, `:108-118` of the reference;
`parallel.fused_explicit`) is ``euler_rows_kernel`` through
``cfd_euler_step_rows``: ``euler_step(..., shard=ShardBlock(...))`` on
the halo-padded block, one thread an owned point, owned-size outputs,
the global faces the step wrapper rewrites passed through, counted on
``global_ny_launches``; :func:`euler_step_rows_plain` is its plain
version.  Both return ``(fields, maxima)``: the six owned fields as the
rows of one (6, nzl, nyl, nx) tensor and the four maxima as one (4,).

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

import ctypes
import dataclasses

import numpy as np
import torch

from ...boundary.apply import apply_periodic_scalar
from ...boundary.types import ThermalBCConfig
from ...solvers.energy import apply_thermal_bcs, buoyancy_coefficients
from ...solvers.ns.common import clamp
from ...solvers.ns.params import (MAX_DERIVATIVE_LIMIT, MAX_DIVERGENCE_LIMIT,
                                  MAX_SECOND_DERIVATIVE_LIMIT,
                                  MAX_VELOCITY_LIMIT, UPDATE_LIMIT,
                                  param_value)
from ..stencils import (d2dz2, interior_mask, laplacian_chain, sx_m, sx_p,
                        sy_m, sy_p, sz_m, sz_p, weighted)
from . import native
from .stretch import stretch_pins, stretch_pins_consistent


@dataclasses.dataclass(frozen=True)
class ThermalConsts:
    """The energy equation and buoyancy of the explicit kernels: ``alpha``
    (> 0 turns the energy update and the thermal ``faces`` on),
    ``buoyancy`` = (((−β)·g[c] for c = x, y, z), T_ref) exact in the
    field's dtype, or None.  The explicit kernels add the buoyant term to
    all three components, as the reference's do
    (`euler_kernels.py:286-290`)."""

    alpha: float = 0.0
    buoyancy: tuple = None
    faces: ThermalBCConfig = ThermalBCConfig()

    @property
    def energy(self) -> bool:
        return torch.is_tensor(self.alpha) or self.alpha > 0.0

    @classmethod
    def from_params(cls, params, dtype) -> "ThermalConsts":
        """From an NSParams: α when the energy equation is on, the
        buoyancy coefficients rounded to ``dtype`` when β ≠ 0 (a tensor α
        or β stays a tensor for the plain versions, `params.param_value`)."""
        buoy = None
        if params.buoyancy_enabled:
            buoy = buoyancy_coefficients(params.beta, params.gravity,
                                         params.T_ref, dtype)
        return cls(param_value(params.alpha) if params.energy_enabled
                   else 0.0, buoy, params.thermal_bc)

    def kernel_args(self):
        """The C entry points' two host arrays (explicit_common.cuh:
        thermal_from): α, (−β)·g, T_ref and the Dirichlet values; the
        energy and buoyancy switches and the face types (BCType
        values)."""
        coefs, tref = self.buoyancy or ((0.0, 0.0, 0.0), 0.0)
        f = self.faces
        v = f.dirichlet_values
        floats = (ctypes.c_float * 11)(*map(float, (
            self.alpha, *coefs, tref, v.left, v.right, v.bottom, v.top,
            v.back, v.front)))
        ints = (ctypes.c_int * 8)(
            int(self.energy), int(self.buoyancy is not None),
            *(int(b) for b in (f.left, f.right, f.bottom, f.top, f.back,
                               f.front)))
        return floats, ints


SPACING_KINDS = {None: 0, "parity": 1, "consistent": 2}  # = kS


@dataclasses.dataclass(frozen=True)
class Spacing:
    """A stretched grid's weights for the explicit kernels: ``scheme``
    "parity" (x rows [1/(2dx), 1/dx², sin 2πx], y rows likewise,
    `stretch.stretch_pins`) or "consistent" (rows [wm, wc, wp, lm, lc, lp,
    src], `stretch.stretch_pins_consistent`), the rows as tensors on the
    fields' device; the kernels do not read the source rows (their
    ``sy``/``sx`` inputs hold the same values)."""

    scheme: str
    xw: torch.Tensor
    yw: torch.Tensor

    @classmethod
    def of(cls, stretch, scheme, dtype, device) -> "Spacing":
        """From the ``(dx, dy, x, y)`` numpy tuple of
        `solvers.ns.common.stretch_gate`."""
        np_dt = np.float64 if dtype == torch.float64 else np.float32
        mk = (stretch_pins_consistent if scheme == "consistent"
              else stretch_pins)
        xw, yw = mk(*stretch, np_dt)
        return cls(scheme, torch.as_tensor(xw, device=device),
                   torch.as_tensor(yw, device=device))


@dataclasses.dataclass(frozen=True)
class ExplicitConsts:
    """Constants of one grid for the explicit kernels (the
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
    thermal: ThermalConsts = ThermalConsts()
    # a stretched x/y grid's weights; None on a uniform grid
    spacing: Spacing = dataclasses.field(default=None, compare=False)

    @property
    def consistent(self) -> bool:
        return self.spacing is not None and self.spacing.scheme == "consistent"

    @property
    def scheme(self):
        """The launch counter's scheme (`native.count_launch`): None on a
        uniform grid, else the spacing's."""
        return None if self.spacing is None else self.spacing.scheme

    def xy_operators(self):
        """(d1x, d1y, d2x, d2y) of the shifted views ``(f_minus,
        f_center, f_plus)`` in the kernels' order: (fp − fm)·c and
        ((fp − 2fc) + fm)·c with scalar coefficients on a uniform grid
        and per-point ones on the parity scheme; (fm·wm + fc·wc) + fp·wp
        on the consistent scheme (`stretch.weighted`)."""
        i2x, i2y, _, ix2, iy2, _ = self.derivs()
        sp = self.spacing
        if sp is not None:
            X = [r.reshape(1, 1, -1) for r in sp.xw]
            Y = [r.reshape(1, -1, 1) for r in sp.yw]
        if sp is not None and sp.scheme == "consistent":
            def lin(w):
                return lambda fm, fc, fp: weighted(fm, fc, fp, w)

            return lin(X[:3]), lin(Y[:3]), lin(X[3:6]), lin(Y[3:6])
        if sp is not None:
            i2x, ix2, i2y, iy2 = X[0], X[1], Y[0], Y[1]

        def first(c):
            return lambda fm, fc, fp: (fp - fm) * c

        def second(c):
            return lambda fm, fc, fp: ((fp - 2.0 * fc) + fm) * c

        return first(i2x), first(i2y), second(ix2), second(iy2)

    def kernel_spacing(self):
        """The C entry points' trailing (xw, yw, spacing kind)."""
        sp = self.spacing
        if sp is None:
            return None, None, 0
        return native.ptr(sp.xw), native.ptr(sp.yw), SPACING_KINDS[sp.scheme]

    def derivs(self):
        """(1/2dx, 1/2dy, 1/2dz, 1/dx², 1/dy², 1/dz²)."""
        z = self.nz > 1
        return (1.0 / (2.0 * self.dx), 1.0 / (2.0 * self.dy),
                1.0 / (2.0 * self.dz) if z else 0.0,
                1.0 / (self.dx * self.dx), 1.0 / (self.dy * self.dy),
                1.0 / (self.dz * self.dz) if z else 0.0)

    def kernel_args(self):
        """The trailing scalar arguments of the C entry points."""
        return (self.nz, self.ny, self.nx, float(self.mu),
                float(self.pressure_coupling), *self.derivs())


@dataclasses.dataclass(frozen=True)
class ShardBlock:
    """A decomposed shard's block, the sharded modes' geometry
    (``csrc/explicit_common.cuh``: ``Shard``): the input fields hold
    ``hz`` planes and ``hy`` rows of halo a side around the owned window,
    whose plane 0 and row 0 are the global plane ``z_base`` of an
    ``nz_g``-plane grid (1 on a 2D grid) and the global row ``y_base``
    of an ``ny_g``-row one.  ``rows``: the y-face rows are the wrapper's
    (the global-row modes) — else only the z-shell planes are."""

    hz: int
    hy: int
    z_base: int
    nz_g: int
    y_base: int
    ny_g: int
    rows: bool = True

    def owned(self, c: ExplicitConsts):
        """(nzl, nyl): the owned window of a block of ``c``'s dims."""
        return c.nz - 2 * self.hz, c.ny - 2 * self.hy

    def window(self, c: ExplicitConsts):
        nzl, nyl = self.owned(c)
        return (slice(self.hz, self.hz + nzl), slice(self.hy, self.hy + nyl))

    def faces(self, c: ExplicitConsts, device) -> torch.Tensor:
        """(nzl, nyl, 1) bool: the owned points on a global face the
        wrapper rewrites (z-shell planes; y-face rows when ``rows``)."""
        nzl, nyl = self.owned(c)
        out = torch.zeros((nzl, nyl, 1), dtype=torch.bool, device=device)
        if self.nz_g > 1:
            kg = self.z_base + torch.arange(nzl, device=device)
            out |= ((kg < 1) | (kg > self.nz_g - 2))[:, None, None]
        if self.rows:
            jg = self.y_base + torch.arange(nyl, device=device)
            out |= ((jg < 1) | (jg > self.ny_g - 2))[None, :, None]
        return out

    def args(self):
        return (self.hz, self.hy, self.z_base, self.nz_g, self.y_base,
                self.ny_g)


def check_inputs(c: ExplicitConsts, fields, sy, sx, scal):
    """(nz, ny, nx) float32 fields, the (ny,) and (nx,) source vectors and
    the scalars, contiguous on one CUDA device."""
    native.check_cuda(*fields, sy, sx, scal)
    if c.spacing is not None:
        native.check_cuda(c.spacing.xw, c.spacing.yw)
        if (c.spacing.xw.shape[-1], c.spacing.yw.shape[-1]) != (c.nx, c.ny):
            raise ValueError("the spacing rows must be (·, nx) and (·, ny)")
    for f in fields:
        if tuple(f.shape) != (c.nz, c.ny, c.nx):
            raise ValueError(f"expected fields of shape "
                             f"{(c.nz, c.ny, c.nx)}, got {tuple(f.shape)}")
    if tuple(sy.shape) != (c.ny,) or tuple(sx.shape) != (c.nx,):
        raise ValueError("source vectors must be (ny,) and (nx,)")


def maxima_buffers(c: ExplicitConsts, like: torch.Tensor, dims=None):
    """Per-block partials and the four maxima the kernels write over
    ``dims`` (nz, ny) (default ``c``'s; a shard's owned window)."""
    nz, ny = dims or (c.nz, c.ny)
    n_part = native.library().cfd_explicit_partials(nz, ny, c.nx)
    return (torch.empty(4 * n_part, dtype=like.dtype, device=like.device),
            torch.empty(4, dtype=like.dtype, device=like.device))


def viscosity(mu, rho: torch.Tensor) -> torch.Tensor:
    """ν = min(μ / max(ρ, 1e-10), 1), a true division (``scalar / tensor``
    would multiply by a reciprocal); a tensor μ keeps its gradient."""
    mu_t = (mu.to(rho.dtype) if torch.is_tensor(mu) else
            torch.full((), mu, dtype=rho.dtype, device=rho.device))
    return torch.clamp_max(mu_t / torch.clamp_min(rho, 1e-10), 1.0)


def maxima(u, v, w, p, T):
    """(max|u|², max p, max|p|, max T) over the whole field."""
    m2 = torch.amax((u * u + v * v) + w * w)
    return m2, torch.amax(p), torch.amax(torch.abs(p)), torch.amax(T)


def maxima_off(u, v, w, p, T, skip, skip_u=None):
    """:func:`maxima` over the points where ``skip`` is False (those of
    |u|² where ``skip_u`` is, when given)."""
    def off(f, mask=skip):
        return torch.where(mask, -torch.inf, f)

    m2 = torch.amax(off((u * u + v * v) + w * w,
                        skip if skip_u is None else skip_u))
    return m2, torch.amax(off(p)), torch.amax(off(torch.abs(p))), \
        torch.amax(off(T))


def buoyant_sources(su, sv, T, c: ExplicitConsts):
    """(su, sv, sw) with the buoyant terms b[c]·(T − T_ref) added
    (`euler_kernels.py:286-290`); sw None without buoyancy."""
    if c.thermal.buoyancy is None:
        return su, sv, None
    (b0, b1, b2), tref = c.thermal.buoyancy
    dT = T - tref
    return su + b0 * dT, sv + b1 * dT, b2 * dT


def energy_update_plain(T, uo, vo, wo, cdt, c: ExplicitConsts):
    """T + cdt·(−(u·T_x + v·T_y + w·T_z) + α∇²T) on the interior with the
    updated velocities, T on the shell; unclamped, in the kernels' order
    (no z terms on a one-plane field): central differences on a uniform
    grid; on the consistent scheme T_x = (T[i−1]·wm + T·wc) + T[i+1]·wp
    and ∇²T one chain of the six x/y terms (`euler_kernels.py:319-326`)."""
    i2x, i2y, i2z, ix2, iy2, iz2 = c.derivs()
    xp, xm, yp, ym = sx_p(T), sx_m(T), sy_p(T), sy_m(T)
    t2 = 2.0 * T
    if c.consistent:
        X = [r.reshape(1, 1, -1) for r in c.spacing.xw]
        Y = [r.reshape(1, -1, 1) for r in c.spacing.yw]
        lap = laplacian_chain(xm, T, xp, ym, yp, X[3:6], Y[3:6])
        adv = (uo * weighted(xm, T, xp, X[:3])
               + vo * weighted(ym, T, yp, Y[:3]))
    else:
        lap = ((xp - t2) + xm) * ix2 + ((yp - t2) + ym) * iy2
        adv = uo * ((xp - xm) * i2x) + vo * ((yp - ym) * i2y)
    if c.nz > 1:
        zp, zm = sz_p(T), sz_m(T)
        lap = lap + ((zp - t2) + zm) * iz2
        adv = adv + wo * ((zp - zm) * i2z)
    inner = interior_mask(T.shape, torch.bool, T.device)
    return torch.where(inner, T + cdt * (-adv + c.thermal.alpha * lap), T)


def thermal_output(T_upd, c: ExplicitConsts):
    """The new T: the periodic wrap of the updated T, then, with the
    energy equation on, the thermal faces (`euler.py:201-211`)."""
    out = apply_periodic_scalar(T_upd)
    if c.thermal.energy:
        out = apply_thermal_bcs(out, c.thermal.faces)
    return out


def euler_step_plain(u, v, w, p, T, rho, sy, sx, scal, c: ExplicitConsts):
    """The Euler step in plain PyTorch: the reference's jnp body
    (`cfd_tpu/solvers/ns/euler.py:119-221`) in the kernel's operation
    order.  ``scal`` = [cdt, su, sv] (the decayed source amplitudes);
    ``sy`` = sin(πy), ``sx`` = sin(2πx).  Velocity shells pass through
    (the wrap-then-restore of the reference's boundary dance); p, ρ and T
    take the periodic wrap of the updated field, T after the energy update
    and before the thermal faces when ``c.thermal`` has them.  Also the
    plain version of the 2D kernel: on a one-plane field every z term is
    dropped."""
    cdt, su_eff, sv_eff = scal[0], scal[1], scal[2]
    _, _, i2z, _, _, iz2 = c.derivs()
    three_d = c.nz > 1
    dx1, dy1, dx2, dy2 = c.xy_operators()

    def d1(a):
        return clamp(a, MAX_DERIVATIVE_LIMIT)

    def d2(a):
        return clamp(a, MAX_SECOND_DERIVATIVE_LIMIT)

    def grads(f):
        return (d1(dx1(sx_m(f), f, sx_p(f))), d1(dy1(sy_m(f), f, sy_p(f))),
                d1((sz_p(f) - sz_m(f)) * i2z) if three_d else None)

    def lap(f):
        out = (d2(dx2(sx_m(f), f, sx_p(f))) + d2(dy2(sy_m(f), f, sy_p(f))))
        return out + d2(d2dz2(f, iz2)) if three_d else out

    du_dx, du_dy, du_dz = grads(u)
    dv_dx, dv_dy, dv_dz = grads(v)
    dw_dx, dw_dy, dw_dz = grads(w)
    dp_dx, dp_dy, dp_dz = grads(p)
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
    du = cdt * (((tu - dp_dx / rho) + nu * lap(u)) + su)
    dv = cdt * (((tv - dp_dy / rho) + nu * lap(v)) + sv)
    rw = tw + nu * lap(w)
    dw = cdt * (rw if sw is None else rw + sw)

    upd = (interior_mask(u.shape, torch.bool, u.device)
           & (rho > 1e-10))     # interior, per-point ρ guard (NaN too)

    def vel(f, df):
        return torch.where(upd, clamp(f + clamp(df, UPDATE_LIMIT),
                                      MAX_VELOCITY_LIMIT), f)

    dp = clamp(((-c.pressure_coupling * cdt) * rho)
               * clamp(div, MAX_DIVERGENCE_LIMIT), UPDATE_LIMIT)
    uo, vo, wo = vel(u, du), vel(v, dv), vel(w, dw)
    po = apply_periodic_scalar(torch.where(upd, p + dp, p))
    T_upd = (energy_update_plain(T, uo, vo, wo, cdt, c) if c.thermal.energy
             else T)
    To = thermal_output(T_upd, c)
    return (uo, vo, wo, po, apply_periodic_scalar(rho), To,
            *maxima(uo, vo, wo, po, To))


def euler_step_rows_plain(u, v, w, p, T, rho, sy, sx, scal,
                          c: ExplicitConsts, shard: ShardBlock):
    """The global-row mode (E3's and E2's ``global_ny``, the reference's
    `euler_kernels.py:78-86`, `euler2d.py:46-76`) in plain PyTorch: the
    fields are a shard's block of ``c``'s dims (``sy`` and the spacing's
    y rows its rows of the global ones), the outputs its owned window.
    An owned point off the global faces the wrapper rewrites is an
    interior point of the block, so it takes :func:`euler_step_plain`'s
    value on the block; a face point passes through.  The maxima: |u|²
    over every owned point (the velocities passed through are the
    step's), p and T off the faces (the wrapper's wrapped faces hold
    copies of values off them).  Returns ``(fields, maxima)``, the
    stacks of the six owned fields and of the four maxima."""
    full = euler_step_plain(u, v, w, p, T, rho, sy, sx, scal, c)
    win = shard.window(c)
    face = shard.faces(c, u.device)
    outs = [torch.where(face, a[win], b[win])
            for a, b in zip((u, v, w, p, rho, T), full[:6])]
    return torch.stack(outs), torch.stack(maxima_off(
        *outs[:4], outs[5], face, torch.zeros_like(face)))


def launch_euler_rows(c: ExplicitConsts, shard: ShardBlock, u, v, w, p, T,
                      rho, sy, sx, scal):
    """One ``cfd_euler_step_rows`` launch; returns ``(fields, maxima)``
    as :func:`euler_step_rows_plain`."""
    check_inputs(c, (u, v, w, p, T, rho), sy, sx, scal)
    nzl, nyl = shard.owned(c)
    fields = torch.empty((6, nzl, nyl, c.nx), dtype=u.dtype,
                         device=u.device)
    partials, red = maxima_buffers(c, u, (nzl, nyl))
    native.launch("cfd_euler_step_rows", u.device, *map(native.ptr, (
        u, v, w, p, T, rho, sy, sx, scal, *fields.unbind(), partials,
        red)),
        nzl, nyl, c.nx, *c.kernel_args()[3:], *c.thermal.kernel_args(),
        *c.kernel_spacing(), *shard.args())
    return fields, red


def launch_euler(c: ExplicitConsts, u, v, w, p, T, rho, sy, sx, scal):
    """One ``cfd_euler_step`` launch (the 3D or the 2D instantiation, by
    ``c.nz``); returns the outputs in :func:`euler_step_plain`'s order."""
    check_inputs(c, (u, v, w, p, T, rho), sy, sx, scal)
    outs = [torch.empty_like(u) for _ in range(6)]
    partials, red = maxima_buffers(c, u)
    native.launch("cfd_euler_step", u.device, *map(native.ptr, (
        u, v, w, p, T, rho, sy, sx, scal, *outs, partials, red)),
        *c.kernel_args(), *c.thermal.kernel_args(), *c.kernel_spacing())
    return (*outs, red[0], red[1], red[2], red[3])


def euler_step(u, v, w, p, T, rho, sy, sx, scal, c: ExplicitConsts,
               shard: ShardBlock = None):
    """E3, the whole 3D Euler step — ``euler_kernel<true, *, kS>`` on
    CUDA, counted by spacing kind (`native.count_launch`).  With
    ``shard`` (a z- or (z, y)-decomposed shard's block) its global-row
    mode, ``euler_rows_kernel<true, *, kS>``, counted on
    ``global_ny_launches``, which returns ``(fields, maxima)``
    (:func:`euler_step_rows_plain`)."""
    if shard is not None:
        return _rows(euler_step, u, v, w, p, T, rho, sy, sx, scal, c, shard)
    if native.on_cpu(u):
        return euler_step_plain(u, v, w, p, T, rho, sy, sx, scal, c)
    if c.nz < 3:
        raise ValueError("euler_step is the 3D kernel (nz >= 3)")
    out = launch_euler(c, u, v, w, p, T, rho, sy, sx, scal)
    native.count_launch(euler_step, c.scheme)
    return out


def _rows(wrapper, u, v, w, p, T, rho, sy, sx, scal, c, shard):
    """A wrapper's global-row mode: the plain version on the CPU, else
    the launch, counted on ``global_ny_launches``."""
    if native.on_cpu(u):
        return euler_step_rows_plain(u, v, w, p, T, rho, sy, sx, scal, c,
                                     shard)
    if (c.nz > 1) != (shard.nz_g > 1):
        raise ValueError("a shard block's dims and its nz_g disagree")
    out = launch_euler_rows(c, shard, u, v, w, p, T, rho, sy, sx, scal)
    native.count_launch(wrapper, "global_ny")
    return out


native.reset_counts(euler_step)
