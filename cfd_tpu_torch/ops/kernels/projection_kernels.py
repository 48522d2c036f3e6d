"""The projection step's two mega kernels (counterpart of
`cfd_tpu/ops/pallas/projection_kernels.py`).

Only the configuration the main path runs is ported: single device,
uniform grid, DST-fused with the Thomas forward sweep in the predictor and
the stored-t reverse-march corrector (``dst_mats`` + ``tdma_fwd``,
``tdma_bwd="stored"``, nz ≥ 4, no buoyancy).  The reference's two TPU
kernels become two chains of CUDA kernels that meet in device memory:

* **A1** ``ProjectionKernels.pred_bt`` (`projection_kernels.py:572-722`)
  → :meth:`ProjectionKernels.predictor_poisson_input`:
  :func:`predictor_star` → :func:`poisson_input` → `rolling.plane_dot`
  (forward xy DST) → `tdma.tdma_z_fwd`.  Returns (u*, v*, w*, d′, t).
* **A2** ``ProjectionKernels.corr_bwd`` (`projection_kernels.py:381-452`)
  → :meth:`ProjectionKernels.corrector_bwd_diag`:
  `tdma.tdma_z_bwd` → `rolling.plane_dot` (inverse xy DST) →
  :func:`corrector`.  Returns (u, v, w, p, max|u|², max p, max|p|), the
  maxima over planes 1..nz−2 (the step folds in the two z-shell planes).

Every wrapper below launches its CUDA kernel on a CUDA tensor and runs its
plain PyTorch version (``*_plain``) on a CPU tensor; its ``launches``
attribute counts kernel launches.  The CUDA sources are in
``cfd_tpu_torch/csrc/projection_kernels.cu``.

Kernel notes (what bounds each on an H100, and what the design does):

* ``pred_star_kernel`` / ``poisson_input_kernel`` / ``corrector_kernel`` —
  stencils at a few flops per byte, bound by device-memory bandwidth.  One
  thread per point with neighbours from L1/L2; the predictor writes u*,
  v*, w* once and the b̃ kernel re-reads them instead of recomputing w* at
  k±1 as the TPU kernel did, trading one extra read of three fields for a
  kernel with no cross-plane state.  Only interior points read
  neighbours, so the ±2-plane window never touches planes −1 or nz.
* ``corrector_kernel`` + ``reduce_max3_kernel`` — a two-pass max
  reduction whose combine keeps NaN, and a clamp written as selects that
  keeps NaN, so a NaN anywhere still makes the step report DIVERGED.
"""

from __future__ import annotations

import dataclasses

import torch

from ...solvers.ns.common import clamp
from ...solvers.ns.params import PROJ_MAX_VELOCITY as CLAMP  # = kClamp
from ..stencils import ddx, ddy, ddz, interior, laplacian, set_interior
from . import native
from .rolling import plane_dot, plane_dot_plain
from .tdma import (tdma_z_bwd, tdma_z_bwd_reference, tdma_z_fwd,
                   tdma_z_fwd_reference)


@dataclasses.dataclass(frozen=True)
class StencilConsts:
    """Compile-time constants of one uniform grid (the reference bakes the
    same Python floats into its kernels; the CUDA kernels take them as
    float32 arguments).  On a 2D grid (nz == 1) the z constants are 0."""

    nz: int
    ny: int
    nx: int
    dx: float
    dy: float
    dz: float
    xmin: float
    ymin: float
    nu: float
    with_sources: bool = True

    @property
    def inv_2dx(self):
        return 1.0 / (2.0 * self.dx)

    @property
    def inv_2dy(self):
        return 1.0 / (2.0 * self.dy)

    @property
    def inv_2dz(self):
        return 1.0 / (2.0 * self.dz) if self.nz > 1 else 0.0

    @property
    def inv_dx2(self):
        return 1.0 / (self.dx * self.dx)

    @property
    def inv_dy2(self):
        return 1.0 / (self.dy * self.dy)

    @property
    def inv_dz2(self):
        return 1.0 / (self.dz * self.dz) if self.nz > 1 else 0.0

    def derivs(self):
        return (self.inv_2dx, self.inv_2dy, self.inv_2dz,
                self.inv_dx2, self.inv_dy2, self.inv_dz2)


def _check(c: StencilConsts, fields, scalars):
    """(nz, ny, nx) float32 fields and float32 scalars on one CUDA device."""
    native.check_cuda(*fields, *scalars)
    for f in fields:
        if tuple(f.shape) != (c.nz, c.ny, c.nx):
            raise ValueError(f"expected fields of shape "
                             f"{(c.nz, c.ny, c.nx)}, got {tuple(f.shape)}")


# ---- A1 (a): predictor u*, v*, w* ----------------------------------------

def predictor_star_plain(u, v, w, scal, c: StencilConsts):
    """u* = clamp(u + dt(−u·∇u + ν∇²u + src)) on the interior, shells
    passed through; ``scal`` = [dt, su, sv] (source amplitudes with the
    decay folded in).  Also the plain version of the 2D predictor: on a
    one-plane field the z terms vanish (the reference's inv_dz2 = 0
    idiom), leaving its 2D operation order."""
    dt, su, sv = scal[0], scal[1], scal[2]
    i2x, i2y, i2z, ix2, iy2, iz2 = c.derivs()
    uc, vc, wc = interior(u), interior(v), interior(w)

    def star(f, src):
        conv = (uc * ddx(f, i2x) + vc * ddy(f, i2y)) + wc * ddz(f, i2z)
        s = interior(f) + dt * ((-conv + c.nu * laplacian(f, ix2, iy2, iz2))
                                + src)
        return set_interior(f, clamp(s, CLAMP))

    if c.with_sources:
        jj = torch.arange(1, c.ny - 1, device=u.device).to(u.dtype)
        ii = torch.arange(1, c.nx - 1, device=u.device).to(u.dtype)
        src_u = su * torch.sin(torch.pi * (c.ymin + jj * c.dy))[:, None]
        src_v = sv * torch.sin(2.0 * torch.pi * (c.xmin + ii * c.dx))[None]
    else:
        src_u = src_v = 0.0
    return star(u, src_u), star(v, src_v), star(w, 0.0)


def predictor_star(u, v, w, scal, c: StencilConsts):
    """(u*, v*, w*) — ``pred_star_kernel`` on CUDA."""
    if native.on_cpu(u):
        return predictor_star_plain(u, v, w, scal, c)
    _check(c, (u, v, w), (scal,))
    us, vs, ws = (torch.empty_like(u) for _ in range(3))
    native.launch("cfd_pred_star", u.device, *map(native.ptr, (
        u, v, w, us, vs, ws, scal)), c.nz, c.ny, c.nx, c.nu, *c.derivs(),
        c.xmin, c.ymin, c.dx, c.dy, int(c.with_sources))
    predictor_star.launches += 1
    return us, vs, ws


# ---- A1 (a'): spectral-solve input b̃ --------------------------------------

def face_coeff(c: StencilConsts, dtype, device):
    """(nz, ny, nx) Neumann-mirror face coefficients, in the reference
    kernel's summation order ((x + y) + z; the z term is 0 in 2D)."""
    def face(n, inv_d2):
        k = torch.arange(n, device=device)
        return inv_d2 * ((k == 1).to(dtype) + (k == n - 2).to(dtype))

    cxy = face(c.nx, c.inv_dx2)[None, :] + face(c.ny, c.inv_dy2)[:, None]
    return cxy[None] + face(c.nz, c.inv_dz2)[:, None, None]


def poisson_input_plain(us, vs, ws, p, rod, c: StencilConsts):
    """b̃ = face_coeff·p − (ρ/dt)∇·u* on the interior, zero shell."""
    i2x, i2y, i2z = c.inv_2dx, c.inv_2dy, c.inv_2dz
    div = (ddx(us, i2x) + ddy(vs, i2y)) + ddz(ws, i2z)
    coeff = interior(face_coeff(c, p.dtype, p.device))
    return set_interior(torch.zeros_like(p),
                        coeff * interior(p) - rod * div)


def poisson_input(us, vs, ws, p, rod, c: StencilConsts):
    """b̃ — ``poisson_input_kernel`` on CUDA; ``rod`` a 0-d tensor."""
    if native.on_cpu(us):
        return poisson_input_plain(us, vs, ws, p, rod, c)
    _check(c, (us, vs, ws, p), (rod,))
    bt = torch.empty_like(p)
    native.launch("cfd_poisson_input", p.device, *map(native.ptr, (
        us, vs, ws, p, bt, rod)), c.nz, c.ny, c.nx, *c.derivs())
    poisson_input.launches += 1
    return bt


# ---- A2 (e): corrector + diagnostics --------------------------------------

def corrector_plain(us, vs, ws, p, s, c: StencilConsts):
    """u = clamp(u* − s∇p) on the interior (shells from u*), with the
    maxima of |u|², p and |p| over planes 1..nz−2 (NaN propagates)."""
    u = set_interior(us, clamp(interior(us) - s * ddx(p, c.inv_2dx), CLAMP))
    v = set_interior(vs, clamp(interior(vs) - s * ddy(p, c.inv_2dy), CLAMP))
    dpz = p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]
    w = set_interior(ws, clamp(interior(ws) - (s * dpz) * c.inv_2dz, CLAMP))
    zi = slice(1, -1)
    m2 = torch.amax((u[zi] * u[zi] + v[zi] * v[zi]) + w[zi] * w[zi])
    return u, v, w, m2, torch.amax(p[zi]), torch.amax(torch.abs(p[zi]))


def corrector(us, vs, ws, p, s, c: StencilConsts):
    """(u, v, w, max|u|², max p, max|p|) — ``corrector_kernel`` plus the
    second-pass ``reduce_max3_kernel`` on CUDA; ``s`` = dt/ρ, 0-d."""
    if native.on_cpu(us):
        return corrector_plain(us, vs, ws, p, s, c)
    _check(c, (us, vs, ws, p), (s,))
    u, v, w = (torch.empty_like(us) for _ in range(3))
    n_part = native.library().cfd_corrector_partials(c.nz, c.ny, c.nx)
    partials = torch.empty(3 * n_part, dtype=us.dtype, device=us.device)
    red = torch.empty(3, dtype=us.dtype, device=us.device)
    native.launch("cfd_corrector", us.device, *map(native.ptr, (
        us, vs, ws, p, u, v, w, s, partials, red)), c.nz, c.ny, c.nx,
        c.inv_2dx, c.inv_2dy, c.inv_2dz)
    corrector.launches += 1
    return u, v, w, red[0], red[1], red[2]


predictor_star.launches = 0
poisson_input.launches = 0
corrector.launches = 0

# every wrapper that launches a kernel on the main path, for counters
WRAPPERS = (predictor_star, poisson_input, plane_dot, tdma_z_fwd,
            tdma_z_bwd, corrector)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


class ProjectionKernels:
    """The two mega kernels for one (uniform grid, dtype, device).

    ``dst_mats`` = (FxT, Fy, GxT, Gy) and ``tdma_fwd`` = (mu plane, w)
    from `solvers.poisson.spectral.make_dst_fused_pieces`.  The default
    runs the wrappers (kernels on CUDA, plain versions on CPU).
    ``plain=True`` is a reference switch for checks on the card only: it
    runs the plain PyTorch versions on a CUDA device too, so
    ``chip_smoke.py`` can hold the kernels against them and time both.
    """

    def __init__(self, nz, ny, nx, dx, dy, dz, xmin, ymin, nu,
                 dst_mats, tdma_fwd, with_sources=True, plain=False):
        if nz < 4:
            raise ValueError("the reverse-march corrector needs nz >= 4")
        self.consts = StencilConsts(nz, ny, nx, dx, dy, dz, xmin, ymin,
                                    float(nu), bool(with_sources))
        self.fxt, self.fy, self.gxt, self.gy = dst_mats
        self.mu, self.w = tdma_fwd
        if plain:
            self._star, self._bt, self._dot = (
                predictor_star_plain, poisson_input_plain, plane_dot_plain)
            self._fwd, self._bwd, self._corr = (
                tdma_z_fwd_reference, tdma_z_bwd_reference, corrector_plain)
        else:
            self._star, self._bt, self._dot = (
                predictor_star, poisson_input, plane_dot)
            self._fwd, self._bwd, self._corr = (
                tdma_z_fwd, tdma_z_bwd, corrector)

    def predictor_poisson_input(self, u, v, w, p, dt, su, sv, rho_over_dt):
        """A1: (u*, v*, w*, d′, t).  ``dt``, ``su``, ``sv`` and
        ``rho_over_dt`` are 0-d tensors on the field's device."""
        c = self.consts
        scal = torch.stack([dt, su, sv])
        us, vs, ws = self._star(u, v, w, scal, c)
        bt = self._bt(us, vs, ws, p, rho_over_dt, c)
        d, t = self._fwd(self._dot(bt, self.fxt, self.fy), self.mu, self.w)
        return us, vs, ws, d, t

    def corrector_bwd_diag(self, us, vs, ws, d, t, dt_over_rho):
        """A2: (u, v, w, p, max|u|², max p, max|p|) from the predictor's
        (d′, t); maxima over planes 1..nz−2."""
        xhat = self._bwd(d, t)
        p = self._dot(xhat, self.gxt, self.gy)
        u, v, w, m2, pmax, pabs = self._corr(us, vs, ws, p, dt_over_rho,
                                             self.consts)
        return u, v, w, p, m2, pmax, pabs
