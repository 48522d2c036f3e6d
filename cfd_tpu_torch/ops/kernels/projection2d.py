"""The 2D projection step's two fused kernels (counterpart of
`cfd_tpu/ops/pallas/projection2d.py`, the DST-fused single-device form).

Only the configuration the main path runs is ported: single device,
uniform grid, ``emit="btilde"`` with the x-DST pair (``dst_mats``), no
buoyancy, no split (``bc_refresh``) kernels.  The reference's two TPU
kernels on the block-marching engine (`marching2d.py`) become two chains
of CUDA kernels that meet in device memory:

* ``Projection2DKernels.pred_bt`` (`projection2d.py:200-216`)
  → :meth:`Projection2DKernels.predictor_and_poisson_input`:
  :func:`predictor_star_2d` → :func:`poisson_input_2d` →
  `rolling.right_dot` (b̃·FxT, the forward x-DST).  Returns
  (u*, v*, w*, b̃·FxT).
* ``Projection2DKernels.corr`` (`projection2d.py:252-282`)
  → :meth:`Projection2DKernels.corrector`: `rolling.right_dot`
  (p = x̂·GxT, the arrival hook's inverse x-DST) → :func:`corrector_2d`.
  Returns (u, v, p); w = w* at the caller (inv_dz2 = 0).

The y-line solve between them (`solvers.poisson.spectral.
make_dst2d_fused_pieces`) runs `tdma.tdma_y_2d` (the 3D z-line Thomas
kernels on one-row planes) and the rescue products.

The CG step (``emit="rhs"``) runs pred_bt's rhs form,
:func:`predictor_star_2d` → :func:`poisson_rhs_2d` ((ρ/dt)∇·u*, the b̃
kernel with its emit flag set), and the non-DST ``corr``
(:func:`corrector_2d` on a physical p).

Every wrapper below launches its CUDA kernel on a CUDA tensor and runs its
plain PyTorch version (``*_plain``) on a CPU tensor; its ``launches``
attribute counts kernel launches.  Fields are (1, ny, nx).  The CUDA
sources are in ``cfd_tpu_torch/csrc/projection2d_kernels.cu``.

Kernel notes (what bounds each on an H100, and what the design does):

* ``pred_star_2d_kernel`` / ``poisson_input_2d_kernel`` /
  ``corrector_2d_kernel`` — stencils at a few flops per byte, bound by
  device-memory bandwidth.  One thread per point with neighbours from
  L1/L2.  A two-kernel chain, as in 3D: the TPU kernel recomputed u*, v*
  on a two-row-extended window so the divergence needed no second pass;
  here b̃ re-reads u*, v* (two fields) instead of recomputing the
  predictor at four neighbours.  Only interior points read neighbours.
* The clamps are selects that keep NaN, so a NaN anywhere still makes
  the step report DIVERGED.
"""

from __future__ import annotations

import torch

from ...solvers.ns.common import clamp
from ...solvers.ns.params import PROJ_MAX_VELOCITY as CLAMP  # = kClamp
from ..stencils import ddx, ddy, interior, set_interior
from . import native
from .projection_kernels import StencilConsts, face_coeff, \
    predictor_star_plain
from .rolling import left_dot, right_dot, right_dot_plain
from .tdma import tdma_z_bwd, tdma_z_fwd


def _check(c: StencilConsts, fields, scalars):
    """(1, ny, nx) float32 fields and float32 scalars on one CUDA device."""
    native.check_cuda(*fields, *scalars)
    for f in fields:
        if tuple(f.shape) != (1, c.ny, c.nx):
            raise ValueError(f"expected fields of shape {(1, c.ny, c.nx)}, "
                             f"got {tuple(f.shape)}")


# ---- pred_bt (a): predictor u*, v*, w* ----------------------------------

def predictor_star_2d(u, v, w, scal, c: StencilConsts):
    """(u*, v*, w*) = clamp(f + dt(−(u∂x + v∂y)f + ν∇²f + src)) on the
    interior, shells passed through (w is predicted too, convected by u,
    v) — ``pred_star_2d_kernel`` on CUDA.  Its plain version is the 3D
    one, `projection_kernels.predictor_star_plain`, whose z terms vanish
    on a one-plane field."""
    if native.on_cpu(u):
        return predictor_star_plain(u, v, w, scal, c)
    _check(c, (u, v, w), (scal,))
    us, vs, ws = (torch.empty_like(u) for _ in range(3))
    native.launch("cfd_pred_star_2d", u.device, *map(native.ptr, (
        u, v, w, us, vs, ws, scal)), c.ny, c.nx, c.nu, c.inv_2dx,
        c.inv_2dy, c.inv_dx2, c.inv_dy2, c.xmin, c.ymin, c.dx, c.dy,
        int(c.with_sources))
    predictor_star_2d.launches += 1
    return us, vs, ws


# ---- pred_bt (b): spectral-solve input b̃ --------------------------------

def poisson_input_2d_plain(us, vs, p, rod, c: StencilConsts):
    """b̃ = face_coeff·p − (ρ/dt)∇·u* on the interior, zero shell."""
    coeff = interior(face_coeff(c, p.dtype, p.device))
    div = ddx(us, c.inv_2dx) + ddy(vs, c.inv_2dy)
    return set_interior(torch.zeros_like(p), coeff * interior(p) - rod * div)


def poisson_input_2d(us, vs, p, rod, c: StencilConsts):
    """b̃ — ``poisson_input_2d_kernel`` on CUDA; ``rod`` a 0-d tensor."""
    if native.on_cpu(us):
        return poisson_input_2d_plain(us, vs, p, rod, c)
    _check(c, (us, vs, p), (rod,))
    bt = torch.empty_like(p)
    native.launch("cfd_poisson_input_2d", p.device, *map(native.ptr, (
        us, vs, p, bt, rod)), c.ny, c.nx, c.inv_2dx, c.inv_2dy, c.inv_dx2,
        c.inv_dy2, 0)
    poisson_input_2d.launches += 1
    return bt


# ---- pred_bt (b), emit="rhs": the iterative solvers' right-hand side ----

def poisson_rhs_2d_plain(us, vs, rod, c: StencilConsts):
    """rhs = (ρ/dt)∇·u* on the interior, zero shell
    (`projection2d.py:196-197`)."""
    div = ddx(us, c.inv_2dx) + ddy(vs, c.inv_2dy)
    return set_interior(torch.zeros_like(us), rod * div)


def poisson_rhs_2d(us, vs, rod, c: StencilConsts):
    """rhs — ``poisson_input_2d_kernel`` in its emit-rhs form on CUDA."""
    if native.on_cpu(us):
        return poisson_rhs_2d_plain(us, vs, rod, c)
    _check(c, (us, vs), (rod,))
    rhs = torch.empty_like(us)
    native.launch("cfd_poisson_input_2d", us.device, *map(native.ptr, (
        us, vs, us, rhs, rod)), c.ny, c.nx, c.inv_2dx, c.inv_2dy,
        c.inv_dx2, c.inv_dy2, 1)
    poisson_rhs_2d.launches += 1
    return rhs


# ---- corr: corrector ------------------------------------------------------

def corrector_2d_plain(us, vs, p, s, c: StencilConsts):
    """u = clamp(u* − s·∂x p), v = clamp(v* − s·∂y p) on the interior
    (shells from u*, v*)."""
    u = set_interior(us, clamp(interior(us) - s * ddx(p, c.inv_2dx), CLAMP))
    v = set_interior(vs, clamp(interior(vs) - s * ddy(p, c.inv_2dy), CLAMP))
    return u, v


def corrector_2d(us, vs, p, s, c: StencilConsts):
    """(u, v) — ``corrector_2d_kernel`` on CUDA; ``s`` = dt/ρ, 0-d."""
    if native.on_cpu(us):
        return corrector_2d_plain(us, vs, p, s, c)
    _check(c, (us, vs, p), (s,))
    u, v = torch.empty_like(us), torch.empty_like(vs)
    native.launch("cfd_corrector_2d", us.device, *map(native.ptr, (
        us, vs, p, u, v, s)), c.ny, c.nx, c.inv_2dx, c.inv_2dy)
    corrector_2d.launches += 1
    return u, v


predictor_star_2d.launches = 0
poisson_input_2d.launches = 0
poisson_rhs_2d.launches = 0
corrector_2d.launches = 0

# every wrapper that launches a kernel on the 2D main path, for counters
WRAPPERS = (predictor_star_2d, poisson_input_2d, right_dot, tdma_z_fwd,
            tdma_z_bwd, left_dot, corrector_2d)
# ... and on the 2D CG step's path (the whole-solve kernel counts in
# vmem_small)
WRAPPERS_RHS = (predictor_star_2d, poisson_rhs_2d, corrector_2d)


def reset_launch_counts() -> None:
    for fn in WRAPPERS + WRAPPERS_RHS:
        fn.launches = 0


class Projection2DKernels:
    """The two fused kernels for one (uniform 2D grid, dtype, device).

    ``emit="btilde"`` (the spectral step): ``dst_mats`` = (FxT, GxT) from
    `solvers.poisson.spectral.make_dst2d_fused_pieces`.  ``emit="rhs"``
    (the iterative solvers): pred_bt emits the Poisson right-hand side and
    ``corr`` takes a physical p.  The default runs the wrappers (kernels
    on CUDA, plain versions on CPU).  ``plain=True`` is a reference switch
    for checks on the card only: it runs the plain PyTorch versions on a
    CUDA device too, so ``chip_smoke.py`` can hold the kernels against
    them and time both.
    """

    def __init__(self, ny, nx, dx, dy, xmin, ymin, nu, dst_mats=None,
                 with_sources=True, plain=False, emit="btilde"):
        if emit not in ("btilde", "rhs"):
            raise ValueError(f"emit must be 'btilde' or 'rhs', got {emit!r}")
        self.emit = emit
        self.consts = StencilConsts(1, ny, nx, dx, dy, 0.0, xmin, ymin,
                                    float(nu), bool(with_sources))
        if emit == "btilde":
            self.fxt, self.gxt = dst_mats
        if plain:
            self._star, self._bt = (predictor_star_plain,
                                    poisson_input_2d_plain)
            self._dot, self._corr = right_dot_plain, corrector_2d_plain
            self._rhs = poisson_rhs_2d_plain
        else:
            self._star, self._bt = predictor_star_2d, poisson_input_2d
            self._dot, self._corr = right_dot, corrector_2d
            self._rhs = poisson_rhs_2d

    def predictor_and_poisson_input(self, u, v, w, p, dt, su, sv,
                                    rho_over_dt):
        """pred_bt: (u*, v*, w*, b̃·FxT), or (u*, v*, w*, rhs) with
        ``emit="rhs"``; each (1, ny, nx).  ``dt``, ``su``, ``sv`` and
        ``rho_over_dt`` are 0-d tensors on the field's device."""
        c = self.consts
        us, vs, ws = self._star(u, v, w, torch.stack([dt, su, sv]), c)
        if self.emit == "rhs":
            return us, vs, ws, self._rhs(us, vs, rho_over_dt, c)
        bt = self._bt(us, vs, p, rho_over_dt, c)
        return us, vs, ws, self._dot(bt, self.fxt)

    def corrector(self, us, vs, xhat, dt_over_rho):
        """corr: (u, v, p) from the y-line solve's x̂ (transform space);
        p = x̂·GxT is the physical pressure with its mirror x-shells.  With
        ``emit="rhs"`` the non-DST ``corr`` (`projection2d.py:252-270`):
        ``xhat`` is the physical p, and (u, v) come back."""
        if self.emit == "rhs":
            return self._corr(us, vs, xhat, dt_over_rho, self.consts)
        p = self._dot(xhat, self.gxt)
        u, v = self._corr(us, vs, p, dt_over_rho, self.consts)
        return u, v, p
