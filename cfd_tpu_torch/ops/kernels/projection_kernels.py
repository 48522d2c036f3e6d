"""The projection step's two mega kernels (counterpart of
`cfd_tpu/ops/pallas/projection_kernels.py`).

Only the configurations the ported steps run are ported: single device,
DST-fused with the Thomas forward sweep in the predictor (``dst_mats`` +
``tdma_fwd``, nz ≥ 3), with or without Boussinesq buoyancy, on a uniform
grid (or a stretched one under the parity scheme, on its first-cell
spacings) or on a stretched grid under the consistent scheme
(``stretch_consistent``, `projection_kernels.py:118-136`): given
consistent `StencilConsts`, the stencil wrappers below launch their
kernels' ``<true>`` instantiations, which read the exact nonuniform
weights from per-axis rows (`stretch.stretch_pins_consistent`), b̃ with
the nonuniform face weights, and count them on ``consistent_launches``;
the DST products carry the generalized eigenbasis
(`solvers.poisson.nonuniform`).  The reference's two TPU kernels become
two chains of CUDA kernels that meet in device memory:

* **A1** ``ProjectionKernels.pred_bt`` (`projection_kernels.py:572-722`)
  → :meth:`ProjectionKernels.predictor_poisson_input`:
  :func:`predictor_star` → :func:`poisson_input` → `rolling.plane_dot`
  (forward xy DST) → `tdma.tdma_z_fwd`.  Returns (u*, v*, w*, d′, t),
  t None with ``tdma_bwd="analytic"`` (`tdma.tdma_z_fwd_d`: no t is
  written, the back substitution rebuilds it).  With buoyancy the
  predictor takes the step-start T and adds ((−β)·g[c])·(T − T_ref) to
  component c's source where g[c] ≠ 0 (`:319-321`, `:630-650`).
* **A5**, the per-component family the ``bc_refresh`` step runs
  (`projection_kernels.py:297-351`, `:466-514`; the reference's hook sits
  between them, `projection.py:562-579`): ``make_predictor`` →
  ``pred_u/v/w`` is :meth:`ProjectionKernels.predictor`
  (:func:`predictor_star`), ``btilde_k``'s DST + Thomas form is
  :meth:`ProjectionKernels.btilde` (:func:`poisson_input` → the forward
  xy DST → the Thomas forward sweep), ``divergence`` is
  :meth:`ProjectionKernels.rhs` (:func:`poisson_rhs`).  A1 is
  ``btilde(predictor(...))``: the port's A1 was already this chain.
* **A2** ``ProjectionKernels.corr_bwd`` (`projection_kernels.py:381-452`)
  → :meth:`ProjectionKernels.corrector_bwd_diag`: `tdma.tdma_z_bwd` (or
  `tdma.tdma_z_bwd_analytic`) → `rolling.plane_dot` (inverse xy DST) →
  :func:`corrector`.  Returns (u, v, w, p, max|u|², max p, max|p|), the
  maxima over planes 1..nz−2 (the step folds in the two z-shell planes).
* **A5** ``corr_all``'s DST form (`projection_kernels.py:724-756` with
  ``dst_mats``) → :meth:`ProjectionKernels.corrector_dst_diag`: the
  inverse xy DST of x̂ → :func:`corrector`, the second half of A2.  The
  reference has no reverse-march corrector at nz = 3
  (`projection_kernels.py:453-456`), so there its step runs the
  standalone back substitution (`tdma.make_tdma_z_bwd`, stored) and then
  this form; the port's A2 is that same chain at every nz.

``dst_precision`` (`:180-198`) sets the DST products' precision:
``"highest"`` (IEEE fp32, the SGEMM) or ``"high"`` (3xTF32, the
tensor-core GEMM of ``csrc/gemm_3xtf32.cu``).  ``tdma_bwd`` is
``"stored"`` or ``"analytic"``; as in the reference, "analytic" applies
only where the reverse-march corrector runs (nz ≥ 4) and is demoted to
"stored" at nz = 3.  The Thomas sweeps are fp32 either way.

The ``spectral_precision="default"`` step runs the non-DST emit-b̃ form
(A5 ``btilde_k`` with ``bt_dst`` False, A1's emit-b̃ output,
`projection_kernels.py:466-514`, `:712`): ``emit="btilde"`` without
``dst_mats``, :func:`poisson_input` alone (the physical b̃ for a
transform pipeline) and :meth:`ProjectionKernels.corrector_diag` on the
pipeline's p.

The CG step (``emit="rhs"``, nz ≥ 3) runs A1's rhs form,
:func:`predictor_star` → :func:`poisson_rhs` ((ρ/dt)∇·u*, the same kernel
as b̃ with its emit flag set), and A5's non-DST ``corr_all``
(`projection_kernels.py:724-756`) →
:meth:`ProjectionKernels.corrector_diag`, which is :func:`corrector` on a
physical p.

The z-decomposed step (`parallel.fused`) runs :func:`predictor_star`
and :func:`poisson_input` in A1's and A5 ``btilde_k``'s ``global_nz``
mode (`projection_kernels.py:561-567`, `:464-510`): given ``z_base``
(the global plane of the block's plane 0) and ``nz_g`` (the global plane
count) they take a shard's halo-padded block, put the z-shells and b̃'s
z face term at global planes, and count on ``global_nz_launches``; the
inverse DST and :func:`corrector` run unchanged on its 1-halo x̂ block
(A5 ``corr_all``'s sharded form).  On the consistent scheme the same
mode runs on the ``<true, false>`` instantiations, the weight rows being
z-invariant (the reference composes its consistent pins with
``global_nz``, `projection_kernels.py:203-211`), counted on
``global_nz_launches`` too; the corrector on the 1-halo block counts on
``consistent_launches``.  Its CG and BiCGSTAB steps take
:func:`poisson_rhs` in the same mode (A5 ``divergence`` with
``global_nz``) and :func:`corrector` on the 1-halo block of the solved p
(A5 ``corr_xy`` → ``corr_u`` / ``corr_v`` and ``corr_w``,
`projection_kernels.py:516-547`: the per-component correction is the
same arithmetic as ``corr_all``'s, one kernel for the three).

The (z, y)-decomposed step runs the global-row mode
(``ProjectionKernels(global_nz, global_ny)``: ``rows_cols`` /
``interior_mask`` / ``source_plane``, `projection_kernels.py:262-281`, and
the per-component ``y_off``, `:306-312`, `:343-344`, `:475-478`,
`:519-520`, `:536-537`): given ``y_base`` and ``ny_g`` beside the plane
ones, :func:`predictor_star` takes the y-shells and the sin(πy) source at
global rows on a block padded along y too; :func:`poisson_input` and
:func:`poisson_rhs` compute the owned window ``halo`` planes and rows in
from the block's sides (b̃'s y face term on the global rows 1 and
ny_g − 2) into an owned-size output; :func:`corrector_rows` corrects the
owned window of a p block padded one plane and one row a side and
returns the owned p beside u, v, w, the maxima over every owned point.
Each is its kernel's global-row instantiation, counted on
``global_ny_launches``.

Every wrapper below launches its CUDA kernel on a CUDA tensor and runs its
plain PyTorch version (``*_plain``) on a CPU tensor; its ``launches``
attribute counts kernel launches.  The CUDA sources are in
``cfd_tpu_torch/csrc/projection_kernels.cu`` and ``gemm_3xtf32.cu``.

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
* the ``<true>`` (consistent) instantiations — the same bound, the same
  fields moved, plus the weight rows (7·(nx + ny) floats, read once into
  L1: a thread's x weights are coalesced across the warp, its y weights
  one broadcast); each derivative takes three products where the
  uniform one takes one.  The uniform instantiations keep their
  registers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...solvers.energy import buoyancy_coefficients
from ...solvers.ns.common import clamp
from ...solvers.ns.params import PROJ_MAX_VELOCITY as CLAMP  # = kClamp
from ...solvers.ns.params import param_value
from ..stencils import (along_x, along_y, ddx, ddy, ddz, interior, laplacian,
                        laplacian_interior, set_interior)
from . import native, rolling
from .rolling import plane_dot, plane_dot_plain
from .stretch import stretch_pins_consistent
from .tdma import (_bwd_coeff_planes, tdma_z_bwd, tdma_z_bwd_analytic,
                   tdma_z_bwd_analytic_reference, tdma_z_bwd_reference,
                   tdma_z_fwd, tdma_z_fwd_d, tdma_z_fwd_d_reference,
                   tdma_z_fwd_reference)


@dataclasses.dataclass(frozen=True)
class StencilConsts:
    """Compile-time constants of one grid (the reference bakes the
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
    # ((−β)·g[c] or None where g[c] = 0, for c = x, y, z), T_ref), exact
    # in the field's dtype (`solvers.energy.buoyancy_coefficients`); None
    # without buoyancy
    buoyancy: tuple = None
    # the consistent scheme on a stretched grid: (xw, yw), the (7, nx) and
    # (7, ny) weight rows of `stretch.stretch_pins_consistent` as tensors
    # on the fields' device, and the b̃ face weights (cxm, cxp, cym, cyp)
    # (`solvers.poisson.nonuniform.nonuniform_face_coeffs`); None on the
    # parity scheme, whose constants are dx, dy above
    weights: tuple = dataclasses.field(default=None, compare=False)
    face: tuple = None

    @property
    def consistent(self) -> bool:
        return self.weights is not None

    @property
    def scheme(self):
        """The launch counter's scheme (`native.count_launch`): None on a
        uniform grid and on the parity scheme (the uniform kernels on
        dx0, dy0), "consistent" on the weight rows."""
        return "consistent" if self.consistent else None

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

    def buoyancy_args(self):
        """The predictor kernels' trailing (b0, b1, b2, T_ref, mask)."""
        if self.buoyancy is None:
            return 0.0, 0.0, 0.0, 0.0, 0
        coefs, tref = self.buoyancy
        mask = sum(1 << q for q, b in enumerate(coefs) if b is not None)
        return (*(0.0 if b is None else float(b) for b in coefs),
                float(tref), mask)


def stencil_consts(nz, ny, nx, dx, dy, dz, xmin, ymin, nu, with_sources,
                   params=None, dtype=torch.float32, weights=None,
                   face=None) -> StencilConsts:
    """StencilConsts of one grid, with the buoyancy of ``params`` (an
    NSParams; β ≠ 0) in ``dtype``: the components whose gravity is 0 get
    no term, as in the reference's kernels; ``weights`` and ``face`` as
    in :class:`StencilConsts`."""
    buoy = None
    if params is not None and params.buoyancy_enabled:
        coefs, tref = buoyancy_coefficients(params.beta, params.gravity,
                                            params.T_ref, dtype)
        buoy = (tuple(b if g != 0.0 else None
                      for b, g in zip(coefs, params.gravity)), tref)
    if face is not None:
        face = tuple(float(f) for f in face)
    return StencilConsts(nz, ny, nx, dx, dy, dz, xmin, ymin,
                         param_value(nu), bool(with_sources), buoy, weights,
                         face)


def consistent_weights(dx, dy, x, y, dtype, device):
    """(xw, yw): the consistent scheme's (7, nx) and (7, ny) weight rows
    (`stretch.stretch_pins_consistent`) as ``dtype`` tensors on
    ``device``."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return tuple(torch.as_tensor(a, device=device)
                 for a in stretch_pins_consistent(dx, dy, x, y, np_dt))


def _rows(c: StencilConsts, like):
    """The consistent weight rows at the interior points (plain
    versions): 7 x rows broadcasting over (…, nx − 2) and 7 y rows over
    (…, ny − 2, 1), in ``like``'s dtype."""
    xw, yw = c.weights
    return ([r[None, None, :] for r in xw[:, 1:-1].to(like.dtype)],
            [r[None, :, None] for r in yw[:, 1:-1].to(like.dtype)])


def _check(c: StencilConsts, fields, scalars):
    """(nz, ny, nx) float32 fields and float32 scalars on one CUDA device,
    and the weight rows there on the consistent scheme."""
    native.check_cuda(*fields, *scalars, *(c.weights or ()))
    for f in fields:
        if tuple(f.shape) != (c.nz, c.ny, c.nx):
            raise ValueError(f"expected fields of shape "
                             f"{(c.nz, c.ny, c.nx)}, got {tuple(f.shape)}")


# ---- A1 (a): predictor u*, v*, w* ----------------------------------------

def _keep_global_shells(out, f, c: StencilConsts, z_base, nz_g,
                        y_base: int = 0, ny_g: int = None):
    """``out`` with ``f`` on the planes of a z-decomposed shard's block
    whose global index kg = z_base + k is a global z-shell or lies past
    one (an edge shard's halo planes): the planes the ``global_nz``
    kernels pass through (`projection_kernels.py:636-638`, ``kq > 0 &
    kq < nz_g − 1``); with ``ny_g`` the rows whose global index
    y_base + j is a global y-shell or lies past one too (the global-row
    ``interior_mask``, `:270-273`); ``out`` itself on one device."""
    if nz_g is None and ny_g is None:
        return out
    shell = torch.zeros((), dtype=torch.bool, device=f.device)
    if nz_g is not None:
        kg = z_base + torch.arange(c.nz, device=f.device)
        shell = shell | ((kg <= 0) | (kg >= nz_g - 1))[:, None, None]
    if ny_g is not None:
        jg = y_base + torch.arange(c.ny, device=f.device)
        shell = shell | ((jg <= 0) | (jg >= ny_g - 1))[None, :, None]
    return torch.where(shell, f, out)


def _window(t, h: int):
    """The owned window of a block padded ``h`` planes and rows a side
    (a contiguous copy; the block itself for h = 0)."""
    if h == 0:
        return t
    return t[h:t.shape[0] - h, h:t.shape[1] - h].contiguous()


def _pad_window(t, h: int):
    """``t`` zero-padded ``h`` planes and rows a side."""
    if h == 0:
        return t
    out = t.new_zeros((t.shape[0] + 2 * h, t.shape[1] + 2 * h)
                      + tuple(t.shape[2:]))
    out[h:-h, h:-h] = t
    return out


def _no_rows_consistent(c: StencilConsts, ny_g):
    """The reference refuses the consistent scheme in global-row mode
    (`projection_kernels.py:209-211`)."""
    if ny_g is not None and c.consistent:
        raise ValueError("stretch_consistent does not support y-sharded "
                         "(global_ny) mode")


def predictor_star_plain(u, v, w, scal, c: StencilConsts, T=None,
                         z_base: int = 0, nz_g: int = None,
                         y_base: int = 0, ny_g: int = None):
    """u* = clamp(u + dt(−u·∇u + ν∇²u + src)) on the interior, shells
    passed through; ``scal`` = [dt, su, sv] (source amplitudes with the
    decay folded in); with ``c.buoyancy`` the step-start ``T`` adds
    b[c]·(T − T_ref) to component c's source.  Also the plain version of
    the 2D predictor: on a one-plane field the z terms vanish (the
    reference's inv_dz2 = 0 idiom), leaving its 2D operation order.

    ``global_nz`` mode (A1's, `projection_kernels.py:561-567`): the fields
    are a z-decomposed shard's halo-padded block whose local plane k is
    global plane ``z_base + k`` of an ``nz_g``-plane domain; the global
    z-shells, and the planes past them, pass through as well.  With
    ``ny_g`` the global-row mode: local row j is global row ``y_base + j``
    of an ``ny_g``-row domain, for the y-shells and the sin(πy) source."""
    _no_rows_consistent(c, ny_g)
    dt, su, sv = scal[0], scal[1], scal[2]
    i2x, i2y, i2z, ix2, iy2, iz2 = c.derivs()
    uc, vc, wc = interior(u), interior(v), interior(w)
    if c.consistent:
        X, Y = _rows(c, u)

        def operators(f):
            return (along_x(f, X), along_y(f, Y),
                    laplacian_interior(f, X[3:6], Y[3:6], iz2))
    else:
        def operators(f):
            return ddx(f, i2x), ddy(f, i2y), laplacian(f, ix2, iy2, iz2)

    def star(f, src):
        fx, fy, lap = operators(f)
        conv = (uc * fx + vc * fy) + wc * ddz(f, i2z)
        s = interior(f) + dt * ((-conv + c.nu * lap) + src)
        return set_interior(f, clamp(s, CLAMP))

    if c.with_sources and c.consistent:
        # the default source basis at the true coordinates (weight row 6)
        src_u, src_v = su * Y[6], sv * X[6]
    elif c.with_sources:
        jj = (torch.arange(1, c.ny - 1, device=u.device)
              + (y_base if ny_g is not None else 0)).to(u.dtype)
        ii = torch.arange(1, c.nx - 1, device=u.device).to(u.dtype)
        src_u = su * torch.sin(torch.pi * (c.ymin + jj * c.dy))[:, None]
        src_v = sv * torch.sin(2.0 * torch.pi * (c.xmin + ii * c.dx))[None]
    else:
        src_u = src_v = 0.0
    srcs = [src_u, src_v, 0.0]
    if c.buoyancy is not None:
        coefs, tref = c.buoyancy
        dT = interior(T) - tref
        srcs = [s if b is None else s + b * dT for s, b in zip(srcs, coefs)]
    return tuple(_keep_global_shells(star(f, src), f, c, z_base, nz_g,
                                     y_base, ny_g)
                 for f, src in zip((u, v, w), srcs))


def check_buoyancy_input(c: StencilConsts, T, shape):
    """With buoyancy the predictor kernels read T: a float32 CUDA field
    of the grid's shape."""
    if c.buoyancy is None:
        return
    if T is None:
        raise ValueError("the buoyant predictor needs the temperature T")
    native.check_cuda(T)
    if tuple(T.shape) != shape:
        raise ValueError(f"expected T of shape {shape}, got "
                         f"{tuple(T.shape)}")


def _counter(c: StencilConsts, nz_g, ny_g=None):
    """The launch counter of a stencil wrapper's call: the scheme's,
    ``global_nz`` for a z-decomposed shard's block, ``global_ny`` for a
    (z, y)-decomposed one's."""
    if ny_g is not None:
        return "global_ny"
    return "global_nz" if nz_g is not None else c.scheme


def _z_args(c: StencilConsts, z_base, nz_g):
    """The kernels' trailing (z_base, nz_g): (0, nz) on one device."""
    return (0, c.nz) if nz_g is None else (int(z_base), int(nz_g))


def predictor_star(u, v, w, scal, c: StencilConsts, T=None,
                   z_base: int = 0, nz_g: int = None, y_base: int = 0,
                   ny_g: int = None):
    """(u*, v*, w*) — ``pred_star_kernel<false, false>`` on CUDA,
    ``<true, false>`` on the consistent scheme's weight rows (counted by
    scheme, `native.count_launch`); ``T`` is read with buoyancy only.
    With ``nz_g`` the ``global_nz`` mode of :func:`predictor_star_plain`,
    counted on ``global_nz_launches``; with ``ny_g`` the global-row mode,
    ``<false, true>``, counted on ``global_ny_launches``."""
    if native.on_cpu(u):
        return predictor_star_plain(u, v, w, scal, c, T, z_base, nz_g,
                                    y_base, ny_g)
    _no_rows_consistent(c, ny_g)
    _check(c, (u, v, w), (scal,))
    check_buoyancy_input(c, T, (c.nz, c.ny, c.nx))
    us, vs, ws = (torch.empty_like(u) for _ in range(3))
    t_ptr = None if c.buoyancy is None else native.ptr(T)
    fields = (*map(native.ptr, (u, v, w, us, vs, ws, scal)), t_ptr)
    if c.consistent:
        native.launch("cfd_pred_star_cons", u.device, *fields,
                      *map(native.ptr, c.weights), c.nz, c.ny, c.nx,
                      float(c.nu),
                      c.inv_2dz, c.inv_dz2, int(c.with_sources),
                      *c.buoyancy_args(), *_z_args(c, z_base, nz_g))
    elif ny_g is not None:
        native.launch("cfd_pred_star_rows", u.device, *fields, c.nz, c.ny,
                      c.nx, float(c.nu), *c.derivs(), c.xmin, c.ymin, c.dx,
                      c.dy, int(c.with_sources), *c.buoyancy_args(),
                      *_z_args(c, z_base, nz_g), int(y_base), int(ny_g))
    else:
        native.launch("cfd_pred_star", u.device, *fields, c.nz, c.ny, c.nx,
                      float(c.nu), *c.derivs(), c.xmin, c.ymin, c.dx, c.dy,
                      int(c.with_sources), *c.buoyancy_args(),
                      *_z_args(c, z_base, nz_g))
    native.count_launch(predictor_star, _counter(c, nz_g, ny_g))
    return us, vs, ws


# ---- A1 (a'): spectral-solve input b̃ --------------------------------------

def face_coeff(c: StencilConsts, dtype, device, z_base: int = 0,
               nz_g: int = None, y_base: int = 0, ny_g: int = None):
    """(nz, ny, nx) Neumann-mirror face coefficients, in the reference
    kernel's summation order ((x + y) + z; the z term is 0 in 2D).  On the
    consistent scheme the x/y term is ((cxm·[i = 1] + cxp·[i = nx − 2])
    + cym·[j = 1]) + cyp·[j = ny − 2] (`projection_kernels.py:658-668`).
    With ``nz_g`` the z term sits at the global planes 1 and nz_g − 2
    (local plane k is global plane ``z_base + k``, `:487-492`), with
    ``ny_g`` the y term at the global rows 1 and ny_g − 2 (`:475-478`)."""
    def face(n, inv_d2, base=0, n_g=None):
        k = base + torch.arange(n, device=device)
        n_g = n if n_g is None else n_g
        return inv_d2 * ((k == 1).to(dtype) + (k == n_g - 2).to(dtype))

    if c.consistent:
        cxm, cxp, cym, cyp = c.face

        def at(n, q):
            return (torch.arange(n, device=device) == q).to(dtype)

        cxy = (((cxm * at(c.nx, 1) + cxp * at(c.nx, c.nx - 2))[None, :]
                + cym * at(c.ny, 1)[:, None]) + cyp * at(c.ny, c.ny - 2)[:, None])
    else:
        cxy = (face(c.nx, c.inv_dx2)[None, :]
               + face(c.ny, c.inv_dy2, y_base, ny_g)[:, None])
    return cxy[None] + face(c.nz, c.inv_dz2, z_base, nz_g)[:, None, None]


def poisson_input_plain(us, vs, ws, p, rod, c: StencilConsts,
                        z_base: int = 0, nz_g: int = None, y_base: int = 0,
                        ny_g: int = None, halo: int = 0):
    """b̃ = face_coeff·p − (ρ/dt)∇·u* on the interior, zero shell.  With
    ``nz_g`` the ``global_nz`` mode of A5's ``btilde_k``
    (`projection_kernels.py:464-510`): the fields are a z-decomposed
    shard's halo-padded block (local plane k = global plane
    ``z_base + k``), the z face term lands on the global planes 1 and
    nz_g − 2, and the global z-shells (and the planes past them) are
    zero.  With ``ny_g`` the global-row mode: local row j is global row
    ``y_base + j`` (the y face term on the global rows 1 and ny_g − 2,
    zero global y-shells), and b̃ is the owned window ``halo`` planes and
    rows in from the block's sides, as is ``p``."""
    _no_rows_consistent(c, ny_g)
    p = _pad_window(p, halo)
    coeff = interior(face_coeff(c, p.dtype, p.device, z_base, nz_g, y_base,
                                ny_g))
    bt = set_interior(torch.zeros_like(p), coeff * interior(p)
                      - rod * divergence_star(us, vs, ws, c))
    return _window(_keep_global_shells(bt, torch.zeros_like(bt), c, z_base,
                                       nz_g, y_base, ny_g), halo)


def _launch_input(us, vs, ws, p, out, rod, c: StencilConsts, emit_rhs,
                  z_args, y_args=None):
    """One ``poisson_input_kernel`` launch, ``<true, false>`` on the
    consistent scheme (its b̃ form reads the face weights), ``<false,
    true>`` with ``y_args`` = (y_base, ny_g, halo); ``z_args`` the block's
    (z_base, nz_g)."""
    ptrs = map(native.ptr, (us, vs, ws, p, out, rod))
    if y_args is not None:
        native.launch("cfd_poisson_input_rows", us.device, *ptrs, c.nz,
                      c.ny, c.nx, *c.derivs(), emit_rhs, *z_args, *y_args)
        return
    if not c.consistent:
        native.launch("cfd_poisson_input", us.device, *ptrs, c.nz, c.ny,
                      c.nx, *c.derivs(), emit_rhs, *z_args)
        return
    if not emit_rhs and c.face is None:
        raise ValueError("the consistent b̃ needs the face weights")
    native.launch("cfd_poisson_input_cons", us.device, *ptrs,
                  *map(native.ptr, c.weights), c.nz, c.ny, c.nx, c.inv_2dz,
                  c.inv_dz2, *(c.face or (0.0,) * 4), emit_rhs, *z_args)


def _window_shape(c: StencilConsts, halo: int):
    return (c.nz - 2 * halo, c.ny - 2 * halo, c.nx)


def _y_args(c: StencilConsts, y_base, ny_g, halo, *owned):
    """The global-row launch's (y_base, ny_g, halo), the owned-size
    tensors checked; None on a block without ``ny_g``."""
    if ny_g is None:
        if halo:
            raise ValueError("an owned window needs the global-row mode "
                             "(ny_g)")
        return None
    _no_rows_consistent(c, ny_g)
    for t in owned:
        if tuple(t.shape) != _window_shape(c, halo):
            raise ValueError(f"expected the owned window "
                             f"{_window_shape(c, halo)}, got "
                             f"{tuple(t.shape)}")
    return int(y_base), int(ny_g), int(halo)


def poisson_input(us, vs, ws, p, rod, c: StencilConsts, z_base: int = 0,
                  nz_g: int = None, y_base: int = 0, ny_g: int = None,
                  halo: int = 0):
    """b̃ — ``poisson_input_kernel`` on CUDA (``<true, false>`` on the
    consistent scheme, counted by scheme); ``rod`` a 0-d tensor.  With
    ``nz_g`` the ``global_nz`` mode of :func:`poisson_input_plain`,
    counted on ``global_nz_launches``; with ``ny_g`` the global-row mode
    on the owned window (``<false, true>``), counted on
    ``global_ny_launches``."""
    if native.on_cpu(us):
        return poisson_input_plain(us, vs, ws, p, rod, c, z_base, nz_g,
                                   y_base, ny_g, halo)
    _check(c, (us, vs, ws), (p, rod))
    y_args = _y_args(c, y_base, ny_g, halo, p)
    if y_args is None:
        _check(c, (p,), ())
    bt = torch.empty_like(p)
    _launch_input(us, vs, ws, p, bt, rod, c, 0, _z_args(c, z_base, nz_g),
                  y_args)
    native.count_launch(poisson_input, _counter(c, nz_g, ny_g))
    return bt


# ---- A1 (b), emit="rhs": the iterative solvers' right-hand side ----------

def divergence_star(us, vs, ws, c: StencilConsts):
    """∇·u* on the interior, in the kernels' order ((x + y) + z); the x/y
    terms take the consistent weights on that scheme."""
    if c.consistent:
        X, Y = _rows(c, us)
        return (along_x(us, X) + along_y(vs, Y)) + ddz(ws, c.inv_2dz)
    return (ddx(us, c.inv_2dx) + ddy(vs, c.inv_2dy)) + ddz(ws, c.inv_2dz)


def poisson_rhs_plain(us, vs, ws, rod, c: StencilConsts, z_base: int = 0,
                      nz_g: int = None, y_base: int = 0, ny_g: int = None,
                      halo: int = 0):
    """rhs = (ρ/dt)∇·u* on the interior, zero shell
    (`projection_kernels.py:699-701`: no face term, no minus).  With
    ``nz_g`` the ``global_nz`` mode of A5's ``divergence``
    (`projection_kernels.py:340-351`, the z-decomposed CG and BiCGSTAB
    steps): the fields are a shard's halo-padded block (local plane k =
    global plane ``z_base + k``), and the global z-shells (and the planes
    past them) are zero, the reference's ``fix_shell`` of the rhs
    (`parallel/fused.py:583-585`).  With ``ny_g`` the global-row mode as
    :func:`poisson_input_plain`'s: zero global y-shells, the owned
    window ``halo`` planes and rows in."""
    _no_rows_consistent(c, ny_g)
    rhs = set_interior(torch.zeros_like(us),
                       rod * divergence_star(us, vs, ws, c))
    return _window(_keep_global_shells(rhs, torch.zeros_like(rhs), c,
                                       z_base, nz_g, y_base, ny_g), halo)


def poisson_rhs(us, vs, ws, rod, c: StencilConsts, z_base: int = 0,
                nz_g: int = None, y_base: int = 0, ny_g: int = None,
                halo: int = 0):
    """rhs — ``poisson_input_kernel`` in its emit-rhs form on CUDA
    (``<true, false>`` on the consistent scheme, counted by scheme).  With
    ``nz_g`` the ``global_nz`` mode of :func:`poisson_rhs_plain`,
    counted on ``global_nz_launches``; with ``ny_g`` the global-row mode
    on the owned window, counted on ``global_ny_launches``."""
    if native.on_cpu(us):
        return poisson_rhs_plain(us, vs, ws, rod, c, z_base, nz_g, y_base,
                                 ny_g, halo)
    _check(c, (us, vs, ws), (rod,))
    y_args = _y_args(c, y_base, ny_g, halo)
    rhs = us.new_empty(_window_shape(c, halo))
    _launch_input(us, vs, ws, us, rhs, rod, c, 1, _z_args(c, z_base, nz_g),
                  y_args)
    native.count_launch(poisson_rhs, _counter(c, nz_g, ny_g))
    return rhs


# ---- A2 (e): corrector + diagnostics --------------------------------------

def corrector_plain(us, vs, ws, p, s, c: StencilConsts):
    """u = clamp(u* − s∇p) on the interior (shells from u*), with the
    maxima of |u|², p and |p| over planes 1..nz−2 (NaN propagates).  The
    x/y gradients take the consistent weights on that scheme."""
    if c.consistent:
        X, Y = _rows(c, p)
        gx, gy = along_x(p, X), along_y(p, Y)
    else:
        gx, gy = ddx(p, c.inv_2dx), ddy(p, c.inv_2dy)
    u = set_interior(us, clamp(interior(us) - s * gx, CLAMP))
    v = set_interior(vs, clamp(interior(vs) - s * gy, CLAMP))
    dpz = p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]
    w = set_interior(ws, clamp(interior(ws) - (s * dpz) * c.inv_2dz, CLAMP))
    zi = slice(1, -1)
    m2 = torch.amax((u[zi] * u[zi] + v[zi] * v[zi]) + w[zi] * w[zi])
    return u, v, w, m2, torch.amax(p[zi]), torch.amax(torch.abs(p[zi]))


def corrector(us, vs, ws, p, s, c: StencilConsts):
    """(u, v, w, max|u|², max p, max|p|) — ``corrector_kernel`` plus the
    second-pass ``reduce_max3_kernel`` on CUDA (``<true>`` on the
    consistent scheme, counted by scheme); ``s`` = dt/ρ, 0-d."""
    if native.on_cpu(us):
        return corrector_plain(us, vs, ws, p, s, c)
    _check(c, (us, vs, ws, p), (s,))
    u, v, w = (torch.empty_like(us) for _ in range(3))
    n_part = native.library().cfd_corrector_partials(c.nz, c.ny, c.nx)
    partials = torch.empty(3 * n_part, dtype=us.dtype, device=us.device)
    red = torch.empty(3, dtype=us.dtype, device=us.device)
    ptrs = map(native.ptr, (us, vs, ws, p, u, v, w, s, partials, red))
    if c.consistent:
        native.launch("cfd_corrector_cons", us.device, *ptrs,
                      *map(native.ptr, c.weights), c.nz, c.ny, c.nx,
                      c.inv_2dz)
    else:
        native.launch("cfd_corrector", us.device, *ptrs, c.nz, c.ny, c.nx,
                      c.inv_2dx, c.inv_2dy, c.inv_2dz)
    native.count_launch(corrector, c.scheme)
    return u, v, w, red[0], red[1], red[2]


def corrector_rows_plain(us, vs, ws, p, s, c: StencilConsts, z_base: int,
                         nz_g: int, y_base: int, ny_g: int):
    """The global-row corrector (A5 ``corr_u/v/w`` with ``global_ny``,
    `projection_kernels.py:516-547`): ``p`` a (z, y)-decomposed shard's
    block padded one plane and one row a side (``c`` its constants, local
    (k, j) the global plane ``z_base + k`` and row ``y_base + j``), u*,
    v*, w* a block around the same owned window padded hs ≥ 1 a side.
    Returns (u, v, w, p) on the owned window — u = clamp(u* − s∇p) at the
    global interior, u* on the global shells an edge shard owns — and
    max|u|², max p, max|p| over every owned point."""
    _no_rows_consistent(c, ny_g)
    hs = (us.shape[0] - (c.nz - 2)) // 2
    if hs < 1:
        raise ValueError("the corrector's u*, v*, w* need a halo of >= 1")
    usb, vsb, wsb = (_window(f, hs - 1) for f in (us, vs, ws))
    gx, gy = ddx(p, c.inv_2dx), ddy(p, c.inv_2dy)
    dpz = p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]
    u = set_interior(usb, clamp(interior(usb) - s * gx, CLAMP))
    v = set_interior(vsb, clamp(interior(vsb) - s * gy, CLAMP))
    w = set_interior(wsb, clamp(interior(wsb) - (s * dpz) * c.inv_2dz,
                                CLAMP))
    u, v, w = (_window(_keep_global_shells(f, fs, c, z_base, nz_g, y_base,
                                           ny_g), 1)
               for f, fs in ((u, usb), (v, vsb), (w, wsb)))
    po = _window(p, 1)
    m2 = torch.amax((u * u + v * v) + w * w)
    return u, v, w, po, m2, torch.amax(po), torch.amax(torch.abs(po))


def corrector_rows(us, vs, ws, p, s, c: StencilConsts, z_base: int,
                   nz_g: int, y_base: int, ny_g: int):
    """(u, v, w, p, max|u|², max p, max|p|) on the owned window —
    ``corrector_kernel<false, true>`` plus ``reduce_max3_kernel`` on
    CUDA, counted on ``global_ny_launches``; :func:`corrector_rows_plain`
    on the CPU.  ``s`` = dt/ρ, 0-d."""
    if native.on_cpu(us):
        return corrector_rows_plain(us, vs, ws, p, s, c, z_base, nz_g,
                                    y_base, ny_g)
    _no_rows_consistent(c, ny_g)
    _check(c, (p,), (s,))
    own = _window_shape(c, 1)
    hs = (us.shape[0] - own[0]) // 2
    star = (own[0] + 2 * hs, own[1] + 2 * hs, own[2])
    native.check_cuda(us, vs, ws, p)
    if hs < 1 or any(tuple(f.shape) != star for f in (us, vs, ws)):
        raise ValueError(f"expected u*, v*, w* padded >= 1 around the owned "
                         f"window {own}, got {tuple(us.shape)}")
    u, v, w, po = (us.new_empty(own) for _ in range(4))
    n_part = native.library().cfd_corrector_partials(*own)
    partials = us.new_empty(3 * n_part)
    red = us.new_empty(3)
    native.launch("cfd_corrector_rows", us.device, *map(native.ptr, (
        us, vs, ws, p, u, v, w, po, s, partials, red)), c.nz, c.ny, c.nx,
        c.inv_2dx, c.inv_2dy, c.inv_2dz, int(z_base), int(nz_g),
        int(y_base), int(ny_g), hs)
    native.count_launch(corrector_rows, "global_ny")
    return u, v, w, po, red[0], red[1], red[2]


native.reset_counts(predictor_star, poisson_input, poisson_rhs, corrector,
                    corrector_rows)

# every wrapper that launches a kernel on the main path (plane_dot counts
# its SGEMM launches), for counters
WRAPPERS = (predictor_star, poisson_input, plane_dot, tdma_z_fwd,
            tdma_z_bwd, corrector)
# ... on the HIGH path (plane_dot counts its 3xTF32 launches in
# ``high_launches``)
WRAPPERS_HIGH = (predictor_star, poisson_input, tdma_z_fwd_d,
                 tdma_z_bwd_analytic, corrector)
# ... and on the CG step's path (the CG kernels count in cg_kernels)
WRAPPERS_RHS = (predictor_star, poisson_rhs, corrector)
# (the consistent scheme's steps launch the same wrappers, counted on
# their ``consistent_launches``)


def reset_launch_counts() -> None:
    native.reset_counts(predictor_star, poisson_input, poisson_rhs,
                        corrector, corrector_rows)
    for fn in WRAPPERS + WRAPPERS_HIGH:
        fn.launches = 0
    rolling.reset_launch_counts()


class ProjectionKernels:
    """The two mega kernels for one (grid, dtype, device).

    ``params`` (an NSParams) brings Boussinesq buoyancy when its β ≠ 0,
    with the coefficients rounded to ``dtype``.
    ``emit="btilde"`` (the spectral step): ``dst_mats`` = (FxT, Fy, GxT,
    Gy) and ``tdma_fwd`` = (mu plane, w) from
    `solvers.poisson.spectral.make_dst_fused_pieces`; nz ≥ 3.  Without
    ``dst_mats`` it is the non-DST emit-b̃ form (A5 ``btilde_k`` with
    ``bt_dst`` False, `projection_kernels.py:466-514`, and A1's emit-b̃
    output, `:712`; the reference's ``spectral_precision=DEFAULT`` step):
    :meth:`btilde` returns the physical b̃ for a transform pipeline, and
    :meth:`corrector_diag` takes the physical p.
    ``dst_precision`` is ``"highest"`` or ``"high"``; ``tdma_bwd``
    ``"stored"`` or ``"analytic"`` (its coefficient planes built here
    from the float32 mu plane in float64, as the reference builds
    them, `projection_kernels.py:373-380`; "stored" at nz = 3).
    ``emit="rhs"`` (the iterative solvers, nz ≥ 3): A1 emits the Poisson
    right-hand side and the corrector takes a physical p
    (:meth:`corrector_diag`, the non-DST ``corr_all``).
    ``stretch_consistent`` = (dx, dy, x, y) numpy arrays selects the
    consistent scheme (`projection_kernels.py:118-136`): the stencil
    kernels' ``<true>`` instantiations on the weight rows, built here on
    ``device`` (default: the mats', else the CPU), with ``face_coeffs``
    (cxm, cxp, cym, cyp) for b̃, and ``dst_mats`` / ``tdma_fwd`` the
    generalized eigenbasis pieces (`solvers.poisson.nonuniform.
    make_nonuniform_fused_pieces`).  The default runs
    the wrappers (kernels on CUDA, plain versions on CPU).  ``plain=True``
    is a reference switch for checks on the card only: it runs the plain
    PyTorch versions on a CUDA device too, so ``chip_smoke.py`` can hold
    the kernels against them and time both.
    """

    def __init__(self, nz, ny, nx, dx, dy, dz, xmin, ymin, nu,
                 dst_mats=None, tdma_fwd=None, with_sources=True,
                 plain=False, emit="btilde", dst_precision="highest",
                 tdma_bwd="stored", params=None, dtype=torch.float32,
                 stretch_consistent=None, face_coeffs=None, device=None):
        self.emit = emit
        if stretch_consistent is not None and emit == "btilde" \
                and face_coeffs is None:
            raise ValueError("stretch_consistent with emit='btilde' needs "
                             "face_coeffs")
        rolling._check_precision(dst_precision)
        if tdma_bwd not in ("stored", "analytic"):
            raise ValueError(f"unknown tdma_bwd {tdma_bwd!r}")
        self.precision = dst_precision
        self.bwd_analytic = False
        if emit not in ("btilde", "rhs"):
            raise ValueError(f"emit must be 'btilde' or 'rhs', got {emit!r}")
        self.dst = emit == "btilde" and dst_mats is not None
        if emit == "btilde" and nz < 3:
            raise ValueError("the spectral step needs nz >= 3")
        if self.dst:
            self.fxt, self.fy, self.gxt, self.gy = dst_mats
            self.mu, self.w = tdma_fwd
            # the reference's reverse-march corrector, which alone
            # rebuilds t, needs nz >= 4 (`projection_kernels.py:369`)
            self.bwd_analytic = tdma_bwd == "analytic" and nz >= 4
            if self.bwd_analytic:
                mu64 = self.mu.detach().to("cpu", torch.float64).numpy()
                np_dt = np.float64 if self.mu.dtype == torch.float64 \
                    else np.float32
                self.coef = torch.as_tensor(
                    _bwd_coeff_planes(mu64, self.w, np_dt),
                    device=self.mu.device)
        weights = None
        self.consistent = stretch_consistent is not None
        if self.consistent:
            if device is None:
                device = (dst_mats[0].device if dst_mats is not None
                          else "cpu")
            weights = consistent_weights(*stretch_consistent, dtype, device)
        self.consts = stencil_consts(nz, ny, nx, dx, dy, dz, xmin, ymin, nu,
                                     with_sources, params, dtype, weights,
                                     face_coeffs)
        if plain:
            self._star, self._bt, self._dot = (
                predictor_star_plain, poisson_input_plain, plane_dot_plain)
            self._fwd, self._bwd, self._corr = (
                tdma_z_fwd_reference, tdma_z_bwd_reference, corrector_plain)
            self._fwd_d, self._bwd_an = (tdma_z_fwd_d_reference,
                                         tdma_z_bwd_analytic_reference)
            self._rhs = poisson_rhs_plain
        else:
            self._star, self._bt, self._dot = (
                predictor_star, poisson_input, plane_dot)
            self._fwd, self._bwd, self._corr = (
                tdma_z_fwd, tdma_z_bwd, corrector)
            self._fwd_d, self._bwd_an = tdma_z_fwd_d, tdma_z_bwd_analytic
            self._rhs = poisson_rhs

    def predictor(self, u, v, w, dt, su, sv, T=None):
        """A5 ``make_predictor`` → ``pred_u/v/w`` (`projection_kernels.py:
        297-338`): (u*, v*, w*), the caller's shells passed through; ``T``
        the step-start temperature, read with buoyancy.  ``dt``, ``su``
        and ``sv`` are 0-d tensors on the field's device."""
        return self._star(u, v, w, torch.stack([dt, su, sv]), self.consts,
                          T)

    def btilde(self, us, vs, ws, p, rho_over_dt):
        """A5 ``btilde_k``, the DST + Thomas form (`:466-514`): b̃ =
        face_coeff·p − (ρ/dt)∇·u*, its forward xy DST and the Thomas
        forward sweep along z — (d′, t), t None with the analytic back
        substitution.  Without ``dst_mats``, the non-DST form: the
        physical b̃ alone (zero shell)."""
        bt = self._bt(us, vs, ws, p, rho_over_dt, self.consts)
        if not self.dst:
            return bt
        bhat = self._dot(bt, self.fxt, self.fy, self.precision)
        if self.bwd_analytic:
            return self._fwd_d(bhat, self.mu, self.w), None
        return tuple(self._fwd(bhat, self.mu, self.w))

    def rhs(self, us, vs, ws, rho_over_dt):
        """A5 ``divergence`` (`:340-351`): the iterative solvers'
        right-hand side (ρ/dt)∇·u* on the interior, zero shell."""
        return self._rhs(us, vs, ws, rho_over_dt, self.consts)

    def predictor_poisson_input(self, u, v, w, p, dt, su, sv, rho_over_dt,
                                T=None):
        """A1: ``btilde(predictor(...))`` — (u*, v*, w*, d′, t), t None
        with the analytic back substitution, or (u*, v*, w*, b̃) in the
        non-DST form; or, with ``emit="rhs"``, ``rhs(predictor(...))`` —
        (u*, v*, w*, rhs)."""
        us, vs, ws = self.predictor(u, v, w, dt, su, sv, T)
        if self.emit == "rhs":
            return us, vs, ws, self.rhs(us, vs, ws, rho_over_dt)
        if not self.dst:
            return us, vs, ws, self.btilde(us, vs, ws, p, rho_over_dt)
        return (us, vs, ws) + self.btilde(us, vs, ws, p, rho_over_dt)

    def corrector_diag(self, us, vs, ws, p, dt_over_rho):
        """A5 ``corr_all``, non-DST single-chip form
        (`projection_kernels.py:724-756`): the corrector with the maxima
        on a physical p — (u, v, w, max|u|², max p, max|p|), maxima over
        planes 1..nz−2."""
        return self._corr(us, vs, ws, p, dt_over_rho, self.consts)

    def corrector_dst_diag(self, us, vs, ws, xhat, dt_over_rho):
        """A5 ``corr_all``, DST single-chip form: p = Gy·(x̂·GxT) on every
        plane (mirror shells), then the corrector with the maxima —
        (u, v, w, p, max|u|², max p, max|p|)."""
        p = self._dot(xhat, self.gxt, self.gy, self.precision)
        u, v, w, m2, pmax, pabs = self._corr(us, vs, ws, p, dt_over_rho,
                                             self.consts)
        return u, v, w, p, m2, pmax, pabs

    def corrector_bwd_diag(self, us, vs, ws, d, t, dt_over_rho):
        """A2: (u, v, w, p, max|u|², max p, max|p|) from the predictor's
        (d′, t) (t None with the analytic back substitution).  Maxima over
        planes 1..nz−2."""
        if self.bwd_analytic:
            xhat = self._bwd_an(d, self.coef)
        else:
            xhat = self._bwd(d, t)
        return self.corrector_dst_diag(us, vs, ws, xhat, dt_over_rho)
