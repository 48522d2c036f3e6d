"""The 2D projection step's two fused kernels (counterpart of
`cfd_tpu/ops/pallas/projection2d.py`, the DST-fused single-device form).

Single device, ``emit="btilde"`` with the x-DST pair
(``dst_mats``) or ``emit="rhs"``, with or without Boussinesq buoyancy.
The reference's TPU kernels on the block-marching engine (`marching2d.py`)
become chains of CUDA kernels that meet in device memory:

* ``Projection2DKernels.pred_bt`` (`projection2d.py:200-216`)
  → :meth:`Projection2DKernels.predictor_and_poisson_input`:
  :func:`predictor_star_2d` → :func:`poisson_input_2d` →
  `rolling.right_dot` (b̃·FxT, the forward x-DST).  Returns
  (u*, v*, w*, b̃·FxT).  With buoyancy the predictor takes the
  step-start T and adds ((−β)·g[c])·(T − T_ref) to component c's source
  where g[c] ≠ 0 (`:166-176`).
* The split pair the ``bc_refresh`` step runs, the caller's hook between
  them (`projection2d.py:218-250`, `:311-326`): ``pred_only`` is
  :meth:`Projection2DKernels.predictor` (:func:`predictor_star_2d`),
  ``bt_only`` :meth:`Projection2DKernels.poisson_input`
  (:func:`poisson_input_2d` → the forward x-DST, or
  :func:`poisson_rhs_2d`).  pred_bt is ``poisson_input(predictor(...))``:
  the port's pred_bt was already this chain.
* ``Projection2DKernels.corr`` (`projection2d.py:252-282`)
  → :meth:`Projection2DKernels.corrector`: `rolling.right_dot`
  (p = x̂·GxT, the arrival hook's inverse x-DST) → :func:`corrector_2d`.
  Returns (u, v, p); w = w* at the caller (inv_dz2 = 0).

The y-line solve between them (`solvers.poisson.spectral.
make_dst2d_fused_pieces`) runs `tdma.tdma_y_2d` (both Thomas sweeps in
one launch of ``tdma_y2d_kernel``, `csrc/tdma_lines.cu`) and the rescue
products.  ``precision`` sets
the x-DST pair's: ``"highest"`` (the SGEMM) or ``"high"`` (the 3xTF32
tensor-core GEMM), the reference's ``dst_precision``; the Thomas sweeps
stay fp32.  ``spectral_precision="default"`` runs the pair without the
x-DST (the physical b̃ and p, around a transform pipeline at one TF32
pass).

On a stretched grid the consistent scheme's 2D step (jnp in the
reference, `projection.py:292-293`) runs the same wrappers on consistent
`StencilConsts`: they launch the three stencil kernels' ``<true>``
instantiations on the weight rows (`stretch.stretch_pins_consistent`),
b̃ with the nonuniform face weights, counted on ``consistent_launches``.

The CG step (``emit="rhs"``) runs pred_bt's rhs form,
:func:`predictor_star_2d` → :func:`poisson_rhs_2d` ((ρ/dt)∇·u*, the b̃
kernel with its emit flag set), and the non-DST ``corr``
(:func:`corrector_2d` on a physical p).

The y-decomposed step (`parallel.fused`, the reference's
``Projection2DKernels(global_ny=...)``, `projection2d.py:46-110`) runs the
global-row mode: given ``y_base`` (the global row of the block's row 0)
and ``ny_g`` (the global row count), :func:`predictor_star_2d` takes a
shard's rows padded two a side, its y-shells and sin(πy) source at global
rows; :func:`poisson_input_2d` computes the owned window ``halo`` rows in
from the block's sides (b̃'s y face term on the global rows 1 and
ny_g − 2, zero global y-shells) into an owned-size output; the new
:func:`corrector_2d_rows` corrects the owned rows of a p block padded one
row a side and returns the owned p beside u and v.  Each is its kernel's
``<false, true>`` instantiation, counted on ``global_ny_launches``.

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
from ..stencils import along_x, along_y, ddx, ddy, interior, set_interior
from . import native, rolling
from .projection_kernels import (StencilConsts, _keep_global_shells,
                                 _no_rows_consistent, _rows,
                                 check_buoyancy_input, consistent_weights,
                                 face_coeff, predictor_star_plain,
                                 stencil_consts)
from .rolling import rescue_dot, right_dot, right_dot_plain
from .tdma import tdma_y_2d


def _check(c: StencilConsts, fields, scalars, ny=None):
    """(1, ny, nx) float32 fields (``ny`` default ``c.ny``) and float32
    scalars on one CUDA device, and the weight rows there on the
    consistent scheme."""
    native.check_cuda(*fields, *scalars, *(c.weights or ()))
    shape = (1, c.ny if ny is None else ny, c.nx)
    for f in fields:
        if tuple(f.shape) != shape:
            raise ValueError(f"expected fields of shape {shape}, got "
                             f"{tuple(f.shape)}")


def _row_window(t, h: int):
    """The owned rows of a (1, ny, nx) block padded ``h`` rows a side (a
    contiguous copy; the block itself for h = 0)."""
    if h == 0:
        return t
    return t[:, h:t.shape[1] - h].contiguous()


def _pad_rows(t, h: int):
    """``t`` zero-padded ``h`` rows a side."""
    if h == 0:
        return t
    return torch.nn.functional.pad(t, (0, 0, h, h))


# ---- pred_bt (a): predictor u*, v*, w* ----------------------------------

def predictor_star_2d(u, v, w, scal, c: StencilConsts, T=None,
                      y_base: int = 0, ny_g: int = None):
    """(u*, v*, w*) = clamp(f + dt(−(u∂x + v∂y)f + ν∇²f + src)) on the
    interior, shells passed through (w is predicted too, convected by u,
    v; with ``c.buoyancy`` ``T`` adds the buoyant sources) —
    ``pred_star_2d_kernel<false, false>`` on CUDA, ``<true, false>`` on
    the consistent scheme's weight rows (counted by scheme,
    `native.count_launch`).  With ``ny_g`` the global-row mode, ``<false,
    true>``, counted on ``global_ny_launches``: the fields are a shard's
    rows padded with its neighbours', local row j the global row
    ``y_base + j``.  Its plain version is the 3D one,
    `projection_kernels.predictor_star_plain`, whose z terms vanish on a
    one-plane field."""
    if native.on_cpu(u):
        return predictor_star_plain(u, v, w, scal, c, T, 0, None, y_base,
                                    ny_g)
    _no_rows_consistent(c, ny_g)
    _check(c, (u, v, w), (scal,))
    check_buoyancy_input(c, T, (1, c.ny, c.nx))
    us, vs, ws = (torch.empty_like(u) for _ in range(3))
    t_ptr = None if c.buoyancy is None else native.ptr(T)
    fields = (*map(native.ptr, (u, v, w, us, vs, ws, scal)), t_ptr)
    if c.consistent:
        native.launch("cfd_pred_star_2d_cons", u.device, *fields,
                      *map(native.ptr, c.weights), c.ny, c.nx, float(c.nu),
                      int(c.with_sources), *c.buoyancy_args())
    else:
        uniform = (c.ny, c.nx, float(c.nu), c.inv_2dx, c.inv_2dy,
                   c.inv_dx2, c.inv_dy2, c.xmin, c.ymin, c.dx, c.dy,
                   int(c.with_sources), *c.buoyancy_args())
        if ny_g is None:
            native.launch("cfd_pred_star_2d", u.device, *fields, *uniform)
        else:
            native.launch("cfd_pred_star_2d_rows", u.device, *fields,
                          *uniform, int(y_base), int(ny_g))
    native.count_launch(predictor_star_2d,
                        c.scheme if ny_g is None else "global_ny")
    return us, vs, ws


# ---- pred_bt (b): spectral-solve input b̃ --------------------------------

def _grad2d(fx, fy, c: StencilConsts):
    """(∂x fx, ∂y fy) on the interior: central differences, or the
    consistent weights on that scheme."""
    if c.consistent:
        X, Y = _rows(c, fx)
        return along_x(fx, X), along_y(fy, Y)
    return ddx(fx, c.inv_2dx), ddy(fy, c.inv_2dy)


def poisson_input_2d_plain(us, vs, p, rod, c: StencilConsts,
                           y_base: int = 0, ny_g: int = None,
                           halo: int = 0):
    """b̃ = face_coeff·p − (ρ/dt)∇·u* on the interior, zero shell.  With
    ``ny_g`` the global-row mode: local row j is global row ``y_base + j``
    (the y face term on the global rows 1 and ny_g − 2, zero global
    y-shells), and b̃ is the owned window ``halo`` rows in from the
    block's sides, as is ``p``."""
    _no_rows_consistent(c, ny_g)
    p = _pad_rows(p, halo)
    coeff = interior(face_coeff(c, p.dtype, p.device, 0, None, y_base,
                                ny_g))
    dx_u, dy_v = _grad2d(us, vs, c)
    bt = set_interior(torch.zeros_like(p),
                      coeff * interior(p) - rod * (dx_u + dy_v))
    if ny_g is None:
        return bt
    return _row_window(_keep_global_shells(bt, torch.zeros_like(bt), c, 0,
                                           None, y_base, ny_g), halo)


def _launch_input(us, vs, p, out, rod, c: StencilConsts, emit_rhs,
                  y_args=None):
    """One ``poisson_input_2d_kernel`` launch, ``<true, false>`` on the
    consistent scheme (its b̃ form reads the face weights), ``<false,
    true>`` with ``y_args`` = (y_base, ny_g, halo)."""
    ptrs = map(native.ptr, (us, vs, p, out, rod))
    if not c.consistent:
        derivs = (c.ny, c.nx, c.inv_2dx, c.inv_2dy, c.inv_dx2, c.inv_dy2,
                  emit_rhs)
        if y_args is None:
            native.launch("cfd_poisson_input_2d", us.device, *ptrs, *derivs)
        else:
            native.launch("cfd_poisson_input_2d_rows", us.device, *ptrs,
                          *derivs, *y_args)
        return
    if not emit_rhs and c.face is None:
        raise ValueError("the consistent b̃ needs the face weights")
    native.launch("cfd_poisson_input_2d_cons", us.device, *ptrs,
                  *map(native.ptr, c.weights), c.ny, c.nx,
                  *(c.face or (0.0,) * 4), emit_rhs)


def poisson_input_2d(us, vs, p, rod, c: StencilConsts, y_base: int = 0,
                     ny_g: int = None, halo: int = 0):
    """b̃ — ``poisson_input_2d_kernel`` on CUDA (``<true, false>`` on the
    consistent scheme, counted by scheme); ``rod`` a 0-d tensor.  With
    ``ny_g`` the global-row mode of :func:`poisson_input_2d_plain` on the
    owned window (``<false, true>``), counted on
    ``global_ny_launches``."""
    if native.on_cpu(us):
        return poisson_input_2d_plain(us, vs, p, rod, c, y_base, ny_g, halo)
    _check(c, (us, vs), (rod,))
    if ny_g is None:
        _check(c, (p,), ())
        y_args = None
    else:
        _no_rows_consistent(c, ny_g)
        _check(c, (p,), (), c.ny - 2 * halo)
        y_args = (int(y_base), int(ny_g), int(halo))
    bt = torch.empty_like(p)
    _launch_input(us, vs, p, bt, rod, c, 0, y_args)
    native.count_launch(poisson_input_2d,
                        c.scheme if ny_g is None else "global_ny")
    return bt


# ---- pred_bt (b), emit="rhs": the iterative solvers' right-hand side ----

def poisson_rhs_2d_plain(us, vs, rod, c: StencilConsts):
    """rhs = (ρ/dt)∇·u* on the interior, zero shell
    (`projection2d.py:196-197`)."""
    dx_u, dy_v = _grad2d(us, vs, c)
    return set_interior(torch.zeros_like(us), rod * (dx_u + dy_v))


def poisson_rhs_2d(us, vs, rod, c: StencilConsts):
    """rhs — ``poisson_input_2d_kernel`` in its emit-rhs form on CUDA
    (``<true>`` on the consistent scheme, counted by scheme)."""
    if native.on_cpu(us):
        return poisson_rhs_2d_plain(us, vs, rod, c)
    _check(c, (us, vs), (rod,))
    rhs = torch.empty_like(us)
    _launch_input(us, vs, us, rhs, rod, c, 1)
    native.count_launch(poisson_rhs_2d, c.scheme)
    return rhs


# ---- corr: corrector ------------------------------------------------------

def corrector_2d_plain(us, vs, p, s, c: StencilConsts):
    """u = clamp(u* − s·∂x p), v = clamp(v* − s·∂y p) on the interior
    (shells from u*, v*)."""
    gx, gy = _grad2d(p, p, c)
    u = set_interior(us, clamp(interior(us) - s * gx, CLAMP))
    v = set_interior(vs, clamp(interior(vs) - s * gy, CLAMP))
    return u, v


def corrector_2d(us, vs, p, s, c: StencilConsts):
    """(u, v) — ``corrector_2d_kernel`` on CUDA (``<true>`` on the
    consistent scheme, counted by scheme); ``s`` = dt/ρ, 0-d."""
    if native.on_cpu(us):
        return corrector_2d_plain(us, vs, p, s, c)
    _check(c, (us, vs, p), (s,))
    u, v = torch.empty_like(us), torch.empty_like(vs)
    ptrs = map(native.ptr, (us, vs, p, u, v, s))
    if c.consistent:
        native.launch("cfd_corrector_2d_cons", us.device, *ptrs,
                      *map(native.ptr, c.weights), c.ny, c.nx)
    else:
        native.launch("cfd_corrector_2d", us.device, *ptrs, c.ny, c.nx,
                      c.inv_2dx, c.inv_2dy)
    native.count_launch(corrector_2d, c.scheme)
    return u, v


def corrector_2d_rows_plain(us, vs, p, s, c: StencilConsts, y_base: int,
                            ny_g: int):
    """The global-row corrector (the reference's ``corr`` with
    ``global_ny``, `projection2d.py:252-282`): ``p`` a y-decomposed
    shard's rows padded one a side (``c`` its constants, local row j the
    global row ``y_base + j``), u*, v* the same owned rows padded
    hs ≥ 1 a side.  Returns (u, v, p) on the owned rows — u = clamp(u* −
    s∇p) at the global interior, u* on the global shells an edge shard
    owns."""
    _no_rows_consistent(c, ny_g)
    hs = (us.shape[1] - (c.ny - 2)) // 2
    if hs < 1:
        raise ValueError("the corrector's u*, v* need a halo of >= 1")
    usb, vsb = _row_window(us, hs - 1), _row_window(vs, hs - 1)
    gx, gy = _grad2d(p, p, c)
    u = set_interior(usb, clamp(interior(usb) - s * gx, CLAMP))
    v = set_interior(vsb, clamp(interior(vsb) - s * gy, CLAMP))
    u, v = (_row_window(_keep_global_shells(f, fs, c, 0, None, y_base,
                                            ny_g), 1)
            for f, fs in ((u, usb), (v, vsb)))
    return u, v, _row_window(p, 1)


def corrector_2d_rows(us, vs, p, s, c: StencilConsts, y_base: int,
                      ny_g: int):
    """(u, v, p) on the owned rows — ``corrector_2d_kernel<false, true>``
    on CUDA, counted on ``global_ny_launches``;
    :func:`corrector_2d_rows_plain` on the CPU.  ``s`` = dt/ρ, 0-d."""
    if native.on_cpu(us):
        return corrector_2d_rows_plain(us, vs, p, s, c, y_base, ny_g)
    _no_rows_consistent(c, ny_g)
    _check(c, (p,), (s,))
    own = (1, c.ny - 2, c.nx)
    hs = (us.shape[1] - own[1]) // 2
    native.check_cuda(us, vs, p)
    if hs < 1 or any(tuple(f.shape) != (1, own[1] + 2 * hs, c.nx)
                     for f in (us, vs)):
        raise ValueError(f"expected u*, v* padded >= 1 around the owned "
                         f"rows {own}, got {tuple(us.shape)}")
    u, v, po = (us.new_empty(own) for _ in range(3))
    native.launch("cfd_corrector_2d_rows", us.device, *map(native.ptr, (
        us, vs, p, u, v, po, s)), c.ny, c.nx, c.inv_2dx, c.inv_2dy,
        int(y_base), int(ny_g), hs)
    native.count_launch(corrector_2d_rows, "global_ny")
    return u, v, po


native.reset_counts(predictor_star_2d, poisson_input_2d, poisson_rhs_2d,
                    corrector_2d, corrector_2d_rows)

# every wrapper that launches a kernel on the 2D main path, for counters
WRAPPERS = (predictor_star_2d, poisson_input_2d, right_dot, tdma_y_2d,
            rescue_dot, corrector_2d)
# ... on the HIGH path (right_dot and rescue_dot count their 3xTF32
# launches in ``high_launches``)
WRAPPERS_HIGH = (predictor_star_2d, poisson_input_2d, tdma_y_2d,
                 corrector_2d)
# ... and on the 2D CG step's path (the whole-solve kernel counts in
# vmem_small)
WRAPPERS_RHS = (predictor_star_2d, poisson_rhs_2d, corrector_2d)
# (the consistent scheme's 2D steps launch the same wrappers, counted on
# their ``consistent_launches``; the direct solve's GEMMs count in rolling;
# the y-decomposed step's global-row launches count on
# ``global_ny_launches`` of predictor_star_2d, poisson_input_2d and
# corrector_2d_rows)


def reset_launch_counts() -> None:
    native.reset_counts(predictor_star_2d, poisson_input_2d, poisson_rhs_2d,
                        corrector_2d, corrector_2d_rows)
    for fn in WRAPPERS + WRAPPERS_RHS:
        fn.launches = 0
    rolling.reset_launch_counts()


class Projection2DKernels:
    """The two fused kernels for one (uniform 2D grid, dtype, device).

    ``emit="btilde"`` (the spectral step): ``dst_mats`` = (FxT, GxT) from
    `solvers.poisson.spectral.make_dst2d_fused_pieces`; without them the
    non-DST emit-b̃ form (``bt_only`` with ``bt_dst`` False, the
    reference's ``spectral_precision=DEFAULT`` step, `projection.py:
    353-369`): :meth:`poisson_input` returns the physical b̃ and
    :meth:`corrector` takes the physical p, as with ``emit="rhs"``.
    ``params`` (an NSParams) brings Boussinesq buoyancy when its β ≠ 0,
    the coefficients rounded to ``dtype``.  ``emit="rhs"`` (the iterative
    solvers): pred_bt emits the Poisson right-hand side and ``corr`` takes
    a physical p.  ``stretch_consistent`` = (dx, dy, x, y)
    selects the consistent scheme (the ``<true>`` instantiations on the
    weight rows, built on ``device``), ``face_coeffs`` its b̃ face
    weights.  The default runs the wrappers (kernels
    on CUDA, plain versions on CPU).  ``plain=True`` is a reference switch
    for checks on the card only: it runs the plain PyTorch versions on a
    CUDA device too, so ``chip_smoke.py`` can hold the kernels against
    them and time both.
    """

    def __init__(self, ny, nx, dx, dy, xmin, ymin, nu, dst_mats=None,
                 with_sources=True, plain=False, emit="btilde",
                 precision="highest", params=None, dtype=torch.float32,
                 stretch_consistent=None, face_coeffs=None, device=None):
        if emit not in ("btilde", "rhs"):
            raise ValueError(f"emit must be 'btilde' or 'rhs', got {emit!r}")
        rolling._check_precision(precision)
        self.emit = emit
        self.precision = precision
        weights = None
        self.consistent = stretch_consistent is not None
        if self.consistent:
            if device is None:
                device = (dst_mats[0].device if dst_mats is not None
                          else "cpu")
            weights = consistent_weights(*stretch_consistent, dtype, device)
        self.consts = stencil_consts(1, ny, nx, dx, dy, 0.0, xmin, ymin, nu,
                                     with_sources, params, dtype, weights,
                                     face_coeffs)
        self.dst = emit == "btilde" and dst_mats is not None
        if self.dst:
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

    def predictor(self, u, v, w, dt, su, sv, T=None):
        """``pred_only``: (u*, v*, w*), each (1, ny, nx); ``T`` the
        step-start temperature, read with buoyancy.  ``dt``, ``su`` and
        ``sv`` are 0-d tensors on the field's device."""
        return self._star(u, v, w, torch.stack([dt, su, sv]), self.consts,
                          T)

    def poisson_input(self, us, vs, p, rho_over_dt):
        """``bt_only``: b̃·FxT (the x-transformed b̃), the physical b̃
        without ``dst_mats``, or the rhs (ρ/dt)∇·u* with ``emit="rhs"``,
        from the (refreshed) u*, v*."""
        c = self.consts
        if self.emit == "rhs":
            return self._rhs(us, vs, rho_over_dt, c)
        bt = self._bt(us, vs, p, rho_over_dt, c)
        if not self.dst:
            return bt
        return self._dot(bt, self.fxt, self.precision)

    def predictor_and_poisson_input(self, u, v, w, p, dt, su, sv,
                                    rho_over_dt, T=None):
        """pred_bt: ``poisson_input(predictor(...))`` — (u*, v*, w*,
        b̃·FxT), or (u*, v*, w*, rhs) with ``emit="rhs"``."""
        us, vs, ws = self.predictor(u, v, w, dt, su, sv, T)
        return us, vs, ws, self.poisson_input(us, vs, p, rho_over_dt)

    def corrector(self, us, vs, xhat, dt_over_rho):
        """corr: (u, v, p) from the y-line solve's x̂ (transform space);
        p = x̂·GxT is the physical pressure with its mirror x-shells.  With
        ``emit="rhs"`` or without ``dst_mats`` the non-DST ``corr``
        (`projection2d.py:252-270`): ``xhat`` is the physical p, and
        (u, v) come back."""
        if not self.dst:
            return self._corr(us, vs, xhat, dt_over_rho, self.consts)
        p = self._dot(xhat, self.gxt, self.precision)
        u, v = self._corr(us, vs, p, dt_over_rho, self.consts)
        return u, v, p
