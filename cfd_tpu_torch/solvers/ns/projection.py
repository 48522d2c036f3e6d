"""Chorin projection step (counterpart of `cfd_tpu/solvers/ns/projection.py`,
the fused single-device branches: 3D `:544-657`, 2D `:659-717`).

The pressure solve is the reference's default CG (`solver_projection.c:
217-218`), BiCGSTAB, Red-Black SOR, Jacobi, multigrid
(``Method.MULTIGRID``) or the exact spectral solve (``Method.FFT_DIRECT``).

A 3D spectral step (nz ≥ 3) is the reference's two-kernel spectral
projection:

* A1, run as its two halves (A5's ``pred_u/v/w`` and ``btilde_k``):
  `ProjectionKernels.predictor`, u* = clamp(u + dt(−u·∇u + ν∇²u + f))
  with caller shells passed through, then `ProjectionKernels.btilde`,
  b̃ = face_coeff·p − (ρ/dt)∇·u*, forward xy DST and the Thomas forward
  sweep along z;
* A2 (`ProjectionKernels.corrector_bwd_diag`): Thomas back substitution,
  inverse xy DST to the pressure (mirror shells), corrector
  u = clamp(u* − (dt/ρ)∇p), and the diagnostics' interior maxima (at
  nz = 3, where the reference has no reverse-march corrector, its
  standalone back substitution and ``corr_all``'s DST form: the same
  chain);

then two z-shell face maxima complete max|u|², max p and max|p| exactly
as `field_status_and_diagnostics` would over the whole field.
``spectral_precision`` is None or ``"highest"`` (IEEE fp32 DST
products, stored t) or ``"high"`` (3xTF32 products on the tensor cores
and, at nz ≥ 4, the analytic-t back substitution: the predictor writes
no t), the reference's HIGHEST and HIGH (`projection.py:403-432`); the
2D step takes it for its x-DST pair and its rescue products.

``"default"`` (one TF32 pass on the tensor cores, the reference's
``lax.Precision.DEFAULT``) takes the reference's emit-b̃ route instead
(3D `projection.py:403-406`, `:450-472`; 2D `:321-323`, `:353-369`):
the predictor, the hook, the physical b̃ (A5's ``btilde_k`` without the
DST, `ProjectionKernels.btilde` on no ``dst_mats``), the transform
pipeline `spectral.make_fft_btilde_solver(z_mode="auto")` at DEFAULT
(3D: the xy DST, the Thomas z-stage, the inverse xy DST — nz = 3 too;
2D: the x DST, the y-line Thomas with its rescue, or the eigen pipeline,
by the reference's gates), then the corrector with its maxima on the
physical p (`corrector_diag`) and the face fold; in 2D the corrector on
p.  The consistent scheme at DEFAULT runs `make_nonuniform_direct` at
DEFAULT between its rhs and corrector kernels, as the reference's
DEFAULT falls out of its fused consistent path (`projection.py:
505-507`).

A 3D CG step (`:600-621`, nz ≥ 3) is the predictor, the rhs
(ρ/dt)∇·u* (`ProjectionKernels.rhs`, A5's ``divergence``), the CG solve
on the fused passes warm-started from p (`poisson.krylov.make_cg_fused`),
the corrector with its maxima on the physical p
(`ProjectionKernels.corrector_diag`) and the same face fold.
A 3D multigrid step (`:609-621` around `_make_multigrid` `:46-48`) is the
same step with the V-cycle iteration (`poisson.multigrid.make_multigrid`,
the sweep kernel on every level) in place of CG; so are the BiCGSTAB step
(the three fused passes, `poisson.krylov.make_bicgstab_fused`), the
Red-Black SOR step (the sweep kernel, `poisson.stationary.
make_redblack_sor_fused`) and the Jacobi step (the whole-solve kernel,
`poisson.stationary.make_jacobi_vmem`).  On its 2^k+1 grids the
reference runs its jnp body (its kernels' ``nx % 128`` gate, a TPU one,
fails there); the port keeps its kernels, as for CG.

A 2D step (nz == 1) is the reference's fused 2D form on every grid.
Spectral: `Projection2DKernels.predictor` then ``poisson_input`` (the
predictor, then b̃·FxT: ``pred_only`` / ``bt_only``), the y-line solve
of `make_dst2d_fused_pieces` (Thomas + dense low-mode rescue),
`Projection2DKernels.corrector` (p = x̂·GxT, corrector).  CG
(`:693-698`): predictor and rhs, the whole-solve CG kernel
(`poisson.krylov.make_cg_vmem`), the corrector on the physical p;
BiCGSTAB, Red-Black SOR and Jacobi the same with their whole-solve
kernels.  The reference's step runs those kernels only on grids that fit
VMEM (`:260-271`), its jnp makers otherwise, and never the fused
BiCGSTAB passes or the Red-Black SOR sweep; the port keeps its kernels on
every size, as for CG and multigrid: the arithmetic is the same.
Multigrid (`:694-698`): the same with the whole-solve multigrid kernel
(`poisson.multigrid.make_multigrid_vmem`), which computes the reference's
jnp ``make_multigrid`` by design.  A multigrid grid that cannot be
coarsened raises ``ERROR_UNSUPPORTED``, as the reference's.
In both, w = w* and the diagnostics come from
`field_status_and_diagnostics` over the new field.

Every branch runs the predictor on its own (A5's ``pred_u/v/w``, 2D
``pred_only``), then the caller's ``bc_refresh`` hook when one is given
(`projection.py:562-566`, `:671-679`), then b̃ or the rhs from the
refreshed u*, v*, w* (A5's ``btilde_k`` / ``divergence``, 2D
``bt_only``): without a hook that chain is A1.  Boussinesq buoyancy
(β ≠ 0) rides the predictor kernels with the step-start T.  The energy
equation (α > 0) runs after the corrector on the new velocities, in plain
PyTorch as the reference's jnp post-step, then the thermal BCs of
``params.thermal_bc`` (`projection.py:624-630`, `:702-708`); the
diagnostics' max T is that of the new T.

ρ is taken from the first grid point, floored at 1e-10 → 1.0.  dt, the
decayed source amplitudes, ρ and every diagnostic stay 0-d device
tensors; a step reports −7 (MAX_ITER) when its iterative solve did not
converge, with the solve's final residual.  The spectral step never reads
a device value on the host; the CG, BiCGSTAB and Red-Black SOR steps' 3D
solves read their running flag once per chunk of iterations
(`poisson.krylov.run_chunked`), the multigrid step's 3D solve its residual
once per check (`poisson.multigrid`), the whole solves nothing.

On a stretched x/y grid the parity scheme (the default) runs every
branch above on the first-cell spacings dx0, dy0, as the reference does
(`projection.py:151-152`, `solver_projection.c:72-75`).  The consistent
scheme (``nonuniform_scheme="consistent"``, `projection.py:158-253`,
`:474-542`) runs the stencil kernels' consistent instantiations (the
`ops.kernels.projection_kernels` and `projection2d` wrappers on
consistent `StencilConsts`) over the variable-coefficient problem (`poisson.nonuniform`): FFT_DIRECT in 3D
through the generalized eigenbasis in the DST's place (the same GEMMs,
the same Thomas sweeps over the eigenvalue sums), in 2D through
`make_nonuniform_direct` between the predictor's rhs and the corrector
(the reference's 2D consistent step is jnp); CG and BiCGSTAB through the
plain loops (`krylov.make_cg` / `make_bicgstab`) over the volume-weighted
problem, as the reference's jnp solves between its fused kernels; any
other method raises ``ERROR_UNSUPPORTED`` with the reference's message.
With ``bc_refresh`` the consistent step keeps its kernels (the reference
falls back to its jnp body there, `projection.py:484`).  On a uniform
grid the consistent scheme is the parity step.

``differentiable=True`` builds, on the card, the hybrid step
(`hybrid.pair_vjp`: the kernels' value, ``torch.autograd`` of the plain
differentiable step as the reverse pass — no kernel has a backward
kernel) and, on the CPU or with ``plain=True``, the plain differentiable
step: every branch above on the plain versions, an iterative method's
solve swapped for its adjoint (`poisson.adjoint.make_adjoint_poisson`,
`projection.py:237-248`, `:272-276`); the spectral chain is
differentiable as it is.

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
from ..poisson.adjoint import make_adjoint_poisson
from ..poisson.base import Method, PoissonParams, PoissonProblem
from ..poisson.krylov import (make_bicgstab, make_bicgstab_fused,
                              make_bicgstab_vmem, make_cg, make_cg_fused,
                              make_cg_vmem)
from ..poisson.multigrid import (make_multigrid, make_multigrid_vmem,
                                 raise_not_coarsenable)
from ..poisson.stationary import (make_jacobi_vmem, make_redblack_sor_fused,
                                  make_redblack_sor_vmem)
from ..poisson.nonuniform import (NonuniformPoissonProblem,
                                  make_nonuniform_direct,
                                  make_nonuniform_fused_pieces,
                                  nonuniform_face_coeffs)
from ..poisson.spectral import (make_dst2d_fused_pieces, make_dst_fused_pieces,
                                make_fft_btilde_solver)
from ..energy import apply_thermal_bcs, make_energy_step, validate_thermal_bc
from .common import (field_status_and_diagnostics, kernel_step, runs_plain,
                     step_result, validate_grid_for_solver)
from .hybrid import check_params, pair_vjp
from .params import NSParams


# the iterative solve of each method: (method, 2D) -> maker.  The
# reference's step runs its whole-solve kernels only on grids that fit
# VMEM and otherwise its jnp makers (`projection.py:260-284`); the port
# keeps its kernels on every size, with the same arithmetic.
_ITERATIVE = {
    (Method.CG, True): make_cg_vmem,
    (Method.CG, False): make_cg_fused,
    (Method.BICGSTAB, True): make_bicgstab_vmem,
    (Method.BICGSTAB, False): make_bicgstab_fused,
    (Method.REDBLACK_SOR, True): make_redblack_sor_vmem,
    (Method.REDBLACK_SOR, False): make_redblack_sor_fused,
    (Method.JACOBI, True): make_jacobi_vmem,
    (Method.JACOBI, False): make_jacobi_vmem,
    (Method.MULTIGRID, True): make_multigrid_vmem,
    (Method.MULTIGRID, False): make_multigrid,
}


# the consistent scheme's Krylov solves: the plain loops
_CONSISTENT_KRYLOV = {Method.CG: make_cg, Method.BICGSTAB: make_bicgstab}


def _unsupported(what: str):
    raise CFDError(Status.ERROR_UNSUPPORTED,
                   f"projection step: {what} is not ported yet")


# the pressure solves of the consistent scheme (`projection.py:226-253`)
_CONSISTENT_METHODS = (Method.FFT_DIRECT, Method.CG, Method.BICGSTAB)


def is_consistent(grid: Grid, params: NSParams) -> bool:
    """The consistent scheme's step runs: ``nonuniform_scheme=
    "consistent"`` on a stretched x/y grid.  On a uniform grid the two
    schemes coincide and the parity step runs (`projection.py:168-169`)."""
    return (params.nonuniform_scheme == "consistent"
            and not (grid.is_uniform("x") and grid.is_uniform("y")))


# spectral_precision → the DST products' precision (`ops.kernels.rolling`)
_PRECISIONS = {None: "highest", "highest": "highest", "high": "high",
               "default": "default"}


def _check_slice(grid: Grid, params: NSParams, poisson_method,
                 spectral_precision):
    method = Method(poisson_method)
    if method != Method.FFT_DIRECT and (method, True) not in _ITERATIVE:
        _unsupported(f"poisson_method {method.name}")
    if is_consistent(grid, params) and method not in _CONSISTENT_METHODS:
        # the reference's own refusal (`projection.py:249-253`)
        raise CFDError(
            Status.ERROR_UNSUPPORTED,
            f"consistent-scheme projection supports poisson_method "
            f"FFT_DIRECT/CG/BICGSTAB, got {method.name}")
    if params.heat_source_func is not None:
        _unsupported("a heat_source_func")
    if params.source_func is not None:
        _unsupported("a custom source_func")
    if method == Method.FFT_DIRECT and spectral_precision not in _PRECISIONS:
        _unsupported(f"spectral_precision={spectral_precision!r} (the "
                     f"ported ones are 'highest', IEEE fp32, 'high', "
                     f"3xTF32, and 'default', one TF32 pass)")


def thermal_post_step(grid: Grid, params: NSParams):
    """``post(field, dt) -> field``: the energy step on the new field with
    its new velocities, then the thermal BCs (`projection.py:624-630`,
    `:702-708`); the field as it is when the energy equation is off."""
    energy_step = make_energy_step(grid, params.alpha,
                                   params.heat_source_func,
                                   scheme=params.nonuniform_scheme)
    if energy_step is None:
        return lambda field, dt: field

    def post(field, dt):
        T = energy_step(field.T, field.u, field.v, field.w, dt)
        return field.replace(T=apply_thermal_bcs(T, params.thermal_bc))

    return post


def make_projection_step(grid: Grid, params: NSParams, dtype=None,
                         poisson_method: Method = Method.CG,
                         poisson_params: PoissonParams = None,
                         device=None, spectral_precision=None,
                         differentiable: bool = False, bc_refresh=None,
                         plain: bool = False, poisson_solve_override=None):
    """Build ``step(field, dt, iter_idx) -> (field, StepResult)`` for a 3D
    (nz ≥ 3) or 2D (nz == 1) grid, uniform or stretched in x/y (the
    scheme of ``params.nonuniform_scheme``).

    ``poisson_method`` is ``Method.CG`` by default, as in the reference,
    or ``BICGSTAB``, ``REDBLACK_SOR``, ``JACOBI`` or ``MULTIGRID`` (2^k+1
    grids), with ``poisson_params`` (default ``PoissonParams()``, as
    given — no factory defaults; CG ignores ``Precond.MULTIGRID``, as the
    reference's step does); ``FFT_DIRECT`` is the exact spectral solve.
    ``spectral_precision`` (None or ``"highest"``, ``"high"`` or
    ``"default"``) applies to the spectral solve only.

    ``bc_refresh``: an optional ``fn(u*, v*, w*, t_next) -> (u*, v*, w*)``
    run on the predictor's state before the pressure solve, with
    ``t_next = (iter_idx + 1)·dt`` a 0-d tensor (`projection.py:102-122`):
    the caller's boundary application, so the predictor's shell is
    consistent with its interior.  ``params`` with α > 0 turns on the
    energy equation (run after the corrector, then ``params.thermal_bc``),
    with β ≠ 0 the Boussinesq buoyancy in the predictor.

    On the card (the default, ``device=None``) the step launches the
    hand-written kernels; with ``device="cpu"`` the same wrappers run
    their plain PyTorch versions.  Without a CUDA device the default
    raises (`config.resolve_device`).

    ``poisson_solve_override``: a ``solve(x, rhs) -> PoissonResult``
    that replaces the pressure solve the method would build
    (`projection.py:69`, `:220-225`); the rest of the step is the
    iterative method's (the rhs kernel, the corrector with its maxima, the
    energy post-step, ``bc_refresh``, ``last_poisson``).  The sharded
    dispatch passes the decomposed multigrid solve (`parallel.fused_mg`).

    ``plain=True`` runs the plain versions on a CUDA device too, so
    ``chip_smoke.py`` can hold the kernel step against them and time
    both.  On the CPU both settings run the same code.  A ``dtype`` other
    than float32 (float64) always runs the plain step, on the card too:
    the reference's own dispatch, which gates only its kernels on float32
    and runs its jnp body otherwise (`projection.py:256-292`), not a
    fallback (`common.runs_plain`).

    ``differentiable=True`` maps as the reference maps it with
    ``use_pallas`` (`projection.py:124-140`): on the card (``plain=False``)
    the hybrid step — the kernels' value and the plain differentiable
    step's adjoint (`hybrid.pair_vjp`; reverse mode, w.r.t. the field and
    dt); on the CPU or with ``plain=True`` the plain differentiable step:
    the kernels' plain versions, the iterative methods' pressure solve
    swapped for its adjoint (`poisson.adjoint.make_adjoint_poisson`, one
    extra solve on the backward pass; the volume-conjugated one on the
    consistent scheme), FFT_DIRECT's chain as it is (products and Thomas
    sweeps, differentiable as they are, and the kernels' arithmetic, so
    the hybrid's value is its own); reverse- and forward-mode
    differentiable w.r.t. the field, dt and tensor-valued ``params``
    fields (μ, α, β).  A kernel step refuses ``params`` that require
    grad.
    """
    if differentiable and kernel_step(dtype, device, plain):
        # the hybrid step (`projection.py:124-140`): the kernels' value,
        # the plain differentiable step's adjoint
        common = dict(dtype=dtype, poisson_method=poisson_method,
                      poisson_params=poisson_params, device=device,
                      spectral_precision=spectral_precision,
                      bc_refresh=bc_refresh)
        return pair_vjp(
            make_projection_step(grid, params, **common),
            make_projection_step(grid, params, differentiable=True,
                                 plain=True, **common))
    device = device_of(device)
    dtype = resolve_dtype(dtype, device)
    _check_slice(grid, params, poisson_method, spectral_precision)
    # float64 (any dtype but float32) runs the plain step, on the card too
    plain = runs_plain(dtype, plain)
    if device.type == "cuda" and not plain:
        check_params(params, "projection step")
    plain = plain or differentiable
    validate_grid_for_solver(grid, grid.shape)
    if params.energy_enabled:
        validate_thermal_bc(params.thermal_bc, grid)
    device = resolve_device(device)

    with_sources = (params.source_amplitude_u != 0.0
                    or params.source_amplitude_v != 0.0)
    decay_rate = params.source_decay_rate
    amp_u, amp_v = params.source_amplitude_u, params.source_amplitude_v
    post = thermal_post_step(grid, params)
    kernel_kw = dict(with_sources=with_sources, plain=plain, params=params,
                     dtype=dtype)
    consistent = is_consistent(grid, params)
    if consistent:
        problem = NonuniformPoissonProblem.from_grid(grid)
        kernel_kw.update(stretch_consistent=(grid.dx, grid.dy, grid.x,
                                             grid.y),
                         face_coeffs=nonuniform_face_coeffs(problem),
                         device=device)
    else:
        # the parity scheme: uniform spacings from the first cell, on a
        # stretched grid too (`projection.py:151-152`,
        # `solver_projection.c:72-75`)
        problem = PoissonProblem(grid.nx, grid.ny, grid.nz, grid.dx0,
                                 grid.dy0, grid.dz0)

    def scalars(field: FlowField, dt, iter_idx):
        """(dt, su, sv, ρ) as 0-d tensors on the field's device."""
        # a fill, not a host-to-device copy (which would synchronise)
        dt = (dt.to(dtype) if torch.is_tensor(dt)
              else torch.full((), dt, dtype=dtype, device=field.device))
        decay = torch.exp((-decay_rate * iter_idx) * dt)
        rho0 = field.rho[0, 0, 0]
        rho0 = torch.where(rho0 < 1e-10, torch.ones_like(rho0), rho0)
        return dt, amp_u * decay, amp_v * decay, rho0

    def predict(pk, field, dt, su, sv, iter_idx):
        """The predictor, then the caller's hook at t_next."""
        us, vs, ws = pk.predictor(field.u, field.v, field.w, dt, su, sv,
                                  field.T)
        if bc_refresh is not None:
            us, vs, ws = bc_refresh(us, vs, ws, (iter_idx + 1) * dt)
        return us, vs, ws

    def folded_result(field, m2i, pmaxi, pabsi, **solve):
        """The kernels' maxima cover planes 1..nz−2; fold in the
        z-shells of the new ``field``."""
        u, v, w, p = field.u, field.v, field.w, field.p

        def m2_face(k):
            return torch.amax(u[k] ** 2 + v[k] ** 2 + w[k] ** 2)

        faces = (0, -1)
        m2 = torch.maximum(m2i, torch.maximum(*map(m2_face, faces)))
        pmax = torch.maximum(pmaxi, torch.maximum(
            *(torch.amax(p[k]) for k in faces)))
        pabs = torch.maximum(pabsi, torch.maximum(
            *(torch.amax(torch.abs(p[k])) for k in faces)))
        finite = torch.isfinite(m2) & torch.isfinite(pabs)
        return step_result(finite, torch.sqrt(m2), pmax,
                           torch.amax(field.T), **solve)

    step_kw = dict(scalars=scalars, predict=predict, post=post)
    method = Method(poisson_method)
    precision = _PRECISIONS.get(spectral_precision)
    pparams = poisson_params or PoissonParams()
    solve = None
    if poisson_solve_override is not None:
        # the caller's solve wins over every maker below
        solve = poisson_solve_override
    elif differentiable and method != Method.FFT_DIRECT:
        # the adjoint solve (`projection.py:237-248`, `:272-276`); the
        # direct solves below are differentiable as they are
        solve = make_adjoint_poisson(problem, pparams, method)
    elif consistent and method != Method.FFT_DIRECT:
        # the plain Krylov loops over the volume-weighted problem, as the
        # reference's jnp solve between its fused kernels
        # (`projection.py:237-248`, `:534-540`): no kernel exists for the
        # variable-coefficient passes
        solve = _CONSISTENT_KRYLOV[method](problem, pparams, dtype, device)
    elif consistent and (grid.nz == 1 or precision == "default"):
        # the direct solve through the eigenbasis: the reference's 2D jnp
        # step (`projection.py:232-236`), and its 3D step at DEFAULT,
        # which its fused consistent path does not take (`:505-507`)
        solve = make_nonuniform_direct(problem, pparams, dtype, device,
                                       precision, plain=plain)
    elif method != Method.FFT_DIRECT:
        # poisson_params as given: no factory defaults (Jacobi's are the
        # front end's), as in the reference's step
        solve = _ITERATIVE[method, grid.nz == 1](problem, pparams, dtype,
                                                 device, plain=plain)
        if solve is None:
            raise_not_coarsenable("multigrid")
    if solve is not None:
        if grid.nz == 1:
            return _make_iterative_step_2d(grid, params, solve, kernel_kw,
                                           **step_kw)
        return _make_iterative_step_3d(grid, params, solve, kernel_kw,
                                       folded_result, **step_kw)

    if precision == "default":
        # the emit-b̃ route: physical b̃ → transform pipeline → corrector
        pipeline = make_fft_btilde_solver(problem, pparams, precision,
                                          z_mode="auto", plain=plain)
        return _make_btilde_step(grid, params, pipeline, kernel_kw,
                                 folded_result, **step_kw)

    if grid.nz == 1:
        fxt, gxt, ysolve = make_dst2d_fused_pieces(
            problem, dtype, device, plain=plain, precision=precision)
        pk2 = Projection2DKernels(
            grid.ny, grid.nx, grid.dx0, grid.dy0, grid.xmin, grid.ymin,
            params.mu, (fxt, gxt), precision=precision, **kernel_kw)

        def step_2d(field: FlowField, dt, iter_idx):
            dt, su, sv, rho0 = scalars(field, dt, iter_idx)
            us, vs, ws = predict(pk2, field, dt, su, sv, iter_idx)
            bt_x = pk2.poisson_input(us, vs, field.p, rho0 / dt)
            u, v, p = pk2.corrector(us, vs, ysolve(bt_x), dt / rho0)
            # the w-correction is identically zero in 2D (inv_dz2 = 0)
            new_field = post(field.replace(u=u, v=v, w=ws, p=p), dt)
            return new_field, step_result(
                *field_status_and_diagnostics(new_field))

        return step_2d

    # HIGH takes the analytic-t back substitution, HIGHEST the stored one
    # (`projection.py:417-432`); ProjectionKernels keeps "stored" at nz = 3.
    # The consistent scheme's factors are the generalized eigenbasis
    # (`projection.py:503-521`)
    pieces = (make_nonuniform_fused_pieces if consistent
              else make_dst_fused_pieces)
    mats, tdma_fwd = pieces(problem, dtype, device)
    pk = ProjectionKernels(
        grid.nz, grid.ny, grid.nx, grid.dx0, grid.dy0, grid.dz0,
        grid.xmin, grid.ymin, params.mu, mats, tdma_fwd,
        dst_precision=precision,
        tdma_bwd="analytic" if precision == "high" else "stored",
        **kernel_kw)

    def step(field: FlowField, dt, iter_idx):
        dt, su, sv, rho0 = scalars(field, dt, iter_idx)
        us, vs, ws = predict(pk, field, dt, su, sv, iter_idx)
        d, t = pk.btilde(us, vs, ws, field.p, rho0 / dt)
        u, v, w, p, m2i, pmaxi, pabsi = pk.corrector_bwd_diag(
            us, vs, ws, d, t, dt / rho0)
        new_field = post(field.replace(u=u, v=v, w=w, p=p), dt)
        return new_field, folded_result(new_field, m2i, pmaxi, pabsi)

    return step


def _make_iterative_step_3d(grid, params, solve, kernel_kw, folded_result,
                            scalars, predict, post):
    """Predictor → hook → rhs → the iterative ``solve`` (any but
    FFT_DIRECT) warm-started from p → corrector with maxima → energy →
    z-shell face fold (`projection.py:600-621`).  ``step.poisson_solve``
    is the solve; ``step.last_poisson`` holds the last step's
    PoissonResult (0-d device tensors: iterations, residuals, status)."""
    pk = ProjectionKernels(
        grid.nz, grid.ny, grid.nx, grid.dx0, grid.dy0, grid.dz0,
        grid.xmin, grid.ymin, params.mu, emit="rhs", **kernel_kw)

    def step(field: FlowField, dt, iter_idx):
        dt, su, sv, rho0 = scalars(field, dt, iter_idx)
        us, vs, ws = predict(pk, field, dt, su, sv, iter_idx)
        rhs = pk.rhs(us, vs, ws, rho0 / dt)
        pres = step.last_poisson = solve(field.p, rhs)
        u, v, w, m2i, pmaxi, pabsi = pk.corrector_diag(us, vs, ws, pres.x,
                                                       dt / rho0)
        new_field = post(field.replace(u=u, v=v, w=w, p=pres.x), dt)
        return new_field, folded_result(
            new_field, m2i, pmaxi, pabsi, residual=pres.final_residual,
            poisson_ok=pres.status == 0)

    step.poisson_solve, step.last_poisson = solve, None
    return step


def _make_iterative_step_2d(grid, params, solve, kernel_kw, scalars,
                            predict, post):
    """Predictor → hook → rhs → the whole-solve ``solve`` (any but
    FFT_DIRECT) → corrector, w = w* → energy (`projection.py:693-708`);
    ``poisson_solve`` and ``last_poisson`` as in 3D."""
    pk2 = Projection2DKernels(
        grid.ny, grid.nx, grid.dx0, grid.dy0, grid.xmin, grid.ymin,
        params.mu, emit="rhs", **kernel_kw)

    def step(field: FlowField, dt, iter_idx):
        dt, su, sv, rho0 = scalars(field, dt, iter_idx)
        us, vs, ws = predict(pk2, field, dt, su, sv, iter_idx)
        rhs = pk2.poisson_input(us, vs, field.p, rho0 / dt)
        pres = step.last_poisson = solve(field.p, rhs)
        u, v = pk2.corrector(us, vs, pres.x, dt / rho0)
        new_field = post(field.replace(u=u, v=v, w=ws, p=pres.x), dt)
        return new_field, step_result(
            *field_status_and_diagnostics(new_field),
            residual=pres.final_residual, poisson_ok=pres.status == 0)

    step.poisson_solve, step.last_poisson = solve, None
    return step


def _make_btilde_step(grid, params, pipeline, kernel_kw, folded_result,
                      scalars, predict, post):
    """The emit-b̃ step of ``spectral_precision="default"`` (3D
    `projection.py:584-606` with ``btilde_pipeline``, 2D `:681-692`):
    predictor → hook → the physical b̃ → ``pipeline`` (the transform
    solve, no residual: a direct solve) → the corrector on the physical p
    (in 3D with its maxima and the z-shell face fold) → energy."""
    if grid.nz == 1:
        pk2 = Projection2DKernels(
            grid.ny, grid.nx, grid.dx0, grid.dy0, grid.xmin, grid.ymin,
            params.mu, **kernel_kw)

        def step_2d(field: FlowField, dt, iter_idx):
            dt, su, sv, rho0 = scalars(field, dt, iter_idx)
            us, vs, ws = predict(pk2, field, dt, su, sv, iter_idx)
            p = pipeline(pk2.poisson_input(us, vs, field.p, rho0 / dt))
            u, v = pk2.corrector(us, vs, p, dt / rho0)
            new_field = post(field.replace(u=u, v=v, w=ws, p=p), dt)
            return new_field, step_result(
                *field_status_and_diagnostics(new_field))

        return step_2d

    pk = ProjectionKernels(
        grid.nz, grid.ny, grid.nx, grid.dx0, grid.dy0, grid.dz0,
        grid.xmin, grid.ymin, params.mu, **kernel_kw)

    def step(field: FlowField, dt, iter_idx):
        dt, su, sv, rho0 = scalars(field, dt, iter_idx)
        us, vs, ws = predict(pk, field, dt, su, sv, iter_idx)
        p = pipeline(pk.btilde(us, vs, ws, field.p, rho0 / dt))
        u, v, w, m2i, pmaxi, pabsi = pk.corrector_diag(us, vs, ws, p,
                                                       dt / rho0)
        new_field = post(field.replace(u=u, v=v, w=w, p=p), dt)
        return new_field, folded_result(new_field, m2i, pmaxi, pabsi)

    return step
