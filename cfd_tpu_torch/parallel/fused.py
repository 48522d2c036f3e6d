"""The z-, (z, y)- and, in 2D, y-decomposed projection steps (counterpart
of `cfd_tpu/parallel/fused.py`: the uniform z-mesh FFT_DIRECT DST-fused
variant `local_step_dst`, `:524-557`, the CG / BiCGSTAB variant
`local_step`, `:559-610`, and their step wrapper, `:612-645`; on a
(Pz, Py) mesh with Py > 1, `_make_fused_sharded_projection_zy_step`,
`:647-938`; on a 2D grid over a y-only mesh,
`_make_fused_sharded_projection2d_step`, `:940-1088`).

Fields are split along z over the mesh's ``'z'`` axis; x and y stay whole,
so every in-plane kernel is the single-device one.  Each shard, with
``z_off`` its first global plane and ``nzl = nz/P`` planes:

1. receives two halo planes a side of u, v, w (`comm.halo`; an edge shard
   receives zeros, `:488-512` ``hpad2``) and runs the predictor on its
   (nzl+4)-plane block in ``global_nz`` mode (`ops.kernels.
   projection_kernels.predictor_star` with ``z_base = z_off − 2``): the
   global z-shells, and the halo planes past them, pass through;
2. forms b̃ on the (nzl+2)-plane block around its owned planes
   (``poisson_input``, ``z_base = z_off − 1``: the z face term at the
   global planes 1 and nz − 2, zero global shells), which reads w* at the
   owned planes ±1 from the predictor's block without a second exchange,
   and applies the forward xy DST to its owned planes (`rolling.
   plane_dot`);
3. runs the z line solve, the only cross-shard stage: the y-pencil
   ``all_to_all``, the stored Thomas solve on its rows of the eigenvalue
   plane, the ``all_to_all`` back (`solvers.poisson.spectral.
   make_dst_fused_sharded_pieces`);
4. receives one x̂ halo plane a side in transform space (`:549-553`) and
   runs the inverse xy DST and the corrector (A5 ``corr_all``'s DST form,
   `ProjectionKernels.corrector_dst_diag`'s chain) on its owned planes
   and the halo planes that have a neighbour: an edge shard's block
   starts (or ends) at its global shell plane, so the corrector kernel's
   own z-shell passthrough is the reference's ``fix_shell`` and its
   maxima cover exactly the owned interior planes; the global shell
   planes' maxima are folded in as the single-device step folds its
   faces, and the maxima of all shards with ``comm.max``.

With ``poisson_method`` CG or BiCGSTAB the step is the reference's
per-component ``local_step``: the same predictor on the 2-halo block
(where the reference pads one plane and exchanges w* again), the rhs
(ρ/dt)∇·u* on the 1-halo block in the ``global_nz`` mode of A5's
``divergence`` (`projection_kernels.poisson_rhs`, zero global shells),
the sharded Krylov solve warm-started from p (`fused_cg`,
`fused_bicgstab`), one halo plane of the solved p a side, and the
corrector on that block as in step 4 (A5 ``corr_xy`` + ``corr_w``); the
solve's final residual is the step's residual, and a solve that did not
converge makes the status −7 (`:631-643`).

On a stretched grid under the consistent scheme (``nonuniform_scheme=
"consistent"``) the FFT_DIRECT step is the reference's eigenbasis-fused
sharded variant (`:393-439`): the same chain, each shard's stencil
constants carrying the consistent weight rows on its device and the b̃
face weights (the predictor, b̃ and corrector kernels' ``<true, false>``
instantiations in ``global_nz`` mode), the generalized eigenbasis in
place of the sines and the z solve over its eigenvalue sums
(`solvers.poisson.nonuniform.make_nonuniform_fused_sharded_pieces`).  x
and y stay whole under z decomposition, so the weight rows are the
single-device ones.  It runs on a z-only mesh and FFT_DIRECT only, as
in the reference.

At "highest" every point and every mode runs the single-device kernels'
arithmetic, so the step equals the single-device kernel step; "high"
takes the 3xTF32 products with the stored Thomas solve (the
single-device HIGH step rebuilds t analytically); "default" one TF32
pass a product in every family (the z-only xy transforms, the (z, y)
x-DSTs and dense y/z stage, the 2D x-DSTs and slab y solve), the
z-only Thomas solve fp32 and stored as at "high" — the reference's
``dst_precision=DEFAULT`` chain, not the single-device DEFAULT step's
emit-b̃ route.  Halo padding is by concatenation (a copy of each padded
field a step).  ``plain=True`` (and any dtype but float32,
`solvers.ns.common.runs_plain`) runs the same chain on the plain
versions.

On a (Pz, Py) mesh with Py > 1 (the default `mesh.make_mesh()` of 2, 4, 6
or 8 cards; Pz = 1 too) each shard owns a (nz/Pz, ny/Py, nx) block at
global plane ``z_off`` and row ``y_off``, and the step is the reference's
(z, y) step in its two variants:

1. u, v, w padded two rows a side (``comm.halo(·, 2, "y")``), then two
   planes a side of the y-padded block (the z ring carries the corners,
   the reference's ``hpad2(ypad(·))``); the predictor on that block in
   its global-row mode (``predictor_star(..., z_off − 2, nz, y_off − 2,
   ny)``): the global z- and y-shells, and the halo past them, pass
   through.  Two rows, not the reference's four (the TPU's 8-row
   sublanes): b̃ reads v* at the owned rows ± 1, whose stencil reads the
   rows ± 2;
2. FFT_DIRECT (the DST-fused variant, `:806-847`): b̃ on the owned
   window of that block (``poisson_input(..., halo=2)``: the y face term
   on the global rows 1 and ny − 2, zero global shells) into an
   owned-size block, its forward **x-only** DST (``rolling.right_dot``
   with FxT; rows are split, so only x is row-local), the y/z solve
   (`solvers.poisson.spectral.make_dst_fused_sharded_zy_pieces`: four
   per-axis ``all_to_all``s around the dense z stage and the y stage),
   x̂ padded one row, then one plane, in x-transform space, its inverse x
   DST (``right_dot`` with GxT, the mirror shells already in place) and
   the corrector on the owned window of that p block
   (``corrector_rows``: u*, v*, w* read from the predictor's block,
   global shells passed through, the maxima over every owned point,
   folded with ``comm.max``);
3. CG or BiCGSTAB (the per-component variant, `:849-905`): the rhs on
   the owned window (``poisson_rhs(..., halo=2)``), the (z, y) CG
   (`fused_cg`, its K1 and K2 in their (z, y) modes) or BiCGSTAB
   (`fused_bicgstab`, its three passes in their (z, y) modes), and the
   corrector on the solved p padded one row and one plane; the solve's
   final residual is the step's residual, a failed solve status −7.

The y/z solve's dense z stage follows the reference (not the z-only
step's Thomas solve), so the (z, y) FFT_DIRECT step equals the
single-device step to rounding, not bit for bit.

A 2D grid (nz = 1) runs on a y-only mesh: each shard owns (1, ny/P, nx)
rows at global row ``y_off``, and the step is the reference's DST-fused
2D variant, FFT_DIRECT only:

1. u, v, w padded two rows a side (``comm.halo(·, 2, "y")``; the
   reference's four, its 8-row sublane tile), the predictor on them in
   its global-row mode (``projection2d.predictor_star_2d(..., y_base=
   y_off − 2, ny_g=ny)``);
2. b̃ on the owned rows (``poisson_input_2d(..., halo=2)``: the y face
   term on the global rows 1 and ny − 2, zero global shells), its
   forward x DST (``rolling.right_dot`` with FxT);
3. the y solve (`solvers.poisson.spectral.make_dst2d_fused_sharded_
   pieces`): an ``all_to_all`` into (ny, nx/P) x-mode slabs, the dense
   y-eigen solve, the ``all_to_all`` back — where the single-device
   step runs Thomas + the dense low-mode rescue, so the two equal to
   rounding;
4. x̂ padded one row in transform space, its inverse x DST, and the
   global-row corrector on the owned rows (``corrector_2d_rows``); w is
   w* (the 2D w correction is zero, `:1050`); the maxima of each owned
   block, folded with ``comm.max``.

nx must be divisible by the shard count (the slabs); elsewhere the
reference takes its pencil fallback, which is not ported.

The energy equation and Boussinesq buoyancy (the reference's ``eT``
predictor input and its GSPMD energy step, `:532`, `:817-818`, `:1031`,
`:626-634`) run in every family.  With buoyancy the step-start T is
padded as u, v and w are (two planes and / or two rows a side, in a
persistent `thermal.HaloBuffers` buffer a shard filled in place with
``comm.fill_halo``) and read by the predictor's buoyant mode: the
predictor computes the owned planes (rows) ± 1 too, so T's halo holds
the neighbours' values there.  With the energy equation the corrector is
followed by `thermal.make_sharded_thermal_post`'s energy step and thermal
faces on the new blocks (reading the inner halo of those buffers when
there are any; its consistent stencils on the consistent scheme), and
the step's max T is the new T's; with buoyancy alone T passes through.

Every configuration outside this slice raises ``CFDError(
ERROR_UNSUPPORTED)`` with the reference's reason or "… is not ported yet"
(the consistent scheme on a (z, y) mesh or a 2D grid, or with a Krylov
or multigrid solve, with the reference's words); nothing is sent to
another path.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.grid import Grid
from ..core.status import CFDError, Status
from ..ops.kernels import projection_kernels as pkm
from ..ops.kernels import rolling
from ..solvers.ns.common import runs_plain, step_result, \
    validate_grid_for_solver
from ..solvers.ns.params import NSParams
from ..solvers.ns.projection import is_consistent
from ..solvers.poisson.base import Method, PoissonParams, PoissonProblem
from ..solvers.poisson.nonuniform import (
    NonuniformPoissonProblem, make_nonuniform_fused_sharded_pieces,
    nonuniform_face_coeffs)
from ..ops.kernels import projection2d as p2d
from ..solvers.poisson.spectral import (dst_fused_sharded_supported,
                                        dst_fused_sharded_zy_supported,
                                        make_dst2d_fused_sharded_pieces,
                                        make_dst_fused_sharded_pieces,
                                        make_dst_fused_sharded_zy_pieces)
from .fused_bicgstab import make_bicgstab_fused_sharded_local
from .fused_cg import make_cg_fused_sharded_local
from .mesh import Mesh, ShardedField, mesh_y_size, mesh_zy_sizes
from .thermal import HaloBuffers, make_sharded_thermal_post


def _not_ported(what: str) -> str:
    return f"{what} is not ported yet"


def fused_sharded_unsupported_reason(grid: Grid, params: NSParams,
                                     mesh: Mesh, poisson_method=None):
    """None when the ported sharded step applies, else the reason
    (`fused.py:263-322`, with the reference's texts where it has one).
    The dtype is no reason: float64 runs the same chain on the plain
    versions.  The y-pencil divisibility of the spectral solve applies
    to ``FFT_DIRECT`` (the default) only."""
    sizes = mesh_zy_sizes(mesh)
    zy = sizes is not None and sizes[1] > 1
    if params.source_func is not None:
        return _not_ported("custom source callables use the jnp path, "
                           "which")
    if is_consistent(grid, params):
        # the eigenbasis-fused step runs on a z-only mesh, where x and y
        # are whole (`fused.py:272-283`)
        if grid.nz <= 2:
            return ("no fused sharded 2D consistent-scheme projection "
                    "(the 2D marching kernels are uniform-only)")
        if zy:
            return ("consistent-scheme fused sharded projection needs a "
                    "z-only mesh")
    method = (Method.FFT_DIRECT if poisson_method is None
              else Method(poisson_method))
    if grid.nz <= 2:
        n = mesh_y_size(mesh)
        if n is None:
            return ("fused sharded 2D projection needs a y-only mesh "
                    f"(got axes {dict(mesh.shape)})")
        if grid.ny % n != 0 or grid.ny // n < 2:
            return (f"ny={grid.ny} must be divisible by {n} shards with "
                    ">= 2 rows per shard")
        if method != Method.FFT_DIRECT:
            return (f"no fused sharded 2D {method.name} pressure solve "
                    "(FFT_DIRECT only)")
        if grid.nx % n != 0:
            return _not_ported(f"the 2D pencil DST path (nx={grid.nx} not "
                               f"divisible by {n} shards)")
        return None
    if sizes is None:
        return ("fused sharded projection needs a mesh over ('z'[, 'y']) "
                f"axes (got axes {dict(mesh.shape)})")
    pz, py = sizes
    if grid.nz % pz != 0 or grid.nz // pz < 2:
        return (f"nz={grid.nz} must be divisible by {pz} shards with >= 2 "
                "planes per shard")
    if py > 1:
        if "y" in mesh.axis_names and (mesh.axis_names.index("y")
                                       < mesh.axis_names.index("z")):
            return _not_ported("a mesh with its 'y' axis before 'z'")
        if grid.ny % py != 0 or grid.ny // py < 2:
            return (f"ny={grid.ny} must be divisible by {py} y-shards with "
                    ">= 2 rows per shard")
        if method != Method.FFT_DIRECT:
            return None
        problem = PoissonProblem(grid.nx, grid.ny, grid.nz, grid.dx0,
                                 grid.dy0, grid.dz0)
        if not dst_fused_sharded_zy_supported(problem, pz, py):
            return _not_ported(f"the two-axis pencil DST path (nx={grid.nx} "
                               f"not divisible by {pz} z-shards)")
        return None
    if method in (Method.CG, Method.BICGSTAB):
        return None
    problem = PoissonProblem(grid.nx, grid.ny, grid.nz, grid.dx0, grid.dy0,
                             grid.dz0)
    if not dst_fused_sharded_supported(problem, pz):
        return _not_ported(f"the pencil-transpose DST path (ny={grid.ny} "
                           f"not divisible by {pz} shards)")
    return None


_PRECISIONS = {None: "highest", "highest": "highest", "high": "high",
               "default": "default"}


def _unsupported(reason: str):
    raise CFDError(Status.ERROR_UNSUPPORTED,
                   f"fused sharded projection unsupported: {reason}")


def make_fused_sharded_projection_step(grid: Grid, params: NSParams,
                                       mesh: Mesh, dtype=None,
                                       poisson_params=None,
                                       poisson_method=None,
                                       spectral_precision=None,
                                       plain: bool = False):
    """Build ``step(field, dt, iter_idx) -> (field, StepResult)`` on a
    `mesh.ShardedField` z-sharded over ``mesh`` (`fused.py:325-645`).

    ``poisson_method`` None or ``FFT_DIRECT`` (the reference's default
    here): the DST-fused step, on the consistent scheme the
    eigenbasis-fused one (z-only mesh); ``spectral_precision`` None /
    ``"highest"`` (IEEE fp32 products), ``"high"`` (3xTF32) or
    ``"default"`` (one TF32 pass), the transform products only — the
    z-only Thomas solve stays fp32 and stored; another name raises.
    ``CG`` or ``BICGSTAB``: the per-component step (`fused.py:559-610`)
    with the sharded Krylov solve (`fused_cg`, `fused_bicgstab`) on
    ``poisson_params`` (default ``PoissonParams()``); a failed solve
    gives status −7 and its final residual is the step's ``residual``;
    ``step.last_poisson`` holds the first local shard's result of the
    last solve.
    ``dtype`` defaults to float32 on the card; float64 and
    ``plain=True`` run the plain versions.  ``params`` may carry the
    energy equation and buoyancy (a heat source, energy on a stretched
    grid in the parity scheme and a thermal face the energy step has no
    rule for raise, the last ``ERROR_INVALID``)."""
    reason = fused_sharded_unsupported_reason(grid, params, mesh,
                                              poisson_method)
    if reason is not None:
        _unsupported(reason)
    method = (Method.FFT_DIRECT if poisson_method is None
              else Method(poisson_method))
    consistent = is_consistent(grid, params)
    if consistent and method != Method.FFT_DIRECT:
        # no kernel evaluates the variable-coefficient Krylov passes
        # (`fused.py:414-417`)
        _unsupported("consistent-scheme fused sharded projection supports "
                     f"the FFT_DIRECT pressure solve only (got "
                     f"{method.name})")
    if method not in (Method.FFT_DIRECT, Method.CG, Method.BICGSTAB):
        _unsupported("fused sharded projection supports FFT_DIRECT, CG and "
                     f"BICGSTAB pressure solves (got {method.name})")
    if spectral_precision not in _PRECISIONS:
        _unsupported(f"unknown spectral_precision={spectral_precision!r} "
                     f"(one of {sorted(k for k in _PRECISIONS if k)})")
    validate_grid_for_solver(grid, grid.shape)

    comm = mesh.comm
    devices = [torch.device(d) for d in comm.devices]
    dtype = dtype or (torch.float32 if devices[0].type == "cuda"
                      else torch.get_default_dtype())
    plain = runs_plain(dtype, plain)
    nz, ny, nx = grid.shape
    problem = PoissonProblem(nx, ny, nz, grid.dx0, grid.dy0, grid.dz0)
    with_sources = (params.source_amplitude_u != 0.0
                    or params.source_amplitude_v != 0.0)

    def stencil_consts(weights=None, face=None):
        return pkm.stencil_consts(nz, ny, nx, grid.dx0, grid.dy0, grid.dz0,
                                  grid.xmin, grid.ymin, params.mu,
                                  with_sources, params, dtype, weights, face)

    consts = stencil_consts()
    precision = _PRECISIONS[spectral_precision]
    thermal = _Thermal(grid, params, comm, consts, dtype)
    if nz == 1:
        return _make_2d_step(problem, params, mesh, consts, dtype, precision,
                             plain, thermal)
    P, py = mesh_zy_sizes(mesh)
    if py > 1:
        return _make_zy_step(problem, params, mesh, consts, dtype, method,
                             poisson_params, precision, plain, thermal)
    nzl = nz // P
    # each local shard's stencil constants: on the consistent scheme with
    # its device's weight rows and the b̃ face weights (x and y are whole,
    # so every shard reads the single-device rows)
    shard_consts = [consts] * len(devices)
    pieces = make_dst_fused_sharded_pieces
    if consistent:
        problem = NonuniformPoissonProblem.from_grid(grid)
        face = nonuniform_face_coeffs(problem)
        on = {}
        for d in devices:
            if d not in on:
                on[d] = stencil_consts(pkm.consistent_weights(
                    grid.dx, grid.dy, grid.x, grid.y, dtype, d), face)
        shard_consts = [on[d] for d in devices]
        pieces = make_nonuniform_fused_sharded_pieces
    if method == Method.FFT_DIRECT:
        mats, zsolve = pieces(problem, P, comm, dtype, plain=plain)
        pressure = None
    else:
        maker = (make_cg_fused_sharded_local if method == Method.CG
                 else make_bicgstab_fused_sharded_local)
        pressure = maker(problem, poisson_params or PoissonParams(), comm,
                         dtype, plain=plain)
    if plain:
        star, b_in = pkm.predictor_star_plain, pkm.poisson_input_plain
        rhs_of = pkm.poisson_rhs_plain
        dot, corr = rolling.plane_dot_plain, pkm.corrector_plain
    else:
        star, b_in = pkm.predictor_star, pkm.poisson_input
        rhs_of = pkm.poisson_rhs
        dot, corr = rolling.plane_dot, pkm.corrector

    def block(c, n):
        """The stencil constants ``c`` of an n-plane block."""
        return dataclasses.replace(c, nz=n)

    c_pred = [block(c, nzl + 4) for c in shard_consts]
    c_bt = [block(c, nzl + 2) for c in shard_consts]
    scalars = _step_scalars(params, comm, dtype)

    def pad(blocks, n):
        """Each block with ``n`` halo planes a side (zeros past the
        global ends)."""
        return [torch.cat([lo, b, hi]) for b, (lo, hi) in
                zip(blocks, comm.halo(blocks, n))]

    def predict(field, dt, iter_idx):
        """The shards' step scalars and their predictor blocks (the 2-halo
        block: w* at the owned planes ± 1 without a second exchange)."""
        blocks = field.blocks
        scal = scalars(blocks, dt, iter_idx)
        u2, v2, w2 = (pad([getattr(b, n) for b in blocks], 2)
                      for n in "uvw")
        stars = [star(uh, vh, wh, torch.stack([dts, su, sv]), c, th,
                      s * nzl - 2, nz)
                 for s, uh, vh, wh, th, (dts, su, sv, _), c in zip(
                     comm.shards, u2, v2, w2, thermal.fill(blocks), scal,
                     c_pred)]
        return scal, stars

    def halo_block(blocks, halos):
        """Each shard's owned planes with a halo plane on each side that
        has a neighbour: an edge shard's block starts (ends) at its global
        shell plane."""
        return [torch.cat(([] if s == 0 else [lo]) + [b]
                          + ([] if s == P - 1 else [hi]))
                for s, b, (lo, hi) in zip(comm.shards, blocks, halos)]

    def correct(field, pbs, stars, scal, residual=None, ok=None):
        """The corrector on each shard's 1-halo block of the pressure
        (``pbs``, :func:`halo_block`'s, in physical space), the maxima
        folded over the shards, the energy post-step, the new field and
        its StepResult."""
        new_blocks, maxima = [], []
        for s, b, pb, (us, vs, ws), (dts, _, _, r0), c in zip(
                comm.shards, field.blocks, pbs, stars, scal, shard_consts):
            first, last = s == 0, s == P - 1
            a = 0 if first else 1       # halo planes below the owned ones
            e = 0 if last else 1        # ... and above
            sl = slice(2 - a, nzl + 2 + e)
            u, v, w, m2, pmax, pabs = corr(
                us[sl], vs[sl], ws[sl], pb, dts / r0, block(c, nzl + a + e))
            own = slice(a, a + nzl)
            nb = b.replace(u=u[own], v=v[own], w=w[own], p=pb[own])
            faces = ([0] if first else []) + ([-1] if last else [])
            for k in faces:
                m2 = torch.maximum(m2, torch.amax(
                    nb.u[k] ** 2 + nb.v[k] ** 2 + nb.w[k] ** 2))
                pmax = torch.maximum(pmax, torch.amax(nb.p[k]))
                pabs = torch.maximum(pabs, torch.amax(torch.abs(nb.p[k])))
            new_blocks.append(nb)
            maxima.append((m2, pmax, pabs))
        return _fold(field, *thermal.post(new_blocks, maxima, scal), comm,
                     residual, ok)

    def step_dst(field: ShardedField, dt, iter_idx):
        scal, stars = predict(field, dt, iter_idx)
        bhat = []
        for s, b, (us, vs, ws), (dts, _, _, r0), m, c in zip(
                comm.shards, field.blocks, stars, scal, mats, c_bt):
            zero = torch.zeros_like(b.p[:1])
            p1 = torch.cat([zero, b.p, zero])  # b̃ reads owned planes
            bt = b_in(us[1:-1], vs[1:-1], ws[1:-1], p1, r0 / dts, c,
                      s * nzl - 1, nz)
            bhat.append(dot(bt[1:-1], m[0], m[1], precision))
        xhat = zsolve(bhat)
        # the inverse DST of each shard's 1-halo x̂ block, then the
        # corrector on it
        pbs = [dot(xb, m[2], m[3], precision) for xb, m in zip(
            halo_block(xhat, comm.halo(xhat, 1)), mats)]
        return correct(field, pbs, stars, scal)

    def step_krylov(field: ShardedField, dt, iter_idx):
        scal, stars = predict(field, dt, iter_idx)
        rhs = [rhs_of(us[1:-1], vs[1:-1], ws[1:-1], r0 / dts, c,
                      s * nzl - 1, nz)[1:-1]
               for s, (us, vs, ws), (dts, _, _, r0), c in zip(
                   comm.shards, stars, scal, c_bt)]
        res = pressure([b.p for b in field.blocks], rhs)
        step_krylov.last_poisson = res[0]
        ps = [r.x for r in res]
        return correct(field, halo_block(ps, comm.halo(ps, 1)), stars, scal,
                       res[0].final_residual, res[0].status == 0)

    return step_dst if pressure is None else step_krylov


def _step_scalars(params: NSParams, comm, dtype):
    """``scalars(blocks, dt, iter_idx)``: each local shard's (dt, su, sv,
    ρ₀) on its device — ρ₀ the global field's first point, on shard 0,
    replicated with ``comm.max`` (1 where it is below 1e-10), the source
    amplitudes with their decay (`fused.py:612-645`)."""
    decay_rate = params.source_decay_rate
    amp_u, amp_v = params.source_amplitude_u, params.source_amplitude_v

    def shard_scalars(f, dt, iter_idx, rho0):
        dt = (dt.to(device=f.device, dtype=dtype) if torch.is_tensor(dt)
              else torch.full((), dt, dtype=dtype, device=f.device))
        decay = torch.exp((-decay_rate * iter_idx) * dt)
        rho0 = torch.where(rho0 < 1e-10, torch.ones_like(rho0), rho0)
        return dt, amp_u * decay, amp_v * decay, rho0

    def scalars(blocks, dt, iter_idx):
        rho0 = comm.max([b.rho[0, 0, 0] if s == 0
                         else torch.full_like(b.rho[0, 0, 0], -torch.inf)
                         for s, b in zip(comm.shards, blocks)])
        return [shard_scalars(b, dt, iter_idx, r)
                for b, r in zip(blocks, rho0)]

    return scalars


class _Thermal:
    """The step's temperature: T padded like u, v and w for the buoyant
    predictor (a persistent `thermal.HaloBuffers` of two halos a side,
    filled once a step), and the energy post-step on the new blocks
    (`thermal.make_sharded_thermal_post`, which reads the inner halo of
    those buffers when there are any).  Without buoyancy the predictor
    gets no T; without the energy equation T passes through."""

    def __init__(self, grid: Grid, params: NSParams, comm, consts, dtype):
        self.energy = make_sharded_thermal_post(grid, params, comm, dtype)
        self.temps = None
        if consts.buoyancy is not None:
            pz, py = comm.shape
            owned = (grid.nz // pz, grid.ny // py, grid.nx)
            self.temps = HaloBuffers(comm, owned, 2, dtype)

    def fill(self, blocks):
        """Each shard's T for the predictor: its 2-halo buffer with
        buoyancy, else None."""
        if self.temps is None:
            return [None] * len(blocks)
        return self.temps.fill([b.T for b in blocks])

    def post(self, blocks, maxima, scal):
        """The new blocks with the energy post-step's T, and each shard's
        maxima (max|u|², max p, max|p|) stacked with the max of its new
        T."""
        if self.energy is None:
            tmax = [torch.amax(b.T) for b in blocks]
        else:
            ts, tmax = self.energy(blocks, [d for d, *_ in scal],
                                   self.temps)
            blocks = [b.replace(T=t) for b, t in zip(blocks, ts)]
        return blocks, [torch.stack([*m, t]) for m, t in zip(maxima, tmax)]


def _fold(field: ShardedField, new_blocks, maxima, comm, residual=None,
          ok=None):
    """The new field and its StepResult: the shards' maxima (each a
    stacked max|u|², max p, max|p|, max T) folded with ``comm.max``."""
    m2, pmax, pabs, tmax = comm.max(maxima)[0]
    finite = torch.isfinite(m2) & torch.isfinite(pabs)
    return (field.with_blocks(new_blocks),
            step_result(finite, torch.sqrt(m2), pmax, tmax, residual, ok))


def _make_zy_step(problem: PoissonProblem, params: NSParams, mesh: Mesh,
                  consts, dtype, method, poisson_params, precision: str,
                  plain: bool, thermal: _Thermal):
    """The step on a (Pz, Py) mesh with Py > 1 (`fused.py:647-938`): the
    FFT_DIRECT DST-fused variant or the CG per-component one, as the
    module's docstring sets out."""
    comm = mesh.comm
    pz, py = comm.shape
    nz, ny, nx = problem.nz, problem.ny, problem.nx
    nzl, nyl = nz // pz, ny // py
    halo = 2                    # the predictor block's planes and rows
    offs = [(zi * nzl, yi * nyl) for zi, yi in map(comm.coords,
                                                     comm.shards)]
    c_pred = dataclasses.replace(consts, nz=nzl + 2 * halo,
                                 ny=nyl + 2 * halo)
    c_p = dataclasses.replace(consts, nz=nzl + 2, ny=nyl + 2)
    if method == Method.FFT_DIRECT:
        mats, yzsolve = make_dst_fused_sharded_zy_pieces(
            problem, pz, py, comm, dtype, precision, plain)
        pressure = None
    else:
        maker = (make_cg_fused_sharded_local if method == Method.CG
                 else make_bicgstab_fused_sharded_local)
        pressure = maker(problem, poisson_params or PoissonParams(), comm,
                         dtype, plain=plain)
    if plain:
        star, b_in = pkm.predictor_star_plain, pkm.poisson_input_plain
        rhs_of, corr = pkm.poisson_rhs_plain, pkm.corrector_rows_plain
        right_dot = rolling.right_dot_plain
    else:
        star, b_in = pkm.predictor_star, pkm.poisson_input
        rhs_of, corr = pkm.poisson_rhs, pkm.corrector_rows
        right_dot = rolling.right_dot
    scalars = _step_scalars(params, comm, dtype)

    def pad(blocks, n):
        """Each block with ``n`` halo rows, then ``n`` halo planes, a side
        (zeros past the global ends; the corners from the diagonal shard
        in two hops)."""
        ys = [torch.cat([lo, b, hi], 1) for b, (lo, hi) in
              zip(blocks, comm.halo(blocks, n, "y"))]
        return [torch.cat([lo, b, hi]) for b, (lo, hi) in
                zip(ys, comm.halo(ys, n, "z"))]

    def predict(field, dt, iter_idx):
        blocks = field.blocks
        scal = scalars(blocks, dt, iter_idx)
        u2, v2, w2 = (pad([getattr(b, n) for b in blocks], halo)
                      for n in "uvw")
        stars = [star(uh, vh, wh, torch.stack([dts, su, sv]), c_pred, th,
                      z - halo, nz, y - halo, ny)
                 for (z, y), uh, vh, wh, th, (dts, su, sv, _) in zip(
                     offs, u2, v2, w2, thermal.fill(blocks), scal)]
        return scal, stars

    def correct(field, pbs, stars, scal, residual=None, ok=None):
        """The corrector on the owned window of each shard's p block
        padded one row and one plane (``pbs``, physical space), then the
        energy post-step."""
        new_blocks, maxima = [], []
        for (z, y), b, pb, (us, vs, ws), (dts, _, _, r0) in zip(
                offs, field.blocks, pbs, stars, scal):
            u, v, w, p, m2, pmax, pabs = corr(us, vs, ws, pb, dts / r0, c_p,
                                              z - 1, nz, y - 1, ny)
            new_blocks.append(b.replace(u=u, v=v, w=w, p=p))
            maxima.append((m2, pmax, pabs))
        return _fold(field, *thermal.post(new_blocks, maxima, scal), comm,
                     residual, ok)

    def step_dst(field: ShardedField, dt, iter_idx):
        scal, stars = predict(field, dt, iter_idx)
        xt = [right_dot(b_in(us, vs, ws, b.p, r0 / dts, c_pred, z - halo,
                             nz, y - halo, ny, halo), m[0], precision)
              for (z, y), b, (us, vs, ws), (dts, _, _, r0), m in zip(
                  offs, field.blocks, stars, scal, mats)]
        xhat = yzsolve(xt)
        # x̂ padded in transform space (the y/z solve placed the global
        # mirror shells), its inverse x DST, then the corrector
        pbs = [right_dot(xb, m[1], precision)
               for xb, m in zip(pad(xhat, 1), mats)]
        return correct(field, pbs, stars, scal)

    def step_krylov(field: ShardedField, dt, iter_idx):
        scal, stars = predict(field, dt, iter_idx)
        rhs = [rhs_of(us, vs, ws, r0 / dts, c_pred, z - halo, nz, y - halo,
                      ny, halo)
               for (z, y), (us, vs, ws), (dts, _, _, r0) in zip(
                   offs, stars, scal)]
        res = pressure([b.p for b in field.blocks], rhs)
        step_krylov.last_poisson = res[0]
        return correct(field, pad([r.x for r in res], 1), stars, scal,
                       res[0].final_residual, res[0].status == 0)

    return step_dst if pressure is None else step_krylov


def _make_2d_step(problem: PoissonProblem, params: NSParams, mesh: Mesh,
                  consts, dtype, precision: str, plain: bool,
                  thermal: _Thermal):
    """The y-decomposed 2D step (`fused.py:940-1088`), as the module's
    docstring sets out: FFT_DIRECT, its DST-fused variant, on the
    global-row modes of the 2D kernels."""
    comm = mesh.comm
    P = comm.shape[1]
    ny, nx = problem.ny, problem.nx
    nyl = ny // P
    halo = 2                    # the predictor block's rows
    offs = [comm.coords(s)[1] * nyl for s in comm.shards]
    c_pred = dataclasses.replace(consts, ny=nyl + 2 * halo)
    c_p = dataclasses.replace(consts, ny=nyl + 2)
    mats, ysolve = make_dst2d_fused_sharded_pieces(problem, P, comm, dtype,
                                                   precision, plain)
    if plain:
        star, b_in = pkm.predictor_star_plain, p2d.poisson_input_2d_plain
        corr = p2d.corrector_2d_rows_plain
        right_dot = rolling.right_dot_plain
    else:
        star, b_in = p2d.predictor_star_2d, p2d.poisson_input_2d
        corr, right_dot = p2d.corrector_2d_rows, rolling.right_dot
    scalars = _step_scalars(params, comm, dtype)

    def pad(blocks, n):
        """Each (1, nyl, nx) block with ``n`` halo rows a side (zeros
        past the global ends)."""
        return [torch.cat([lo, b, hi], 1) for b, (lo, hi) in
                zip(blocks, comm.halo(blocks, n, "y"))]

    def step(field: ShardedField, dt, iter_idx):
        blocks = field.blocks
        scal = scalars(blocks, dt, iter_idx)
        u2, v2, w2 = (pad([getattr(b, n) for b in blocks], halo)
                      for n in "uvw")
        stars = [star(uh, vh, wh, torch.stack([dts, su, sv]), c_pred,
                      T=th, y_base=y - halo, ny_g=ny)
                 for y, uh, vh, wh, th, (dts, su, sv, _) in zip(
                     offs, u2, v2, w2, thermal.fill(blocks), scal)]
        # b̃ on the owned rows, its forward x DST, the y solve
        xhat = ysolve([right_dot(b_in(us, vs, b.p, r0 / dts, c_pred,
                                      y - halo, ny, halo), m[0], precision)
                       for y, b, (us, vs, _), (dts, _, _, r0), m in zip(
                           offs, blocks, stars, scal, mats)])
        # x̂ padded one row in transform space (the y solve placed the
        # global mirror shells), its inverse x DST, then the corrector
        new_blocks, maxima = [], []
        for y, b, xb, (us, vs, ws), (dts, _, _, r0), m in zip(
                offs, blocks, pad(xhat, 1), stars, scal, mats):
            u, v, p = corr(us, vs, right_dot(xb, m[1], precision), dts / r0,
                           c_p, y - 1, ny)
            # the w-correction is identically zero in 2D (inv_dz2 = 0)
            w = ws[:, halo:halo + nyl]
            new_blocks.append(b.replace(u=u, v=v, w=w, p=p))
            maxima.append((torch.amax(u ** 2 + v ** 2 + w ** 2),
                           torch.amax(p), torch.amax(torch.abs(p))))
        return _fold(field, *thermal.post(new_blocks, maxima, scal), comm)

    return step
