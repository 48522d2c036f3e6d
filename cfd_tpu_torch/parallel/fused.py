"""The z-decomposed spectral projection step (counterpart of
`cfd_tpu/parallel/fused.py`, the uniform z-mesh FFT_DIRECT DST-fused
variant `local_step_dst`, `:524-557`, and its step wrapper, `:612-645`).

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

At "highest" every point and every mode runs the single-device kernels'
arithmetic, so the step equals the single-device kernel step; "high"
takes the 3xTF32 products with the stored Thomas solve (the
single-device HIGH step rebuilds t analytically).  Halo padding is by
concatenation (a copy of each padded field a step).  ``plain=True`` (and
any dtype but float32, `solvers.ns.common.runs_plain`) runs the same chain
on the plain versions.

Every configuration outside this slice raises ``CFDError(
ERROR_UNSUPPORTED)`` with the reference's reason or "… is not ported yet";
nothing is sent to another path.
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
from ..solvers.poisson.base import Method, PoissonProblem
from ..solvers.poisson.spectral import (dst_fused_sharded_supported,
                                        make_dst_fused_sharded_pieces)
from .mesh import Mesh, ShardedField


def _mesh_z_size(mesh: Mesh):
    """Shard count along 'z' if the mesh is z-only (other axes size 1)."""
    if "z" not in mesh.axis_names:
        return None
    if any(n != "z" and mesh.shape[n] != 1 for n in mesh.axis_names):
        return None
    return mesh.shape["z"]


def _mesh_zy_sizes(mesh: Mesh):
    """(Pz, Py) when the mesh spans only 'z' and/or 'y' axes (any other
    axis of size 1), else None; Py is 1 without a 'y' axis."""
    if "z" not in mesh.axis_names:
        return None
    if any(n not in ("z", "y") and mesh.shape[n] != 1
           for n in mesh.axis_names):
        return None
    return mesh.shape["z"], mesh.shape.get("y", 1)


def _not_ported(what: str) -> str:
    return f"{what} is not ported yet"


def fused_sharded_unsupported_reason(grid: Grid, params: NSParams,
                                     mesh: Mesh):
    """None when the ported sharded step applies, else the reason
    (`fused.py:263-322`, with the reference's texts where it has one).
    The dtype is no reason: float64 runs the same chain on the plain
    versions."""
    if params.source_func is not None:
        return _not_ported("custom source callables use the jnp path, "
                           "which")
    if is_consistent(grid, params):
        return _not_ported("the consistent-scheme fused sharded projection")
    if params.energy_enabled or params.buoyancy_enabled:
        return _not_ported("the energy equation and buoyancy on the "
                           "sharded step")
    if grid.nz <= 2:
        return _not_ported("the fused sharded 2D projection (y-only mesh)")
    sizes = _mesh_zy_sizes(mesh)
    if sizes is None:
        return ("fused sharded projection needs a mesh over ('z'[, 'y']) "
                f"axes (got axes {dict(mesh.shape)})")
    pz, py = sizes
    if grid.nz % pz != 0 or grid.nz // pz < 2:
        return (f"nz={grid.nz} must be divisible by {pz} shards with >= 2 "
                "planes per shard")
    if py > 1:
        return _not_ported("the (z, y)-mesh fused sharded projection")
    problem = PoissonProblem(grid.nx, grid.ny, grid.nz, grid.dx0, grid.dy0,
                             grid.dz0)
    if not dst_fused_sharded_supported(problem, pz):
        return _not_ported(f"the pencil-transpose DST path (ny={grid.ny} "
                           f"not divisible by {pz} shards)")
    return None


_PRECISIONS = {None: "highest", "highest": "highest", "high": "high"}


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
    here); ``spectral_precision`` None / ``"highest"`` (IEEE fp32 DST
    products) or ``"high"`` (3xTF32), the per-shard xy transforms only —
    the z solve stays fp32 and stored.  ``dtype`` defaults to float32 on
    the card; float64 and ``plain=True`` run the plain versions.
    ``poisson_params`` is accepted for the builders' common signature (the
    direct solve reads none)."""
    del poisson_params
    reason = fused_sharded_unsupported_reason(grid, params, mesh)
    if reason is not None:
        _unsupported(reason)
    method = (Method.FFT_DIRECT if poisson_method is None
              else Method(poisson_method))
    if method in (Method.CG, Method.BICGSTAB):
        _unsupported(_not_ported(f"the fused sharded {method.name} "
                                 "pressure solve"))
    if method != Method.FFT_DIRECT:
        _unsupported("fused sharded projection supports FFT_DIRECT, CG and "
                     f"BICGSTAB pressure solves (got {method})")
    if spectral_precision not in _PRECISIONS:
        _unsupported(_not_ported(f"spectral_precision="
                                 f"{spectral_precision!r} on the sharded "
                                 "step"))
    precision = _PRECISIONS[spectral_precision]
    validate_grid_for_solver(grid, grid.shape)

    comm = mesh.comm
    devices = [torch.device(d) for d in comm.devices]
    dtype = dtype or (torch.float32 if devices[0].type == "cuda"
                      else torch.get_default_dtype())
    plain = runs_plain(dtype, plain)
    nz, ny, nx = grid.shape
    P = _mesh_z_size(mesh)
    nzl = nz // P
    problem = PoissonProblem(nx, ny, nz, grid.dx0, grid.dy0, grid.dz0)
    mats, zsolve = make_dst_fused_sharded_pieces(problem, P, comm, dtype,
                                                 plain=plain)
    with_sources = (params.source_amplitude_u != 0.0
                    or params.source_amplitude_v != 0.0)
    consts = pkm.stencil_consts(nz, ny, nx, grid.dx0, grid.dy0, grid.dz0,
                                grid.xmin, grid.ymin, params.mu,
                                with_sources, params, dtype)
    if plain:
        star, b_in = pkm.predictor_star_plain, pkm.poisson_input_plain
        dot, corr = rolling.plane_dot_plain, pkm.corrector_plain
    else:
        star, b_in = pkm.predictor_star, pkm.poisson_input
        dot, corr = rolling.plane_dot, pkm.corrector

    def block(n):
        """The stencil constants of an n-plane block."""
        return dataclasses.replace(consts, nz=n)

    c_pred, c_bt = block(nzl + 4), block(nzl + 2)
    decay_rate = params.source_decay_rate
    amp_u, amp_v = params.source_amplitude_u, params.source_amplitude_v

    def pad(blocks, n):
        """Each block with ``n`` halo planes a side (zeros past the
        global ends)."""
        return [torch.cat([lo, b, hi]) for b, (lo, hi) in
                zip(blocks, comm.halo(blocks, n))]

    def shard_scalars(f, dt, iter_idx, rho0):
        dt = (dt.to(device=f.device, dtype=dtype) if torch.is_tensor(dt)
              else torch.full((), dt, dtype=dtype, device=f.device))
        decay = torch.exp((-decay_rate * iter_idx) * dt)
        rho0 = torch.where(rho0 < 1e-10, torch.ones_like(rho0), rho0)
        return dt, amp_u * decay, amp_v * decay, rho0

    def step(field: ShardedField, dt, iter_idx):
        blocks = field.blocks
        # ρ₀ is the global field's first point, on shard 0
        rho0 = comm.max([b.rho[0, 0, 0] if s == 0
                         else torch.full_like(b.rho[0, 0, 0], -torch.inf)
                         for s, b in zip(comm.shards, blocks)])
        scal = [shard_scalars(b, dt, iter_idx, r)
                for b, r in zip(blocks, rho0)]
        u2, v2, w2 = (pad([getattr(b, n) for b in blocks], 2)
                      for n in "uvw")
        stars, bhat = [], []
        for s, b, uh, vh, wh, (dts, su, sv, r0), m in zip(
                comm.shards, blocks, u2, v2, w2, scal, mats):
            z_off = s * nzl
            us, vs, ws = star(uh, vh, wh, torch.stack([dts, su, sv]),
                              c_pred, None, z_off - 2, nz)
            zero = torch.zeros_like(b.p[:1])
            p1 = torch.cat([zero, b.p, zero])  # b̃ reads owned planes
            bt = b_in(us[1:-1], vs[1:-1], ws[1:-1], p1, r0 / dts, c_bt,
                      z_off - 1, nz)
            stars.append((us, vs, ws))
            bhat.append(dot(bt[1:-1], m[0], m[1], precision))
        xhat = zsolve(bhat)
        new_blocks, maxima = [], []
        for s, b, x, (lo, hi), (us, vs, ws), (dts, _, _, r0), m in zip(
                comm.shards, blocks, xhat, comm.halo(xhat, 1), stars,
                scal, mats):
            first, last = s == 0, s == P - 1
            a = 0 if first else 1       # halo planes below the owned ones
            e = 0 if last else 1        # ... and above
            xb = torch.cat(([] if first else [lo]) + [x]
                           + ([] if last else [hi]))
            pb = dot(xb, m[2], m[3], precision)
            sl = slice(2 - a, nzl + 2 + e)
            u, v, w, m2, pmax, pabs = corr(
                us[sl], vs[sl], ws[sl], pb, dts / r0,
                block(nzl + a + e))
            own = slice(a, a + nzl)
            nb = b.replace(u=u[own], v=v[own], w=w[own], p=pb[own])
            faces = ([0] if first else []) + ([-1] if last else [])
            for k in faces:
                m2 = torch.maximum(m2, torch.amax(
                    nb.u[k] ** 2 + nb.v[k] ** 2 + nb.w[k] ** 2))
                pmax = torch.maximum(pmax, torch.amax(nb.p[k]))
                pabs = torch.maximum(pabs, torch.amax(torch.abs(nb.p[k])))
            new_blocks.append(nb)
            maxima.append(torch.stack([m2, pmax, pabs,
                                       torch.amax(nb.T)]))
        m2, pmax, pabs, tmax = comm.max(maxima)[0]
        finite = torch.isfinite(m2) & torch.isfinite(pabs)
        return (field.with_blocks(new_blocks),
                step_result(finite, torch.sqrt(m2), pmax, tmax))

    return step

