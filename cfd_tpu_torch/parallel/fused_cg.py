"""The z- and (z, y)-decomposed CG pressure solve (counterpart of
`cfd_tpu/parallel/fused_cg.py:45-282`).

The rotated PCG recursion of the one-device fused CG
(`solvers.poisson.krylov.make_cg_fused`), breakdown rules and status
included, over fields z-decomposed across the communicator's shards
(`parallel.comm`): every shard holds an owned block of ``nzl = nz/P``
planes, and each iteration is

1. K1 in its sharded mode on the shard's halo-padded r and p
   (`ops.kernels.cg_kernels.ShardCGPasses.lap_dot`, the TPU kernel
   ``make_lap_dot_sharded``): p′ = scale·r + β·p in the *global*
   Dirichlet-0 space, so the halo planes carry the neighbour shard's p′,
   Ap′ zero at the global shells, and the shard's share of ⟨p′, Ap′⟩;
2. ``comm.sum`` of the shares (the reference's ``lax.psum``) and the α
   recurrence on the sum;
3. K2 on the owned block (every owned plane but the global shells) and
   the shard's share of ⟨r, r⟩; ``comm.sum``; the rest of the recurrence;
4. the halo planes of r and of the new p′ from the neighbours.

r and p (and p′) live in persistent ``(nzl + 2)``-plane buffers whose
halo planes alone are copied each iteration (``comm.fill_halo``); an
edge shard's outer halo planes stay zero, outside the global space.  p′
goes to a second buffer (the threads of K1 recompute p′ at k ± 1 from p,
so p′ cannot overwrite p) and the two swap each iteration.

As in the one-device loop the scalars stay on the device (every shard
keeps its own copy of the state, updated by the same recurrence on the
same sums), the host queues ``krylov.CHUNK`` iterations and reads the
running flag of the chunk before, and iterations past the stop are
no-ops.  Neumann faces are applied to x at the start and the end, the z
faces on the edge shards only; the initial residual comes from one x
halo exchange and the plain Laplacian, as the reference's jnp.  The
Jacobi preconditioner is the constant ``inv_factor``;
``Precond.MULTIGRID`` is refused, the reference's outcome (its local
body returns None: "kernel build failed").  float32 on the card launches
the kernels; the CPU, float64 and ``plain=True`` run the plain versions
in the same loop (the reference's float32 gate is dropped: its jnp
fallback is the plain chain here).

On a (Pz, Py) mesh with Py > 1 (`fused_cg.py:113-170`) each shard owns a
(nz/Pz, ny/Py, nx) block and every buffer — x and Ap′ too — is that block
padded one plane and one row a side: the y rows are filled first, then
the z planes (which carry the y-halo rows, the reference's
``hpad(ypad(·))``); K1 and K2 run their (z, y) modes on the padded
buffers (``ShardCGPasses(..., y_off, ny_g)``: the global Dirichlet-0
space at global planes and rows, the dots over the owned points); the
Neumann faces go x, then the global y rows on the edge y-shards, then
the global z faces on the edge z-shards.
"""

from __future__ import annotations

import torch

from ..core.status import CFDError, Status
from ..ops import stencils
from ..ops.kernels import cg_kernels as cgk
from ..solvers.poisson.base import (PoissonParams, PoissonProblem,
                                    PoissonResult, Precond)
from ..solvers.poisson.krylov import _result, run_chunked
from .mesh import Mesh, mesh_zy_sizes


def cg_fused_sharded_unsupported_reason(problem: PoissonProblem,
                                        n_shards: int, dtype=None,
                                        py: int = 1):
    """None when the sharded CG applies over ``n_shards`` z-shards (and
    ``py`` y-shards), else the reason (`fused_cg.py:45-73`, the TPU's
    ``nx % 128`` / VMEM gates left out).  The dtype is no reason: float64
    runs the plain chain."""
    del dtype
    nz, ny = problem.nz, problem.ny
    if nz <= 2:
        return "fused sharded CG is 3D-only"
    if nz % n_shards != 0 or nz // n_shards < 2:
        return (f"nz={nz} must be divisible by {n_shards} shards with >= 2 "
                "planes per shard")
    if py > 1 and (ny % py != 0 or ny // py < 2):
        return (f"ny={ny} must be divisible by {py} y-shards with >= 2 "
                "rows per shard")
    return None


def neumann_shard(a, first: bool, last: bool, first_y: bool = True,
                  last_y: bool = True):
    """`apply_neumann_scalar` on a shard's owned block: x faces, the y
    faces of the global domain (on the edge y-shards only), then its z
    faces (on the edge z-shards only), a new tensor
    (`fused_cg.py:156-170`)."""
    a = a.clone()
    a[:, :, 0] = a[:, :, 1]
    a[:, :, -1] = a[:, :, -2]
    if first_y:
        a[:, 0, :] = a[:, 1, :]
    if last_y:
        a[:, -1, :] = a[:, -2, :]
    if first:
        a[0] = a[1]
    if last:
        a[-1] = a[-2]
    return a


def initial_residual(problem: PoissonProblem, comm, xs, rhss, z_offs,
                     y_offs=None):
    """Each shard's r = ∇²x − rhs on the global interior of its owned
    block, zero elsewhere (`fused_cg.py:198-201`): one x halo exchange
    (with ``y_offs``, the shards' first global rows, a y exchange first)
    and the plain Laplacian."""
    if y_offs is not None:
        xs_y = [torch.cat([lo, x, hi], 1) for x, (lo, hi) in
                zip(xs, comm.halo(xs, 1, "y"))]
    else:
        xs_y, y_offs = xs, [None] * len(xs)
    rs = []
    for x, xy, rhs, (lo, hi), z_off, y_off in zip(
            xs, xs_y, rhss, comm.halo(xs_y, 1), z_offs, y_offs):
        xh = torch.cat([lo, xy, hi])
        lap = stencils.laplacian(xh, problem.inv_dx2, problem.inv_dy2,
                                 problem.inv_dz2)
        r = torch.zeros_like(x)
        if y_off is None:
            mask = stencils.global_interior_mask(x.shape, z_off, problem.nz,
                                                 x.device)
            r[:, 1:-1, 1:-1] = torch.where(
                mask[:, 1:-1, 1:-1], lap - rhs[:, 1:-1, 1:-1], 0.0)
        else:
            mask = stencils.global_interior_mask(x.shape, z_off, problem.nz,
                                                 x.device, y_off, problem.ny)
            r[:, :, 1:-1] = torch.where(mask[:, :, 1:-1],
                                        lap - rhs[:, :, 1:-1], 0.0)
        rs.append(r)
    return rs


def padded(rs, rows: bool = False):
    """Each owned block in a new buffer with one zero halo plane a side
    (and with ``rows`` one zero halo row a side)."""
    h = 1 if rows else 0
    out = []
    for r in rs:
        b = r.new_zeros((r.shape[0] + 2, r.shape[1] + 2 * h)
                        + tuple(r.shape[2:]))
        b[1:-1, h:b.shape[1] - h] = r
        out.append(b)
    return out


def fill_halos(comm, bufs, rows: bool):
    """The halo rows (with ``rows``), then the halo planes, of each
    shard's buffer from its neighbours."""
    if rows:
        comm.fill_halo(bufs, 1, "y")
    comm.fill_halo(bufs, 1, "z")


def _unsupported(what: str, reason: str):
    raise CFDError(Status.ERROR_UNSUPPORTED, f"{what} unsupported: {reason}")


def make_cg_fused_sharded_local(problem: PoissonProblem,
                                params: PoissonParams, comm, dtype=None,
                                plain: bool = False):
    """The shard-local solve (`fused_cg.py:76-252`):
    ``local_solve(xs, rhss) -> [PoissonResult]``, one owned block of x
    and of rhs per local shard of ``comm`` in, one result per local shard
    out (its x block and the shared scalars on its device); ``dtype`` is
    the fields' own (accepted for the makers' common signature).  The
    sharded projection step calls it inline; :func:`make_cg_fused_sharded`
    wraps it for whole fields.  ``local_solve.host_syncs`` counts the last
    solve's reads of the running flag.  Raises ``ERROR_UNSUPPORTED``
    where the reference's local body returns None."""
    pz, py = comm.shape
    reason = cg_fused_sharded_unsupported_reason(problem, pz, py=py)
    if reason is not None:
        _unsupported("fused sharded CG", reason)
    if params.preconditioner == Precond.MULTIGRID:
        _unsupported("fused sharded CG", "CG kernel build failed (the "
                     "multigrid preconditioner has no sharded form)")
    nz, ny, nx = problem.shape
    nzl, nyl = nz // pz, ny // py
    rows = py > 1
    scale = (problem.inv_factor
             if params.preconditioner == Precond.JACOBI else 1.0)
    consts = cgk.CGConsts(nzl, nyl, nx, problem.inv_dx2, problem.inv_dy2,
                          problem.inv_dz2, scale, params.check_interval)
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance
    coords = [comm.coords(s) for s in comm.shards]
    z_offs = [zi * nzl for zi, _ in coords]
    y_offs = [yi * nyl for _, yi in coords] if rows else None
    # the owned block's edges at the global faces: (z first, z last,
    # y first, y last)
    edges = [(zi == 0, zi == pz - 1, yi == 0, yi == py - 1)
             for zi, yi in coords]

    def own(b):
        """A padded buffer's owned block (a view)."""
        return b[1:-1, 1:-1] if rows else b[1:-1]

    def local_solve(xs, rhss):
        on_plain = plain or xs[0].dtype != torch.float32
        ops = [cgk.ShardCGPasses(consts, z, nz, x.device, plain=on_plain,
                                 y_off=y, ny_g=ny if rows else None)
               for z, y, x in zip(z_offs, y_offs or [0] * len(xs), xs)]
        xs = [neumann_shard(x, *e)     # the solver's own
              for x, e in zip(xs, edges)]
        rs = initial_residual(problem, comm, xs, rhss, z_offs, y_offs)
        rr0 = comm.sum([torch.sum(r * r) for r in rs])
        init_res = [torch.sqrt(v) for v in rr0]
        tol = [problem.tolerance_for(params, v) for v in init_res]
        already = [v < abs_tol for v in init_res]
        sts = [cgk.new_state(scale * v, ir, t,
                             torch.full((), abs_tol, dtype=v.dtype,
                                        device=v.device), ~a)
               for v, ir, t, a in zip(rr0, init_res, tol, already)]
        r_pad = padded(rs, rows)
        fill_halos(comm, r_pad, rows)
        p_pad = [torch.zeros_like(r) for r in r_pad]
        pn_pad = [torch.zeros_like(r) for r in r_pad]
        if rows:
            # the (z, y) passes take padded buffers only: x and Ap′ too
            xw, ap = padded(xs, True), [torch.zeros_like(r) for r in r_pad]

            def view(b):
                return b
        else:
            xw, ap = xs, [torch.empty_like(x) for x in xs]
            view = own

        def iteration():
            nonlocal p_pad, pn_pad
            shares = [op.lap_dot(r, p, view(pn), a, st) for op, r, p, pn,
                      a, st in zip(ops, r_pad, p_pad, pn_pad, ap, sts)]
            for op, pap, st in zip(ops, comm.sum(shares), sts):
                op.lap_dot_recur(pap, st)
            shares = [op.update(x, view(r), view(pn), a, st) for op, x, r,
                      pn, a, st in zip(ops, xw, r_pad, pn_pad, ap, sts)]
            for op, rr, st in zip(ops, comm.sum(shares), sts):
                op.update_recur(rr, st)
            fill_halos(comm, r_pad, rows)
            fill_halos(comm, pn_pad, rows)
            p_pad, pn_pad = pn_pad, p_pad

        local_solve.host_syncs = run_chunked(max_iter, iteration,
                                             sts[0][cgk.RUNNING])
        xs = [own(x) for x in xw] if rows else xw
        return [_result(neumann_shard(x, *e), ir,
                        st[cgk.RES], st[cgk.IT].to(torch.int32),
                        st[cgk.RUNNING] > 0, t, abs_tol, a, max_iter)
                for x, e, ir, st, t, a in zip(xs, edges, init_res,
                                              sts, tol, already)]

    local_solve.host_syncs = 0
    return local_solve


def _owned_slices(comm, shape, s):
    """Shard ``s``'s owned (z, y) block of a whole (nz, ny, nx) field on
    the communicator's (Pz, Py) grid."""
    (pz, py), (zi, yi) = comm.shape, comm.coords(s)
    nzl, nyl = shape[0] // pz, shape[1] // py
    return (slice(zi * nzl, (zi + 1) * nzl), slice(yi * nyl, (yi + 1) * nyl))


def split_field(a, mesh: Mesh):
    """The owned blocks of a whole (nz, ny, nx) tensor for the local
    shards of ``mesh``, each on its shard's device."""
    comm = mesh.comm
    return [a[_owned_slices(comm, a.shape, s)].contiguous().to(
        mesh.devices.flat[s]) for s in comm.shards]


def join_results(results, comm, device):
    """One PoissonResult of a whole field from the local shards' results:
    x gathered on ``device`` (a collective on a process group), the
    scalars from the first local shard."""
    parts = comm.gather([r.x for r in results], device)
    pz, py = comm.shape
    nzl, nyl, nx = parts[0].shape
    x = parts[0].new_empty((nzl * pz, nyl * py, nx))
    for s, part in enumerate(parts):
        x[_owned_slices(comm, x.shape, s)] = part
    first = results[0]
    return PoissonResult(x=x, **{
        k: getattr(first, k).to(device) for k in (
            "iterations", "initial_residual", "final_residual", "status")})


def make_cg_fused_sharded(problem: PoissonProblem, params: PoissonParams,
                          mesh: Mesh, dtype=None, plain: bool = False,
                          device=None):
    """The sharded CG for whole fields over a z-only or (z, y) mesh
    (`fused_cg.py:255-282`): ``solve(x, rhs) -> PoissonResult``, x and rhs
    (nz, ny, nx) tensors split over the mesh's shards, the solved x
    gathered on ``device`` (default: x's) with the scalars.  Raises
    ``ERROR_UNSUPPORTED`` with the reason outside the slice."""
    sizes = mesh_zy_sizes(mesh)
    if sizes is None:
        _unsupported("fused sharded CG", "needs a mesh over ('z'[, 'y']) "
                     f"axes (got axes {dict(mesh.shape)})")
    reason = cg_fused_sharded_unsupported_reason(problem, sizes[0],
                                                 py=sizes[1])
    if reason is not None:
        _unsupported("fused sharded CG", reason)
    local = make_cg_fused_sharded_local(problem, params, mesh.comm, dtype,
                                        plain)

    def solve(x, rhs):
        out = local(split_field(x, mesh), split_field(rhs, mesh))
        solve.host_syncs = local.host_syncs
        return join_results(out, mesh.comm,
                            x.device if device is None else device)

    solve.host_syncs = 0
    return solve
