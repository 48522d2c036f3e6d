"""The z-decomposed CG pressure solve (counterpart of
`cfd_tpu/parallel/fused_cg.py:45-282`, its z-only mesh).

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
    nz = problem.nz
    if nz <= 2:
        return "fused sharded CG is 3D-only"
    if nz % n_shards != 0 or nz // n_shards < 2:
        return (f"nz={nz} must be divisible by {n_shards} shards with >= 2 "
                "planes per shard")
    if py > 1:
        return "the (z, y)-mesh fused sharded CG is not ported yet"
    return None


def neumann_shard(a, first: bool, last: bool):
    """`apply_neumann_scalar` on a shard's owned block: x faces, y faces,
    then the z faces of the global domain, on the edge shards only (a
    new tensor)."""
    a = a.clone()
    a[:, :, 0] = a[:, :, 1]
    a[:, :, -1] = a[:, :, -2]
    a[:, 0, :] = a[:, 1, :]
    a[:, -1, :] = a[:, -2, :]
    if first:
        a[0] = a[1]
    if last:
        a[-1] = a[-2]
    return a


def initial_residual(problem: PoissonProblem, comm, xs, rhss, z_offs):
    """Each shard's r = ∇²x − rhs on the global interior of its owned
    block, zero elsewhere (`fused_cg.py:198-201`): one x halo exchange
    and the plain Laplacian."""
    rs = []
    for x, rhs, (lo, hi), z_off in zip(xs, rhss, comm.halo(xs, 1), z_offs):
        xh = torch.cat([lo, x, hi])
        mask = stencils.global_interior_mask(x.shape, z_off, problem.nz,
                                             x.device)
        r = torch.zeros_like(x)
        r[:, 1:-1, 1:-1] = torch.where(
            mask[:, 1:-1, 1:-1],
            stencils.laplacian(xh, problem.inv_dx2, problem.inv_dy2,
                               problem.inv_dz2) - rhs[:, 1:-1, 1:-1], 0.0)
        rs.append(r)
    return rs


def padded(rs):
    """Each owned block in a new buffer with one zero halo plane a side."""
    out = []
    for r in rs:
        b = r.new_zeros((r.shape[0] + 2,) + tuple(r.shape[1:]))
        b[1:-1] = r
        out.append(b)
    return out


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
    P = comm.size
    reason = cg_fused_sharded_unsupported_reason(problem, P)
    if reason is not None:
        _unsupported("fused sharded CG", reason)
    if params.preconditioner == Precond.MULTIGRID:
        _unsupported("fused sharded CG", "CG kernel build failed (the "
                     "multigrid preconditioner has no sharded form)")
    nz, ny, nx = problem.shape
    nzl = nz // P
    scale = (problem.inv_factor
             if params.preconditioner == Precond.JACOBI else 1.0)
    consts = cgk.CGConsts(nzl, ny, nx, problem.inv_dx2, problem.inv_dy2,
                          problem.inv_dz2, scale, params.check_interval)
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance
    z_offs = [s * nzl for s in comm.shards]

    def local_solve(xs, rhss):
        on_plain = plain or xs[0].dtype != torch.float32
        ops = [cgk.ShardCGPasses(consts, z, nz, x.device, plain=on_plain)
               for z, x in zip(z_offs, xs)]
        xs = [neumann_shard(x, s == 0, s == P - 1)     # the solver's own
              for x, s in zip(xs, comm.shards)]
        rs = initial_residual(problem, comm, xs, rhss, z_offs)
        rr0 = comm.sum([torch.sum(r * r) for r in rs])
        init_res = [torch.sqrt(v) for v in rr0]
        tol = [problem.tolerance_for(params, v) for v in init_res]
        already = [v < abs_tol for v in init_res]
        sts = [cgk.new_state(scale * v, ir, t,
                             torch.full((), abs_tol, dtype=v.dtype,
                                        device=v.device), ~a)
               for v, ir, t, a in zip(rr0, init_res, tol, already)]
        r_pad = padded(rs)
        comm.fill_halo(r_pad, 1)
        p_pad = [torch.zeros_like(r) for r in r_pad]
        pn_pad = [torch.zeros_like(r) for r in r_pad]
        ap = [torch.empty_like(x) for x in xs]

        def iteration():
            nonlocal p_pad, pn_pad
            shares = [op.lap_dot(r, p, pn[1:-1], a, st) for op, r, p, pn,
                      a, st in zip(ops, r_pad, p_pad, pn_pad, ap, sts)]
            for op, pap, st in zip(ops, comm.sum(shares), sts):
                op.lap_dot_recur(pap, st)
            shares = [op.update(x, r[1:-1], pn[1:-1], a, st) for op, x, r,
                      pn, a, st in zip(ops, xs, r_pad, pn_pad, ap, sts)]
            for op, rr, st in zip(ops, comm.sum(shares), sts):
                op.update_recur(rr, st)
            comm.fill_halo(r_pad, 1)
            comm.fill_halo(pn_pad, 1)
            p_pad, pn_pad = pn_pad, p_pad

        local_solve.host_syncs = run_chunked(max_iter, iteration,
                                             sts[0][cgk.RUNNING])
        return [_result(neumann_shard(x, s == 0, s == P - 1), ir,
                        st[cgk.RES], st[cgk.IT].to(torch.int32),
                        st[cgk.RUNNING] > 0, t, abs_tol, a, max_iter)
                for x, s, ir, st, t, a in zip(xs, comm.shards, init_res,
                                              sts, tol, already)]

    local_solve.host_syncs = 0
    return local_solve


def split_field(a, mesh: Mesh):
    """The owned z-blocks of a whole (nz, ny, nx) tensor for the local
    shards of ``mesh``, each on its shard's device."""
    comm = mesh.comm
    nzl = a.shape[0] // comm.size
    return [a[s * nzl:(s + 1) * nzl].contiguous().to(mesh.devices.flat[s])
            for s in comm.shards]


def join_results(results, comm, device):
    """One PoissonResult of a whole field from the local shards' results:
    x gathered on ``device`` (a collective on a process group), the
    scalars from the first local shard."""
    x = torch.cat(comm.gather([r.x for r in results], device))
    first = results[0]
    return PoissonResult(x=x, **{
        k: getattr(first, k).to(device) for k in (
            "iterations", "initial_residual", "final_residual", "status")})


def make_cg_fused_sharded(problem: PoissonProblem, params: PoissonParams,
                          mesh: Mesh, dtype=None, plain: bool = False,
                          device=None):
    """The sharded CG for whole fields over a z-only mesh
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
