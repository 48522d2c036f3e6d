"""The z- and (z, y)-decomposed BiCGSTAB pressure solve (counterpart of
`cfd_tpu/parallel/fused_bicgstab.py:42-298`).

The rotated loop of the one-device fused BiCGSTAB
(`solvers.poisson.krylov.make_bicgstab_fused`) — its breakdowns, early
s-exit, stagnation flag and closing rules — over fields decomposed
across the communicator's shards, on the three passes' sharded modes
(`ops.kernels.bicgstab_kernels.ShardBiCGSTABPasses`):

1. pv on the shard's halo-padded r, p, v (its outputs p′, v′ on the
   owned planes, zero at the global shells) and the shard's ⟨r̂, v′⟩;
2. st on the halo-padded r and v′, and ⟨s,s⟩, ⟨t,s⟩, ⟨t,t⟩;
3. xr on the owned block, and ⟨r,r⟩, ⟨r̂,r⟩ — the next iteration's ρ.

Five dots an iteration, each a shard's float64 share summed over the
shards in float64 (``comm.sum``, the reference's ``lax.psum``) and
rounded to float once by the recurrence.  r, p, p′, v and v′ live in
persistent ``(nzl + 2)``-plane buffers whose halo planes alone are copied
(``comm.fill_halo``): p′ and v′ after pv (st reads v′ at k ± 1, the next
pv reads p and v there), r after xr.  r̂ is read pointwise only (pv's
dot), so on a z mesh it needs no exchange (the reference's ``ypad`` is
the identity there).  p′ and v′ go to second buffers and swap with p and
v each iteration.

On a (Pz, Py) mesh with Py > 1 (`fused_bicgstab.py:137-160`) each shard
owns a (nz/Pz, ny/Py, nx) block and every buffer — x, r̂, s and t too —
is that block padded one plane and one row a side, as the (z, y) CG's
(`fused_cg`): the halo rows are filled first, then the halo planes; the
passes run their (z, y) modes (the reference's 4-row y ring is the TPU's
sublane tile; one row is what a 7-point operator reads); the Neumann
faces go x, then the global y rows on the edge y-shards, then the global
z faces on the edge z-shards; the initial residual is formed on the
global interior of each owned block.

Unlike CG, BiCGSTAB's trajectory follows the dots' rounding, so the
shard-wise sums part from the one-device solve after some tens of
iterations (`fused_bicgstab.py:22-28`); the guarantee is the same
solution.  ``Precond.NONE`` only (the reference's local body returns
None otherwise).  float32 on the card launches the kernels; the CPU,
float64 and ``plain=True`` run the plain versions in the same loop.
"""

from __future__ import annotations

import torch

from ..ops.kernels import bicgstab_kernels as bk
from ..solvers.poisson.base import PoissonParams, PoissonProblem, Precond
from ..solvers.poisson.krylov import _bicgstab_result, run_chunked
from .fused_cg import (_unsupported, fill_halos, initial_residual,
                       join_results, neumann_shard, padded, split_field)
from .mesh import Mesh, mesh_zy_sizes


def bicgstab_fused_sharded_unsupported_reason(problem: PoissonProblem,
                                              n_shards: int, dtype=None,
                                              py: int = 1):
    """None when the sharded BiCGSTAB applies over ``n_shards`` z-shards
    (and ``py`` y-shards), else the reason (`fused_bicgstab.py:42-66`,
    the TPU gates left out: nx % 128, a multiple of 8 rows a shard,
    VMEM); the dtype is no reason."""
    del dtype
    nz, ny = problem.nz, problem.ny
    if nz <= 2:
        return "fused sharded BiCGSTAB is 3D-only"
    if nz % n_shards != 0 or nz // n_shards < 2:
        return (f"nz={nz} must be divisible by {n_shards} shards with >= 2 "
                "planes per shard")
    if py > 1 and (ny % py != 0 or ny // py < 2):
        return (f"ny={ny} must be divisible by {py} y-shards with >= 2 "
                "rows per shard")
    return None


def make_bicgstab_fused_sharded_local(problem: PoissonProblem,
                                      params: PoissonParams, comm,
                                      dtype=None, plain: bool = False):
    """The shard-local solve (`fused_bicgstab.py:69-268`):
    ``local_solve(xs, rhss) -> [PoissonResult]``, as
    `fused_cg.make_cg_fused_sharded_local`."""
    pz, py = comm.shape
    reason = bicgstab_fused_sharded_unsupported_reason(problem, pz, py=py)
    if reason is not None:
        _unsupported("fused sharded BiCGSTAB", reason)
    if params.preconditioner != Precond.NONE:
        _unsupported("fused sharded BiCGSTAB", "BiCGSTAB kernel build "
                     "failed (the reference's BiCGSTAB is unpreconditioned)")
    nz, ny, nx = problem.shape
    nzl, nyl = nz // pz, ny // py
    rows = py > 1
    consts = bk.BiCGConsts(nzl, nyl, nx, problem.inv_dx2, problem.inv_dy2,
                           problem.inv_dz2, params.check_interval)
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
        ops = [bk.ShardBiCGSTABPasses(consts, z, nz, x.device,
                                      plain=on_plain, y_off=y,
                                      ny_g=ny if rows else None)
               for z, y, x in zip(z_offs, y_offs or [0] * len(xs), xs)]
        xs = [neumann_shard(x, *e) for x, e in zip(xs, edges)]
        rs = initial_residual(problem, comm, xs, rhss, z_offs, y_offs)
        rr0 = [v.to(r.dtype) for v, r in zip(comm.sum(
            [torch.sum(r.double() * r.double()) for r in rs]), rs)]
        init_res = [torch.sqrt(v) for v in rr0]
        tol = [problem.tolerance_for(params, v) for v in init_res]
        already = [v < abs_tol for v in init_res]
        # the first iteration's ρ = ⟨r̂, r₀⟩ is ⟨r₀, r₀⟩
        sts = [bk.new_state(v, ir, t, torch.full((), abs_tol, dtype=v.dtype,
                                                 device=v.device), ~a)
               for v, ir, t, a in zip(rr0, init_res, tol, already)]
        r_pad = padded(rs, rows)
        fill_halos(comm, r_pad, rows)
        p_pad, pn_pad, v_pad, vn_pad = (
            [torch.zeros_like(r) for r in r_pad] for _ in range(4))
        if rows:
            # the (z, y) passes take padded buffers only; r̂, s and t are
            # read pointwise, so their halos stay zero
            xw, rhat = padded(xs, True), padded(rs, True)
            s_, t_ = ([torch.zeros_like(r) for r in r_pad] for _ in range(2))

            def view(b):
                return b
        else:
            xw, rhat = xs, [r.clone() for r in rs]
            s_, t_ = ([torch.empty_like(x) for x in xs] for _ in range(2))
            view = own

        def iteration():
            nonlocal p_pad, pn_pad, v_pad, vn_pad
            shares = [op.pv(r, p, v, rh, view(pn), view(vn), st)
                      for op, r, p, v, rh, pn, vn, st in zip(
                          ops, r_pad, p_pad, v_pad, rhat, pn_pad, vn_pad,
                          sts)]
            for op, sums, st in zip(ops, comm.sum(shares), sts):
                op.pv_recur(sums, st)
            fill_halos(comm, pn_pad, rows)
            fill_halos(comm, vn_pad, rows)
            shares = [op.st(r, vn, s, t, st) for op, r, vn, s, t, st in zip(
                ops, r_pad, vn_pad, s_, t_, sts)]
            for op, sums, st in zip(ops, comm.sum(shares), sts):
                op.st_recur(sums, st)
            shares = [op.xr(x, view(r), view(pn), s, t, rh, st)
                      for op, x, r, pn, s, t, rh, st in zip(
                          ops, xw, r_pad, pn_pad, s_, t_, rhat, sts)]
            for op, sums, st in zip(ops, comm.sum(shares), sts):
                op.xr_recur(sums, st)
            fill_halos(comm, r_pad, rows)
            p_pad, pn_pad, v_pad, vn_pad = pn_pad, p_pad, vn_pad, v_pad

        local_solve.host_syncs = run_chunked(max_iter, iteration,
                                             sts[0][bk.RUNNING])
        xs = [own(x) for x in xw] if rows else xw
        return [_bicgstab_result(
            neumann_shard(x, *e), ir, st[bk.RES],
            st[bk.IT].to(torch.int32), st[bk.STAGNATED] > 0, t, abs_tol, a,
            max_iter)
            for x, e, ir, st, t, a in zip(xs, edges, init_res, sts,
                                          tol, already)]

    local_solve.host_syncs = 0
    return local_solve


def make_bicgstab_fused_sharded(problem: PoissonProblem,
                                params: PoissonParams, mesh: Mesh,
                                dtype=None, plain: bool = False,
                                device=None):
    """The sharded BiCGSTAB for whole fields over a z-only or (z, y) mesh
    (`fused_bicgstab.py:271-298`), as `fused_cg.make_cg_fused_sharded`."""
    sizes = mesh_zy_sizes(mesh)
    if sizes is None:
        _unsupported("fused sharded BiCGSTAB", "needs a mesh over "
                     f"('z'[, 'y']) axes (got axes {dict(mesh.shape)})")
    reason = bicgstab_fused_sharded_unsupported_reason(problem, sizes[0],
                                                       py=sizes[1])
    if reason is not None:
        _unsupported("fused sharded BiCGSTAB", reason)
    local = make_bicgstab_fused_sharded_local(problem, params, mesh.comm,
                                              dtype, plain)

    def solve(x, rhs):
        out = local(split_field(x, mesh), split_field(rhs, mesh))
        solve.host_syncs = local.host_syncs
        return join_results(out, mesh.comm,
                            x.device if device is None else device)

    solve.host_syncs = 0
    return solve
