"""The z-decomposed BiCGSTAB pressure solve (counterpart of
`cfd_tpu/parallel/fused_bicgstab.py:42-298`, its z-only mesh).

The rotated loop of the one-device fused BiCGSTAB
(`solvers.poisson.krylov.make_bicgstab_fused`) — its breakdowns, early
s-exit, stagnation flag and closing rules — over fields z-decomposed
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
from .fused_cg import (_unsupported, initial_residual, join_results,
                       neumann_shard, padded, split_field)
from .mesh import Mesh, mesh_zy_sizes


def bicgstab_fused_sharded_unsupported_reason(problem: PoissonProblem,
                                              n_shards: int, dtype=None,
                                              py: int = 1):
    """None when the sharded BiCGSTAB applies, else the reason
    (`fused_bicgstab.py:42-66`, the TPU gates left out); the dtype is no
    reason."""
    del dtype
    nz = problem.nz
    if nz <= 2:
        return "fused sharded BiCGSTAB is 3D-only"
    if nz % n_shards != 0 or nz // n_shards < 2:
        return (f"nz={nz} must be divisible by {n_shards} shards with >= 2 "
                "planes per shard")
    if py > 1:
        return "the (z, y)-mesh fused sharded BiCGSTAB is not ported yet"
    return None


def make_bicgstab_fused_sharded_local(problem: PoissonProblem,
                                      params: PoissonParams, comm,
                                      dtype=None, plain: bool = False):
    """The shard-local solve (`fused_bicgstab.py:69-268`):
    ``local_solve(xs, rhss) -> [PoissonResult]``, as
    `fused_cg.make_cg_fused_sharded_local`."""
    P, py = comm.shape
    reason = bicgstab_fused_sharded_unsupported_reason(problem, P, py=py)
    if reason is not None:
        _unsupported("fused sharded BiCGSTAB", reason)
    if params.preconditioner != Precond.NONE:
        _unsupported("fused sharded BiCGSTAB", "BiCGSTAB kernel build "
                     "failed (the reference's BiCGSTAB is unpreconditioned)")
    nz, ny, nx = problem.shape
    nzl = nz // P
    consts = bk.BiCGConsts(nzl, ny, nx, problem.inv_dx2, problem.inv_dy2,
                           problem.inv_dz2, params.check_interval)
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance
    z_offs = [s * nzl for s in comm.shards]

    def local_solve(xs, rhss):
        on_plain = plain or xs[0].dtype != torch.float32
        ops = [bk.ShardBiCGSTABPasses(consts, z, nz, x.device,
                                      plain=on_plain)
               for z, x in zip(z_offs, xs)]
        xs = [neumann_shard(x, s == 0, s == P - 1)
              for x, s in zip(xs, comm.shards)]
        rs = initial_residual(problem, comm, xs, rhss, z_offs)
        rhat = [r.clone() for r in rs]
        rr0 = [v.to(r.dtype) for v, r in zip(comm.sum(
            [torch.sum(r.double() * r.double()) for r in rs]), rs)]
        init_res = [torch.sqrt(v) for v in rr0]
        tol = [problem.tolerance_for(params, v) for v in init_res]
        already = [v < abs_tol for v in init_res]
        # the first iteration's ρ = ⟨r̂, r₀⟩ is ⟨r₀, r₀⟩
        sts = [bk.new_state(v, ir, t, torch.full((), abs_tol, dtype=v.dtype,
                                                 device=v.device), ~a)
               for v, ir, t, a in zip(rr0, init_res, tol, already)]
        r_pad = padded(rs)
        comm.fill_halo(r_pad, 1)
        p_pad, pn_pad, v_pad, vn_pad = (
            [torch.zeros_like(r) for r in r_pad] for _ in range(4))
        s_, t_ = ([torch.empty_like(x) for x in xs] for _ in range(2))

        def iteration():
            nonlocal p_pad, pn_pad, v_pad, vn_pad
            shares = [op.pv(r, p, v, rh, pn[1:-1], vn[1:-1], st)
                      for op, r, p, v, rh, pn, vn, st in zip(
                          ops, r_pad, p_pad, v_pad, rhat, pn_pad, vn_pad,
                          sts)]
            for op, sums, st in zip(ops, comm.sum(shares), sts):
                op.pv_recur(sums, st)
            comm.fill_halo(pn_pad, 1)
            comm.fill_halo(vn_pad, 1)
            shares = [op.st(r, vn, s, t, st) for op, r, vn, s, t, st in zip(
                ops, r_pad, vn_pad, s_, t_, sts)]
            for op, sums, st in zip(ops, comm.sum(shares), sts):
                op.st_recur(sums, st)
            shares = [op.xr(x, r[1:-1], pn[1:-1], s, t, rh, st)
                      for op, x, r, pn, s, t, rh, st in zip(
                          ops, xs, r_pad, pn_pad, s_, t_, rhat, sts)]
            for op, sums, st in zip(ops, comm.sum(shares), sts):
                op.xr_recur(sums, st)
            comm.fill_halo(r_pad, 1)
            p_pad, pn_pad, v_pad, vn_pad = pn_pad, p_pad, vn_pad, v_pad

        local_solve.host_syncs = run_chunked(max_iter, iteration,
                                             sts[0][bk.RUNNING])
        return [_bicgstab_result(
            neumann_shard(x, s == 0, s == P - 1), ir, st[bk.RES],
            st[bk.IT].to(torch.int32), st[bk.STAGNATED] > 0, t, abs_tol, a,
            max_iter)
            for x, s, ir, st, t, a in zip(xs, comm.shards, init_res, sts,
                                          tol, already)]

    local_solve.host_syncs = 0
    return local_solve


def make_bicgstab_fused_sharded(problem: PoissonProblem,
                                params: PoissonParams, mesh: Mesh,
                                dtype=None, plain: bool = False,
                                device=None):
    """The sharded BiCGSTAB for whole fields over a z-only mesh
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
