"""The z- and (z, y)-decomposed multigrid pressure solve (counterpart of
`cfd_tpu/parallel/fused_mg.py`: ``make_multigrid_sharded`` `:84-295` and
``_make_multigrid_sharded_zy`` `:298-556`).

The V-cycle iteration of the single-device `solvers.poisson.multigrid.
make_multigrid` — its loop, check interval, host syncs and closing rules
— with the finest level decomposed over the communicator's shards
(`parallel.comm`) and the coarse levels replicated:

* the global z axis is padded with zero planes to ``nzp = nzl·Pz``,
  ``nzl`` the even plane count a shard owns (on a (z, y) mesh y likewise
  to ``nyl·Py`` rows): 2^k+1 grids never divide, and even blocks put the
  coarse node I on the fine node 2I of one shard.  The padding lies
  outside the global Dirichlet-0 interior, so it stays zero;
* each shard keeps one x buffer and one b buffer for the whole solve: its
  owned block padded with ``HALO`` = 4 planes (and, on a (z, y) mesh, 4
  rows) a side.  b's halo comes with the block (the solve holds the whole
  b), x's is refreshed before each sweep (`comm.fill_halo`: rows, then
  planes, so the corners arrive); an edge shard's halo past the global
  ends stays zero;
* the finest level's sweeps are `ops.kernels.mg_kernels.rb_sweep` in its
  sharded modes (``z_off``, ``gnz`` [, ``y_off``, ``gny``]) on those
  buffers, in place.  Four halo planes make the swept x and its residual
  the single-device sweep's on the owned planes and one plane past them
  (`csrc/mg_kernels.cu` says why);
* the restriction is formed where the fine nodes are: each shard computes
  the coarse nodes whose centre fine plane (and row) 2I it owns, with
  `mg_kernels.fw_axis`'s weights in the single-device order (z, then y,
  then x) — the node 2I = first owned plane reads the residual one plane
  before it, which the fourth halo plane holds — into a zero coarse
  field, and one ``comm.sum`` assembles the replicated coarse right-hand
  side (each node has one non-zero term: v + 0 is exact).  The reference
  contracts z against a dense weight matrix instead, which rounds
  otherwise;
* the coarse levels run the single-device `mg_kernels.v_cycle`, with the
  single-device sweeps, redundantly on every shard's device;
* the prolongation is local: each shard interpolates its owned planes and
  rows from the slice of the replicated coarse correction above them, in
  the single-device order (z, y, x), and adds it on its owned block.

So every fine- and coarse-level value is the single-device solve's bit
for bit; only the residual norm (each shard's share, then ``comm.sum``)
adds in another order, and with it, at a check on the edge of the
tolerance, the V-cycle count.  float32 on the card launches the kernels;
the CPU, float64 and ``plain=True`` run their plain versions in the same
loop.  The reference's TPU gates (float32 only, its VMEM bound, lane
padding, ≥ 8 rows a y-shard for its 4-row tile) are left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.status import CFDError, Status
from ..ops import stencils
from ..ops.kernels import mg_kernels as mgk
from ..solvers.poisson.base import PoissonParams, PoissonProblem
from ..solvers.poisson.multigrid import (_build_levels, _check_smoothing,
                                         _mg_result)
from .mesh import Mesh, mesh_zy_sizes

#: halo planes (and rows) a side of a shard's block
HALO = 4


def _even_share(n: int, shards: int) -> int:
    """The even count of planes (rows) each of ``shards`` owns."""
    return -(-n // (2 * shards)) * 2


def mg_fused_sharded_unsupported_reason(problem: PoissonProblem,
                                        n_shards: int, dtype=None,
                                        py: int = 1):
    """None when the sharded multigrid applies over ``n_shards`` z-shards
    (and ``py`` y-shards), else the reason (`fused_mg.py:53-81`, its TPU
    gates left out).  The dtype is no reason: float64 runs the plain
    sweeps."""
    del dtype
    nz, ny, _ = problem.shape
    if nz <= 2:
        return "fused sharded multigrid is 3D-only"
    if _build_levels(problem) is None:
        return ("grid not coarsenable (needs (n-1) divisible by 2 per "
                "active axis)")
    nzl = _even_share(nz, n_shards)
    if nzl < HALO:
        return (f"nz={nz} over {n_shards} shards leaves {nzl} planes per "
                f"shard (needs >= {HALO})")
    nyl = _even_share(ny, py)
    if py > 1 and nyl < HALO:
        return (f"ny={ny} over {py} y-shards leaves {nyl} rows per shard "
                f"(needs >= {HALO})")
    return None


def _unsupported(reason: str):
    raise CFDError(Status.ERROR_UNSUPPORTED,
                   f"fused sharded multigrid unsupported: {reason}")


def _fw_nodes(a, dim: int, first: int, n: int):
    """`mg_kernels.fw_axis`'s weights along ``dim`` for the ``n`` coarse
    nodes whose centre fine nodes are ``first``, ``first + 2``, … (local
    indices of ``a``)."""
    take = mgk._take
    return (0.25 * take(a, dim, first - 1, first - 1 + 2 * n, 2)
            + 0.5 * take(a, dim, first, first + 2 * n, 2)
            + 0.25 * take(a, dim, first + 1, first + 1 + 2 * n, 2))


def _coarse_nodes(g0: int, owned: int, n_coarse: int):
    """(first, count): the interior coarse nodes 1..n_coarse−2 whose
    centre fine node 2I lies in the owned range g0..g0+owned−1."""
    lo = max(1, g0 // 2)
    hi = min(n_coarse - 2, (g0 + owned - 2) // 2)
    return lo, max(0, hi - lo + 1)


def make_multigrid_sharded(problem: PoissonProblem, params: PoissonParams,
                           mesh: Mesh, pre: int = 2, post: int = 2,
                           dtype=None, plain: bool = False):
    """The sharded multigrid solve for whole fields over a z-only or (z,
    y) mesh (`fused_mg.py:84-295`, `:298-556`): ``solve(x, rhs) ->
    PoissonResult``, x and rhs (nz, ny, nx) tensors on the first local
    shard's device (on a process group every rank passes the whole
    fields), the solved x on x's device.  ``solve.host_syncs`` counts the
    last solve's reads of the running flag.  ``dtype`` is the fields' own
    (accepted for the makers' common signature); ``plain=True`` runs the
    plain sweeps on the card too.  Raises ``ERROR_UNSUPPORTED`` with the
    reason outside the slice."""
    del dtype
    sizes = mesh_zy_sizes(mesh)
    if sizes is None:
        _unsupported("needs a mesh over ('z'[, 'y']) axes (got axes "
                     f"{dict(mesh.shape)})")
    pz, py = sizes
    reason = mg_fused_sharded_unsupported_reason(problem, pz, py=py)
    if reason is not None:
        _unsupported(reason)
    _check_smoothing(pre, post)
    comm = mesh.comm
    levels = _build_levels(problem)
    lv0, nc = levels[0], levels[1].shape
    nz, ny, nx = problem.shape
    rows = py > 1
    H, hy = HALO, (HALO if rows else 0)
    nzl = _even_share(nz, pz)
    nyl = _even_share(ny, py) if rows else ny
    ci = max(1, int(params.check_interval))
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance
    coords = [comm.coords(s) for s in comm.shards]
    devices = [mesh.devices.flat[s] for s in comm.shards]
    # each local shard: its first global plane and row, the sweep's
    # offsets, its coarse nodes along z and y, the global interior of its
    # owned block
    offs = [(zi * nzl, yi * nyl if rows else 0) for zi, yi in coords]
    modes = [dict(z_off=g0 - H, gnz=nz,
                  **(dict(y_off=g0y - hy, gny=ny) if rows else {}))
             for g0, g0y in offs]
    nodes = [(_coarse_nodes(g0, nzl, nc[0]), _coarse_nodes(g0y, nyl, nc[1]))
             for g0, g0y in offs]
    interiors = [stencils.global_interior_mask(
        (nzl, nyl, nx), g0, nz, dev, *((g0y, ny) if rows else ()))
        for (g0, g0y), dev in zip(offs, devices)]

    def own(buf):
        """A buffer's owned block (a view)."""
        return buf[H:H + nzl, hy:hy + nyl]

    def fill(bufs):
        if rows:
            comm.fill_halo(bufs, H, "y")
        comm.fill_halo(bufs, H, "z")

    def restrict(r, g0, g0y, zn, yn):
        """This shard's coarse nodes of the restriction of ``r`` (its
        block), in a zero coarse field."""
        (z1, zc), (y1, yc) = zn, yn
        out = r.new_zeros(nc)
        if zc and yc:
            a = _fw_nodes(r, 0, 2 * z1 - g0 + H, zc)
            a = _fw_nodes(a, 1, 2 * y1 - g0y + hy, yc)
            out[z1:z1 + zc, y1:y1 + yc, 1:-1] = mgk.fw_axis(a, 2)
        return out

    def prolong(e_c, g0, g0y, inside):
        """The prolongation of ``e_c`` on this shard's owned block: its
        planes (rows) interpolated from the coarse slice above them, zero
        outside the global interior."""
        c0, cy0 = g0 // 2, g0y // 2
        mz, my = nzl // 2 + 1, (nyl // 2 + 1 if rows else nc[1])
        part = e_c[c0:c0 + mz, cy0:cy0 + my]
        short_z, short_y = mz - part.shape[0], my - part.shape[1]
        if short_z or short_y:       # the padding past the global ends
            part = F.pad(part, (0, 0, 0, short_y, 0, short_z))
        a = mgk.interp_axis(mgk.interp_axis(mgk.interp_axis(part, 0), 1), 2)
        return torch.where(inside, a[:nzl, :nyl], 0.0)

    def solve(x, rhs):
        on_plain = plain or x.dtype != torch.float32
        sweep = mgk.rb_sweep_inplace_plain if on_plain else mgk.rb_sweep
        x = problem.neumann_bc(x)
        b = problem.zero_boundary(-(rhs - problem.laplacian(x)))
        # A e = b with A = −∇² Dirichlet-0; x* = x + e
        init_res = torch.sqrt(problem.dot_interior(b, b))
        tol = problem.tolerance_for(params, init_res)
        already = init_res < abs_tol
        # the shards' b blocks, halos included, from the zero-padded b
        bp = b.new_zeros((nzl * pz + 2 * H, nyl * py + 2 * hy, nx))
        bp[H:H + nz, hy:hy + ny] = b
        block = (nzl + 2 * H, nyl + 2 * hy, nx)
        bs = [b.new_empty(block, device=dev).copy_(
            bp[g0:g0 + block[0], g0y:g0y + block[1]])
            for (g0, g0y), dev in zip(offs, devices)]
        del bp
        es = [torch.zeros_like(bb) for bb in bs]
        rs = [torch.empty_like(bb) for bb in bs]

        def fine_sweeps(n, first="red"):
            """``n`` sweeps of every shard's block, the last one emitting
            the residual."""
            for i in range(n):
                fill(es)
                for e, bb, r, mode in zip(es, bs, rs, modes):
                    sweep(e, bb, lv0, first, r if i == n - 1 else None,
                          **mode)

        res, it, syncs = init_res, 0, 1
        running = not bool(already)
        while running and it < max_iter:
            fine_sweeps(pre)
            coarse = comm.sum([restrict(r, g0, g0y, zn, yn) for r, (
                g0, g0y), (zn, yn) in zip(rs, offs, nodes)])
            for e, r_c, (g0, g0y), inside in zip(es, coarse, offs,
                                                 interiors):
                de_c = mgk.v_cycle(levels, 1, r_c, pre, post, False, sweep)
                own(e).add_(prolong(de_c, g0, g0y, inside))
            fine_sweeps(post)
            res_new = torch.sqrt(comm.sum([torch.sum(own(r) * own(r))
                                           for r in rs])[0]).to(x.device)
            if it % ci == 0:
                syncs += 1
                running = not bool((res_new < tol) | (res_new < abs_tol))
            it, res = it + 1, res_new
        solve.host_syncs = syncs
        parts = comm.gather([own(e).contiguous() for e in es], x.device)
        e = x.new_empty((nzl * pz, nyl * py, nx))
        for (zi, yi), part in zip((comm.coords(s) for s in
                                   range(comm.size)), parts):
            e[zi * nzl:(zi + 1) * nzl, yi * nyl:(yi + 1) * nyl] = part
        return _mg_result(
            problem.neumann_bc(x + e[:nz, :ny]), init_res, res,
            torch.tensor(it, dtype=torch.int32, device=x.device), tol,
            abs_tol, already, max_iter)

    solve.host_syncs = 0
    return solve
