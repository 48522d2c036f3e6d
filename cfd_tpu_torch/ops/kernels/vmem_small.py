"""The whole-solve kernels for small grids (counterpart of
`cfd_tpu/ops/pallas/vmem_small.py`: ``make_cg_vmem_solve`` `:243-323`,
``make_bicgstab_vmem_solve`` `:326-427`, ``make_rbsor_vmem_solve``
`:167-240` and ``make_jacobi_vmem_solve`` `:430-501`).

The reference runs each solve's entire ``while_loop`` inside one Pallas
kernel with the vectors in VMEM: grids that small (a 100² plane is 40 KB)
are launch latency, not bandwidth, if each pass is its own device call.
The Krylov solves of a 2D plane keep their vectors resident in one
thread-block cluster of up to 16 CTAs (``csrc/cluster_band.cuh``): bands
of rows in the CTAs' shared memory, the halo rows and each dot's
partials pushed into the other CTAs' shared memory and counted on their
mbarriers (no barrier in the loop), every CTA adding the partials in rank
order.  :func:`krylov_cluster_plan` picks the form by shape; a 3D
volume, or a plane whose stencil vectors do not fit, runs the grid-wide
form: one cooperative launch, grid-stride passes with grid barriers
between them, the vectors in device memory (in the 50 MB L2 at these
sizes), every dot a per-block partial folded in one order by every block.
Either way the host launches once per solve and reads nothing.

* :func:`cg_solve` → ``cg_solve_cluster_kernel`` or ``cg_solve_kernel``
  (``csrc/cg_kernels.cu``): the CG/PCG recursion, un-rotated
  (`:265-305`); the Jacobi preconditioner enters as the scalar ``scale``;
  the L2 norm of the recursion residual, checked every ``check_interval``
  iterations; breakdown at 1e-30 stops the loop.  Returns (x, r0, res,
  iterations, running).
* :func:`bicgstab_solve` → ``bicg_solve_cluster_kernel`` or
  ``bicg_solve_kernel`` (``csrc/bicgstab_kernels.cu``): the un-rotated
  BiCGSTAB loop (`:364-404`) with the early s-exit, breakdowns 1–4 and
  stagnation.  Returns (x, r0, res, iterations, stagnated); res and
  iterations follow the stats rules of `:411-416` (the initial residual
  and 0 when the start has converged).
* :func:`rbsor_solve` and :func:`jacobi_solve` →
  ``stationary_solve_kernel<false / true>`` (``csrc/rbsor_kernels.cu``),
  one loop templated on the sweep: ``check_interval`` chunks of
  min(ci, max_iter − it) sweeps, each followed by the Neumann mirror, the
  ∞-norm residual at the end of a chunk.  Returns (x, r0, res,
  iterations, converged) by the rules of `:226-229` / `:487-490`.

The Krylov solves mirror x before and after; the stationary ones start
from x as given.  The TPU layout workarounds are left out: the
power-of-two row padding and the 128-lane padding (`:17-23`, `:51-65`),
the iota-rebuilt masks and the VMEM budget gate (`:46`); every
(nz, ny, nx) with nz == 1 or nz ≥ 3 runs.  The plain versions are the
reference's loops as tensor code, reading the stop flag on the host once
per iteration (once per chunk for the stationary ones).  The order models
:func:`cg_solve_cluster_ordered` and :func:`bicgstab_solve_cluster_ordered`
are the plain loops with their dots summed in the cluster kernels' order
(:func:`cluster_dot`), so the kernels are held against them bit for bit.
"""

from __future__ import annotations

import functools

import torch

from ...boundary.apply import apply_neumann_scalar
from .. import stencils
from . import native
from .bicgstab_kernels import BiCGConsts
from .bicgstab_kernels import dot as bicgstab_dot
from .cg_kernels import BREAKDOWN, CGConsts
from .rbsor_kernels import (SORConsts, jacobi_sweep_plain, rb_sweep_plain,
                            residual_inf)

# ---- the cluster plan ------------------------------------------------------------

# the engine's limits (csrc/cluster_band.cuh)
CLUSTER_MAX = 16              # CTAs of a cluster (the non-portable size)
CLUSTER_THREADS = 1024        # threads of a CTA, at most
CLUSTER_SMEM = 232448         # bytes of shared memory a CTA (227 KB)
CLUSTER_HEADER = 2048         # bytes of it: mbarriers, partials, warp sums
# the band vectors of each solve, in the order they take shared memory
# (the kernels' kVec* order); the first CLUSTER_STENCIL, which the
# Laplacians read at their neighbours, must fit or the plane runs the
# grid-wide kernel
CLUSTER_VECTORS = {"cg": ("p", "r", "ap", "x"),
                   "bicgstab": ("p", "s", "r", "v", "rhat", "x", "t")}
CLUSTER_STENCIL = 2
# floats a column of the halo rows on each side of a band (K3c: the
# neighbour's edge r and p; B2c: its r, p, v and new v)
CLUSTER_HALO = {"cg": 2, "bicgstab": 4}
# the cluster size aims at a point a thread of CTAs of CLUSTER_SMALL
# threads (at most 16 CTAs); a band of more than CLUSTER_WIDE points a
# thread of those takes CLUSTER_THREADS threads (on an H100 at 700 W, 100²
# and 128² ran fastest at 16 CTAs of 512 threads, 512² at 16 of 1024:
# PERF.md)
CLUSTER_SMALL = 512
CLUSTER_WIDE = 4


@functools.lru_cache(maxsize=None)
def _cluster_plan(nz, ny, nx, kind):
    vectors = CLUSTER_VECTORS[kind]
    if nz != 1:
        return {"form": "grid", "why": "a 3D volume"}
    my, mx = ny - 2, nx - 2
    if my < 1 or mx < 1:
        return {"form": "grid", "why": "no interior"}
    fixed = CLUSTER_HEADER + 8 * nx * CLUSTER_HALO[kind]
    top = min(CLUSTER_MAX, my)
    want = -(-my * mx // CLUSTER_SMALL)
    for cs in range(min(want, top), top + 1):
        rmax = -(-my // cs)
        row_bytes = 4 * rmax * nx
        if fixed + CLUSTER_STENCIL * row_bytes <= CLUSTER_SMEM:
            break
    else:
        return {"form": "grid", "why": "its stencil vectors do not fit "
                "one cluster's shared memory"}
    n_res = min(len(vectors), (CLUSTER_SMEM - fixed) // row_bytes)
    band = rmax * mx
    wide = band > CLUSTER_WIDE * CLUSTER_SMALL
    return {"form": "cluster", "cluster": cs,
            "threads": min(CLUSTER_THREADS if wide else CLUSTER_SMALL,
                           -(-band // 32) * 32),
            "rows": rmax,
            "rows_of": tuple(my // cs + (q < my % cs) for q in range(cs)),
            "shared_bytes": fixed + n_res * row_bytes,
            "resident": vectors[:n_res], "device": vectors[n_res:],
            "mask": (1 << n_res) - 1,
            "dots": 2 if kind == "cg" else 3}


def krylov_cluster_plan(nz, ny, nx, kind):
    """The form of the whole ``kind`` ("cg" or "bicgstab") solve of an
    (nz, ny, nx) field, by its shape alone.  ``{"form": "grid", "why":
    ...}`` for a 3D volume or a plane whose stencil vectors do not fit one
    cluster; else ``{"form": "cluster", "cluster": CTAs, "threads": a
    CTA's, "rows": the rows a resident vector holds (the largest band),
    "rows_of": each rank's band rows, "shared_bytes": a CTA's dynamic
    shared memory, "resident": the vectors in it, "device": the ones in
    device memory, "mask": the resident vectors' bits, "dots": dot
    exchanges an iteration}``.  The smallest cluster from ⌈points /
    CLUSTER_SMALL⌉ up whose stencil vectors fit is taken."""
    return dict(_cluster_plan(nz, ny, nx, kind))


def _lane_tree(w):
    """block_reduce.cuh's shuffle tree over the last axis (32 lanes):
    lane 0's sum."""
    for off in (16, 8, 4, 2, 1):
        w = w[..., :off] + w[..., off:2 * off]
    return w[..., 0]


def _cluster_order(plan, ny, nx, device):
    """(cs, steps, T): the flat interior index (my·mx past the end: a zero)
    of the point thread t of rank q sums at its k-th step — band_points'
    m = t + k·T over its band's rows·mx points."""
    cs, T, mx = plan["cluster"], plan["threads"], nx - 2
    rows = plan["rows_of"]
    steps = -(-max(rows) * mx // T)
    m = torch.arange(steps * T, device=device).view(steps, T)
    idx = torch.empty((cs, steps, T), dtype=torch.int64, device=device)
    start = 0
    for q, n in enumerate(rows):
        idx[q] = torch.where(m < n * mx, start * mx + m, (ny - 2) * mx)
        start += n
    return idx


def cluster_dot(plan, ny, nx, device, wide: bool = False):
    """dot(a, b) over the interior of two (1, ny, nx) fields in the
    cluster kernels' order for ``plan``: each thread's sequential sum of
    its points, the block's shuffle tree over 32 warp sums (zeros past
    its warps), then the ranks' partials added in rank order.  ``wide``:
    the products and sums in float64, rounded to a's dtype once (B2c's
    dots); else in a's dtype (K3c's)."""
    idx = _cluster_order(plan, ny, nx, device)
    cs, steps, T = idx.shape

    def dot(a, b):
        ai = stencils.interior(a).reshape(-1)
        bi = stencils.interior(b).reshape(-1)
        prod = ai.double() * bi.double() if wide else ai * bi
        v = torch.cat((prod, prod.new_zeros(1)))[idx]
        acc = torch.zeros_like(v[:, 0])
        for k in range(steps):
            acc = acc + v[:, k]
        warps = _lane_tree(acc.view(cs, T // 32, 32))
        warps = torch.cat((warps, warps.new_zeros(cs, 32 - T // 32)), 1)
        part = _lane_tree(warps)
        total = part[0]
        for q in range(1, cs):
            total = total + part[q]
        return total.to(a.dtype) if wide else total

    return dot


def cg_solve_plain(x0, rhs, c: CGConsts, tolerance, abs_tol, max_iter,
                   dot=None):
    """The reference kernel's recursion as plain tensor code; reads the
    stop flag on the host once per iteration.  ``dot``, when given, sums
    the dots in its own order (:func:`cg_solve_cluster_ordered`)."""
    ix = stencils.interior_index(x0)
    mask = stencils.interior_mask(c.shape, torch.bool, x0.device)
    zero = torch.zeros_like(x0)

    def lap(f):
        out = torch.zeros_like(f)
        out[ix] = stencils.laplacian(f, c.inv_dx2, c.inv_dy2, c.inv_dz2)
        return out

    if dot is None:
        def dot(a, b):
            return torch.sum(a[ix] * b[ix])

    x = apply_neumann_scalar(x0)
    r = torch.where(mask, lap(x) - rhs, zero)
    rr0 = dot(r, r)
    rho = c.scale * rr0
    init_res = torch.sqrt(rr0)
    tol = torch.clamp_min(tolerance * init_res, abs_tol)
    already = bool(init_res < abs_tol)
    p = torch.where(mask, c.scale * r, zero)
    res, it, running = init_res, 0, not already
    ci = max(1, int(c.check_interval))
    one = torch.ones_like(rho)
    while running and it < max_iter:
        ap = torch.where(mask, -lap(p), zero)
        pap = dot(p, ap)
        bd1 = pap.abs() < BREAKDOWN
        alpha = rho / torch.where(bd1, one, pap)
        x = torch.where(bd1, x, x + alpha * p)
        r = torch.where(bd1, r, r - alpha * ap)
        rr = dot(r, r)
        rho_new = c.scale * rr
        res_new = torch.sqrt(rr)
        conv = ((res_new < tol) | (res_new < abs_tol)) & (it % ci == 0)
        bd2 = rho.abs() < BREAKDOWN
        beta = rho_new / torch.where(bd2, one, rho)
        stop = conv | bd1 | bd2
        p = torch.where(stop, p, c.scale * r + beta * p)
        rho, it = rho_new, it + 1
        res = torch.where(bd1, res, res_new)
        running = not bool(stop)
    dev = x0.device
    return (apply_neumann_scalar(x), init_res, res,
            torch.tensor(it, dtype=torch.int32, device=dev),
            torch.tensor(running, device=dev))


def _cluster_plan_of(c, kind):
    plan = krylov_cluster_plan(c.nz, c.ny, c.nx, kind)
    if plan["form"] != "cluster":
        raise ValueError(f"the {kind} solve of a {c.shape} field is not a "
                         f"cluster solve: {plan['why']}")
    return plan


def cg_solve_cluster_ordered(x0, rhs, c: CGConsts, tolerance, abs_tol,
                             max_iter):
    """:func:`cg_solve_plain` with its dots in ``cg_solve_cluster_kernel``'s
    order for the plan of the shape: the kernel's order model, the fields
    the plain version's."""
    plan = _cluster_plan_of(c, "cg")
    return cg_solve_plain(x0, rhs, c, tolerance, abs_tol, max_iter,
                          dot=cluster_dot(plan, c.ny, c.nx, x0.device))


def cg_solve_cluster(x0, rhs, c: CGConsts, tolerance, abs_tol, max_iter):
    """(x, r0, res, iterations, running) — ``cg_solve_cluster_kernel`` for
    the plan of the shape, one cluster launch, counted on
    ``cg_solve.cluster_launches``.  A cluster the card refuses raises."""
    plan = _cluster_plan_of(c, "cg")
    _check_shapes(c, x0, rhs)
    x = torch.empty_like(x0)
    ws = x0.new_empty((3, c.ny, c.nx)) if set(plan["device"]) - {"x"} \
        else x
    stats = torch.empty(4, dtype=x0.dtype, device=x0.device)
    native.launch("cfd_cg_solve_cluster", x0.device, *map(native.ptr, (
        x0, rhs, x, ws, stats)), c.ny, c.nx, c.inv_dx2, c.inv_dy2, c.scale,
        tolerance, abs_tol, int(max_iter), max(1, int(c.check_interval)),
        plan["cluster"], plan["threads"], plan["rows"], plan["mask"])
    cg_solve.cluster_launches += 1
    return x, stats[0], stats[1], stats[2].to(torch.int32), stats[3] > 0


def cg_solve_grid(x0, rhs, c: CGConsts, tolerance, abs_tol, max_iter):
    """(x, r0, res, iterations, running) — ``cg_solve_kernel``, one
    cooperative launch over a grid of as many blocks as are resident,
    counted on ``cg_solve.launches``."""
    _check_shapes(c, x0, rhs)
    x, r, p, ap = (torch.empty_like(x0) for _ in range(4))
    nblk = native.library().cfd_cg_solve_blocks(c.nz, c.ny, c.nx)
    part = torch.empty(2 * nblk, dtype=x0.dtype, device=x0.device)
    stats = torch.empty(4, dtype=x0.dtype, device=x0.device)
    native.launch("cfd_cg_solve", x0.device, *map(native.ptr, (
        x0, rhs, x, r, p, ap, part, stats)), c.nz, c.ny, c.nx, c.inv_dx2,
        c.inv_dy2, c.inv_dz2, c.scale, tolerance, abs_tol, int(max_iter),
        max(1, int(c.check_interval)))
    cg_solve.launches += 1
    return x, stats[0], stats[1], stats[2].to(torch.int32), stats[3] > 0


def cg_solve(x0, rhs, c: CGConsts, tolerance, abs_tol, max_iter):
    """(x, r0, res, iterations, running): the form
    :func:`krylov_cluster_plan` names on CUDA — :func:`cg_solve_cluster`
    (``cluster_launches``) or :func:`cg_solve_grid` (``launches``); the
    plain loop on the CPU.  x0 and rhs are left as they were."""
    if native.on_cpu(x0):
        return cg_solve_plain(x0, rhs, c, tolerance, abs_tol, max_iter)
    if krylov_cluster_plan(c.nz, c.ny, c.nx, "cg")["form"] == "cluster":
        return cg_solve_cluster(x0, rhs, c, tolerance, abs_tol, max_iter)
    return cg_solve_grid(x0, rhs, c, tolerance, abs_tol, max_iter)


cg_solve.launches = cg_solve.cluster_launches = 0


BARRIER_KINDS = ("grid", "cluster", "dot")


def barrier_probe(kind: str, blocks: int, threads: int, device,
                  iters: int = 20000):
    """The latency of one barrier on the card, ``iters`` of them in a
    row: ``"grid"``, grid.sync() of a cooperative grid of ``blocks``;
    ``"cluster"``, cluster.sync() of one cluster of ``blocks`` CTAs;
    ``"dot"``, the cluster kernels' dot (partials pushed to every CTA, an
    mbarrier wait, the rank-order sum) in such a cluster; ``threads``
    threads a block.  Returns {"ns": ns a barrier (%globaltimer),
    "cycles": SM cycles a barrier}."""
    out = torch.zeros(3, dtype=torch.int64, device=device)
    native.launch("cfd_barrier_probe", out.device, BARRIER_KINDS.index(kind),
                  int(blocks), int(threads), int(iters), native.ptr(out))
    cycles, ns, wrong = (int(v) for v in out.cpu())
    if wrong:
        raise RuntimeError("barrier_probe: a dot summed wrong")
    return {"ns": ns / iters, "cycles": cycles / iters}


def _check_shapes(c, *fields):
    native.check_cuda(*fields)
    for f in fields:
        if tuple(f.shape) != c.shape:
            raise ValueError(f"expected fields of shape {c.shape}, got "
                             f"{tuple(f.shape)}")


def _count(n, like):
    return torch.tensor(n, dtype=torch.int32, device=like.device)


# ---- BiCGSTAB ------------------------------------------------------------------

def bicgstab_solve_plain(x0, rhs, c: BiCGConsts, tolerance, abs_tol,
                         max_iter, problem=None, stats=None, dot=None):
    """The reference's BiCGSTAB loop (`krylov.py:392-460`,
    `vmem_small.py:349-416`) as plain tensor code.  ``problem``, when
    given, brings its own operator and inner product (``laplacian``,
    ``dot_interior``: the consistent scheme's volume-weighted problem,
    `solvers.poisson.nonuniform`) in place of ``c``'s uniform ones;
    ``dot``, when given, sums the dots in its own order
    (:func:`bicgstab_solve_cluster_ordered`).  The loop reads its stop
    flag on the host once an iteration; ``stats``, a dict when given, gets
    those reads as ``"host_syncs"``."""
    ix = stencils.interior_index(x0)

    def lap(q):
        if problem is not None:
            return problem.interior(problem.laplacian(q))
        return stencils.laplacian(q, c.inv_dx2, c.inv_dy2, c.inv_dz2)

    def A(q):
        out = torch.zeros_like(q)
        out[ix] = -lap(q)
        return out

    if dot is None:
        dot = bicgstab_dot if problem is None else problem.dot_interior

    x = apply_neumann_scalar(x0)
    r = torch.zeros_like(x)
    r[ix] = lap(x) - rhs[ix]
    r_hat = r
    v = p = torch.zeros_like(r)
    init_res = torch.sqrt(dot(r, r))
    tol = torch.clamp_min(tolerance * init_res, abs_tol)
    already = bool(init_res < abs_tol)
    one = torch.ones_like(init_res)
    rho = alpha = omega = one
    res, it, running = init_res, 0, not already
    stagnated = torch.zeros((), dtype=torch.bool, device=x0.device)
    ci = max(1, int(c.check_interval))
    while running and it < max_iter:
        rho_new = dot(r_hat, r)
        bd1 = rho_new.abs() < BREAKDOWN
        beta = ((rho_new / torch.where(bd1, one, rho))
                * (alpha / torch.where(omega.abs() < BREAKDOWN, one, omega)))
        p_new = r + beta * (p - omega * v)
        v_new = A(p_new)
        rhv = dot(r_hat, v_new)
        bd2 = rhv.abs() < BREAKDOWN
        alpha_new = rho_new / torch.where(bd2, one, rhv)
        s = r - alpha_new * v_new
        s_norm = torch.sqrt(dot(s, s))
        early = (s_norm < tol) | (s_norm < abs_tol)
        t = A(s)
        tds, tdt = dot(t, s), dot(t, t)
        bd3 = tdt.abs() < BREAKDOWN
        omega_new = tds / torch.where(bd3, one, tdt)
        x_full = x + alpha_new * p_new + omega_new * s
        r_full = s - omega_new * t
        res_full = torch.sqrt(dot(r_full, r_full))
        x_early = x + alpha_new * p_new
        bd = bd1 | bd2
        x = torch.where(bd, x, torch.where(early | bd3, x_early, x_full))
        r = torch.where(bd | early | bd3, r, r_full)
        res = torch.where(bd, res,
                          torch.where(early | bd3, s_norm, res_full))
        converged = early | ((it % ci == 0)
                             & ((res_full < tol) | (res_full < abs_tol)))
        bd4 = omega_new.abs() < BREAKDOWN
        stagnated = bd | bd3 | (bd4 & ~converged)
        p, v, rho, alpha, omega = p_new, v_new, rho_new, alpha_new, omega_new
        it += 1
        running = not bool(stagnated | converged)
    if stats is not None:
        stats["host_syncs"] = 1 + it
    return (apply_neumann_scalar(x), init_res,
            init_res if already else res,
            _count(0 if already else it, x0), stagnated)


def bicgstab_solve_cluster_ordered(x0, rhs, c: BiCGConsts, tolerance,
                                   abs_tol, max_iter):
    """:func:`bicgstab_solve_plain` with its dots (float64, rounded once)
    in ``bicg_solve_cluster_kernel``'s order for the plan of the shape:
    the kernel's order model."""
    plan = _cluster_plan_of(c, "bicgstab")
    return bicgstab_solve_plain(
        x0, rhs, c, tolerance, abs_tol, max_iter,
        dot=cluster_dot(plan, c.ny, c.nx, x0.device, wide=True))


def bicgstab_solve_cluster(x0, rhs, c: BiCGConsts, tolerance, abs_tol,
                           max_iter):
    """(x, r0, res, iterations, stagnated) — ``bicg_solve_cluster_kernel``
    for the plan of the shape, one cluster launch, counted on
    ``bicgstab_solve.cluster_launches``.  A cluster the card refuses
    raises."""
    plan = _cluster_plan_of(c, "bicgstab")
    _check_shapes(c, x0, rhs)
    x = torch.empty_like(x0)
    ws = x0.new_empty((len(CLUSTER_VECTORS["bicgstab"]), c.ny, c.nx)) \
        if set(plan["device"]) - {"x"} else x
    stats = torch.empty(4, dtype=x0.dtype, device=x0.device)
    native.launch("cfd_bicg_solve_cluster", x0.device, *map(native.ptr, (
        x0, rhs, x, ws, stats)), c.ny, c.nx, c.inv_dx2, c.inv_dy2,
        tolerance, abs_tol, int(max_iter), max(1, int(c.check_interval)),
        plan["cluster"], plan["threads"], plan["rows"], plan["mask"])
    bicgstab_solve.cluster_launches += 1
    return x, stats[0], stats[1], stats[2].to(torch.int32), stats[3] > 0


def bicgstab_solve_grid(x0, rhs, c: BiCGConsts, tolerance, abs_tol,
                        max_iter):
    """(x, r0, res, iterations, stagnated) — ``bicg_solve_kernel``, one
    cooperative launch over a grid of as many blocks as are resident,
    counted on ``bicgstab_solve.launches``."""
    _check_shapes(c, x0, rhs)
    x, r, rhat, p, v, s, t = (torch.empty_like(x0) for _ in range(7))
    nblk = native.library().cfd_bicg_solve_blocks(c.nz, c.ny, c.nx)
    part = torch.empty(6 * nblk, dtype=torch.float64, device=x0.device)
    stats = torch.empty(4, dtype=x0.dtype, device=x0.device)
    native.launch("cfd_bicg_solve", x0.device, *map(native.ptr, (
        x0, rhs, x, r, rhat, p, v, s, t, part, stats)), c.nz, c.ny, c.nx,
        c.inv_dx2, c.inv_dy2, c.inv_dz2, tolerance, abs_tol, int(max_iter),
        max(1, int(c.check_interval)))
    bicgstab_solve.launches += 1
    return x, stats[0], stats[1], stats[2].to(torch.int32), stats[3] > 0


def bicgstab_solve(x0, rhs, c: BiCGConsts, tolerance, abs_tol, max_iter):
    """(x, r0, res, iterations, stagnated): the form
    :func:`krylov_cluster_plan` names on CUDA —
    :func:`bicgstab_solve_cluster` (``cluster_launches``) or
    :func:`bicgstab_solve_grid` (``launches``); the plain loop on the CPU.
    x0 and rhs are left as they were."""
    if native.on_cpu(x0):
        return bicgstab_solve_plain(x0, rhs, c, tolerance, abs_tol, max_iter)
    if krylov_cluster_plan(c.nz, c.ny, c.nx, "bicgstab")["form"] == "cluster":
        return bicgstab_solve_cluster(x0, rhs, c, tolerance, abs_tol,
                                      max_iter)
    return bicgstab_solve_grid(x0, rhs, c, tolerance, abs_tol, max_iter)


bicgstab_solve.launches = bicgstab_solve.cluster_launches = 0


def make_bicgstab_vmem_solve(nz, ny, nx, inv_dx2, inv_dy2, inv_dz2,
                             tolerance, abs_tol, max_iterations,
                             check_interval, plain: bool = False):
    """fn(x, rhs) -> (x, r0, res, iterations, stagnated): the whole
    BiCGSTAB solve (nz == 1 or nz ≥ 3).  ``plain=True`` runs the plain
    version on a CUDA device too (a reference switch for checks on the
    card)."""
    if nz != 1 and nz < 3:
        raise ValueError("the whole-solve BiCGSTAB needs nz == 1 or nz >= 3")
    c = BiCGConsts(nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, check_interval)
    run = bicgstab_solve_plain if plain else bicgstab_solve

    def solve(x, rhs):
        return run(x, rhs, c, tolerance, abs_tol, max_iterations)

    return solve


# ---- Red-Black SOR and Jacobi --------------------------------------------------

_SWEEPS = {"rbsor": rb_sweep_plain, "jacobi": jacobi_sweep_plain}


def stationary_solve_plain(x0, rhs, c: SORConsts, sweep, tolerance, abs_tol,
                           max_iter):
    """The reference's common solve loop (`stationary.py:35-76`, the
    kernels' `vmem_small.py:197-229`) with ``sweep(x, rhs, c)`` (a sweep
    and the Neumann mirror, a new tensor), as plain tensor code: the
    ∞-norm residual of x as given, then ``check_interval`` chunks of
    sweeps until it falls below max(tolerance·r0, abs_tol)."""
    ci = max(1, int(c.check_interval))
    r0 = residual_inf(x0, rhs, c)
    tol = torch.clamp_min(tolerance * r0, abs_tol)
    already = bool(r0 < abs_tol)
    x, it, res, conv = x0.clone(), 0, r0, already
    while it < max_iter and not conv:
        n = min(ci, max_iter - it)
        for _ in range(n):
            x = sweep(x, rhs, c)
        res = residual_inf(x, rhs, c)
        conv = bool((res < tol) | (res < abs_tol))
        it += n
    return (x, r0, r0 if already else res, _count(0 if already else it, x0),
            torch.tensor(conv, device=x0.device))


def _stationary_solve(x0, rhs, c: SORConsts, kind, tolerance, abs_tol,
                      max_iter):
    """``stationary_solve_kernel`` of ``kind``, one cooperative launch."""
    _check_shapes(c, x0, rhs)
    x = torch.empty_like(x0)
    xb = torch.empty_like(x0) if kind == "jacobi" else None
    nblk = native.library().cfd_stationary_solve_blocks(c.nz, c.ny, c.nx)
    part = torch.empty(2 * nblk, dtype=x0.dtype, device=x0.device)
    stats = torch.empty(4, dtype=x0.dtype, device=x0.device)
    native.launch("cfd_stationary_solve", x0.device, native.ptr(x0),
                  native.ptr(rhs), native.ptr(x),
                  None if xb is None else native.ptr(xb), native.ptr(part),
                  native.ptr(stats), c.nz, c.ny, c.nx, c.inv_dx2, c.inv_dy2,
                  c.inv_dz2, c.inv_factor, c.omega, tolerance, abs_tol,
                  int(max_iter), max(1, int(c.check_interval)),
                  int(kind == "jacobi"))
    return x, stats[0], stats[1], stats[2].to(torch.int32), stats[3] > 0


def rbsor_solve(x0, rhs, c: SORConsts, tolerance, abs_tol, max_iter):
    """(x, r0, res, iterations, converged) of the whole Red-Black SOR
    solve — ``stationary_solve_kernel<false>`` on CUDA."""
    if native.on_cpu(x0):
        return stationary_solve_plain(x0, rhs, c, rb_sweep_plain,
                                      tolerance, abs_tol, max_iter)
    out = _stationary_solve(x0, rhs, c, "rbsor", tolerance, abs_tol,
                            max_iter)
    rbsor_solve.launches += 1
    return out


def jacobi_solve(x0, rhs, c: SORConsts, tolerance, abs_tol, max_iter):
    """(x, r0, res, iterations, converged) of the whole Jacobi solve —
    ``stationary_solve_kernel<true>`` on CUDA."""
    if native.on_cpu(x0):
        return stationary_solve_plain(x0, rhs, c, jacobi_sweep_plain,
                                      tolerance, abs_tol, max_iter)
    out = _stationary_solve(x0, rhs, c, "jacobi", tolerance, abs_tol,
                            max_iter)
    jacobi_solve.launches += 1
    return out


rbsor_solve.launches = 0
jacobi_solve.launches = 0
WRAPPERS = (cg_solve, bicgstab_solve, rbsor_solve, jacobi_solve)


def _make_stationary(kind, nz, ny, nx, inv_dx2, inv_dy2, inv_dz2,
                     inv_factor, omega, tolerance, abs_tol, max_iterations,
                     check_interval, plain):
    if nz != 1 and nz < 3:
        raise ValueError("the whole stationary solves need nz == 1 or "
                         "nz >= 3")
    c = SORConsts(nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, inv_factor, omega,
                  check_interval, max_iterations)
    kernel = rbsor_solve if kind == "rbsor" else jacobi_solve

    def solve(x, rhs):
        if plain:
            return stationary_solve_plain(x, rhs, c, _SWEEPS[kind],
                                          tolerance, abs_tol, max_iterations)
        return kernel(x, rhs, c, tolerance, abs_tol, max_iterations)

    return solve


def make_rbsor_vmem_solve(nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, inv_factor,
                          omega, tolerance, abs_tol, max_iterations,
                          check_interval, plain: bool = False):
    """fn(x, rhs) -> (x, r0, res, iterations, converged): the whole
    Red-Black SOR solve (nz == 1 or nz ≥ 3).  ``plain=True`` runs the
    plain version on a CUDA device too."""
    return _make_stationary("rbsor", nz, ny, nx, inv_dx2, inv_dy2, inv_dz2,
                            inv_factor, omega, tolerance, abs_tol,
                            max_iterations, check_interval, plain)


def make_jacobi_vmem_solve(nz, ny, nx, inv_dx2, inv_dy2, inv_dz2,
                           inv_factor, tolerance, abs_tol, max_iterations,
                           check_interval, plain: bool = False):
    """fn(x, rhs) -> (x, r0, res, iterations, converged): the whole Jacobi
    solve (nz == 1 or nz ≥ 3).  ``plain=True`` as above."""
    return _make_stationary("jacobi", nz, ny, nx, inv_dx2, inv_dy2,
                            inv_dz2, inv_factor, 1.0, tolerance, abs_tol,
                            max_iterations, check_interval, plain)


def make_cg_vmem_solve(nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, scale,
                       tolerance, abs_tol, max_iterations, check_interval,
                       plain: bool = False):
    """fn(x, rhs) -> (x, r0, res, iterations, running): the whole CG/PCG
    solve (nz == 1 or nz ≥ 3).  ``plain=True`` runs the plain version on
    a CUDA device too (a reference switch for checks on the card)."""
    if nz != 1 and nz < 3:
        raise ValueError("the whole-solve CG needs nz == 1 or nz >= 3")
    c = CGConsts(nz, ny, nx, inv_dx2, inv_dy2, inv_dz2, scale,
                 check_interval)
    run = cg_solve_plain if plain else cg_solve

    def solve(x, rhs):
        return run(x, rhs, c, tolerance, abs_tol, max_iterations)

    return solve
