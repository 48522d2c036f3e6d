"""The whole-solve CG kernel for small grids (counterpart of
`cfd_tpu/ops/pallas/vmem_small.py`'s ``make_cg_vmem_solve``, `:243-323`).

The reference runs the entire CG/PCG ``while_loop`` inside one Pallas
kernel with the vectors in VMEM: grids that small (a 100² plane is 40 KB)
are launch latency, not bandwidth, if each pass is its own device call.
Here the loop is one cooperative CUDA launch, ``cg_solve_kernel``
(``cfd_tpu_torch/csrc/cg_kernels.cu``): grid-stride passes over the
interior with grid barriers between them, the vectors in device memory
(in the 50 MB L2 at these sizes), every dot a per-block partial folded in
one order by every block.  The host launches once per solve and reads
nothing.

The TPU layout workarounds are left out: the power-of-two row padding and
the 128-lane padding (`vmem_small.py:17-23`, `:51-65`), the iota-rebuilt
masks and the VMEM budget gate (`:46`); every (nz, ny, nx) with nz == 1 or
nz ≥ 3 runs.

The recursion is the reference kernel's, un-rotated (`:265-305`): the
Jacobi preconditioner enters as the scalar ``scale``, the residual is the
L2 norm of the recursion residual, checked every ``check_interval``
iterations, breakdown at 1e-30 stops the loop, and x gets the Neumann
mirror before and after.  :func:`cg_solve` returns (x, initial residual,
final residual, iterations, running) as 0-d tensors, the reference's
tuple; `solvers.poisson.krylov.make_cg_vmem` turns it into a status.
"""

from __future__ import annotations

import torch

from ...boundary.apply import apply_neumann_scalar
from .. import stencils
from . import native
from .cg_kernels import BREAKDOWN, CGConsts


def cg_solve_plain(x0, rhs, c: CGConsts, tolerance, abs_tol, max_iter):
    """The reference kernel's recursion as plain tensor code; reads the
    stop flag on the host once per iteration."""
    ix = stencils.interior_index(x0)
    mask = stencils.interior_mask(c.shape, torch.bool, x0.device)
    zero = torch.zeros_like(x0)

    def lap(f):
        out = torch.zeros_like(f)
        out[ix] = stencils.laplacian(f, c.inv_dx2, c.inv_dy2, c.inv_dz2)
        return out

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


def cg_solve(x0, rhs, c: CGConsts, tolerance, abs_tol, max_iter):
    """(x, r0, res, iterations, running) — ``cg_solve_kernel``, one
    cooperative launch, on CUDA.  x0 and rhs are left as they were."""
    if native.on_cpu(x0):
        return cg_solve_plain(x0, rhs, c, tolerance, abs_tol, max_iter)
    native.check_cuda(x0, rhs)
    for f in (x0, rhs):
        if tuple(f.shape) != c.shape:
            raise ValueError(f"expected fields of shape {c.shape}, got "
                             f"{tuple(f.shape)}")
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


cg_solve.launches = 0
WRAPPERS = (cg_solve,)


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
