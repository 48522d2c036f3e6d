"""Geometric multigrid Poisson solve and MG-preconditioned CG (counterpart
of `cfd_tpu/solvers/poisson/multigrid.py`).

Vertex-centred V-cycles on 2^k+1 grids with red-black Gauss-Seidel
smoothing, full-weighting restriction and (bi/tri)linear prolongation, in
the Dirichlet-0 correction space of the Krylov solvers (work arrays keep
zero shells; x keeps its Neumann shell, applied before and after — the
convention of ``make_cg``).  Grids must be coarsenable: every active
dimension (n − 1) divisible by 2 down to n ≥ 5 for at least one level,
else the makers return None and the front end raises.

Three makers, each ``make_*(problem, params, dtype, device, plain=False,
...)`` returning ``solve(x, rhs) -> PoissonResult``:

* :func:`make_multigrid` — the standalone V-cycle iteration
  (``Method.MULTIGRID``), 3D and 2D, in the form of the reference's fused
  body (`:310-324`): the sweeps smooth the running iterate directly, the
  last pre- and post-smoothing sweeps emit the residual fields.  Every
  level's sweep, the coarsest 40 included, is the ``rb_sweep`` kernel
  (`ops.kernels.mg_kernels`) on a CUDA tensor and its plain version on
  the CPU or with ``plain=True``.  Gauss-Seidel is affine in (x, b), so
  this is the jnp body's arithmetic: the iteration counts are the same.
* :func:`make_multigrid_vmem` — the whole 2D solve in one kernel launch
  (`ops.kernels.vmem_mg`), the jnp body's correction form.
* :func:`make_mg_cg` — CG preconditioned by one symmetric V-cycle
  (red-first pre-smoothing, black-first post-smoothing: M stays SPD).
  Its operator, dots and recurrence are tensor code, as the reference's
  jnp; the V-cycle's sweeps are the kernel.

The 3D (and 2D ``make_multigrid``) loop runs on the host: the residual
norm of each V-cycle stays on the card and the host reads it only on a
check iteration (``it % check_interval == 0``), plus once for the
already-converged test; ``solve.host_syncs`` holds the count of the last
solve.  MG-CG reads its stop flag once an iteration, as ``make_cg``.

The V-cycle pieces (``_rb_sweep``, ``_fw_axis`` / ``_restrict``,
``_interp_axis`` / ``_prolong``, ``_v_cycle``) live beside the sweep
kernel in `ops.kernels.mg_kernels`, which the whole-solve kernel's plain
version shares; ``_zero_shell`` and ``_lap`` are the problem's
``zero_boundary`` and ``laplacian``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ...core.status import CFDError, Status
from ...ops.kernels import mg_kernels as mgk
from ...ops.kernels.vmem_mg import make_mg_vmem_solve
from .base import (PoissonParams, PoissonProblem, PoissonResult,
                   PoissonStatus)
from .krylov import BREAKDOWN


@dataclasses.dataclass(frozen=True)
class _Level:
    shape: tuple
    inv_dx2: float
    inv_dy2: float
    inv_dz2: float
    inv_factor: float


def _build_levels(problem: PoissonProblem, min_size: int = 5,
                  max_levels: int = 12) -> Optional[List[_Level]]:
    """The 2^k+1 hierarchy (`:49-77`), or None when not coarsenable."""
    levels = []
    nz, ny, nx = problem.shape
    dx, dy, dz = problem.dx, problem.dy, problem.dz
    is_3d = nz > 1
    while len(levels) < max_levels:
        inv_dx2 = 1.0 / (dx * dx)
        inv_dy2 = 1.0 / (dy * dy)
        inv_dz2 = 1.0 / (dz * dz) if dz > 0 else 0.0
        levels.append(_Level(
            (nz, ny, nx), inv_dx2, inv_dy2, inv_dz2,
            1.0 / (2.0 * (inv_dx2 + inv_dy2 + inv_dz2))))
        can = (nx - 1) % 2 == 0 and (ny - 1) % 2 == 0 \
            and nx >= 2 * min_size - 1 and ny >= 2 * min_size - 1
        if is_3d:
            can = can and (nz - 1) % 2 == 0 and nz >= 2 * min_size - 1
        if not can:
            break
        nx = (nx - 1) // 2 + 1
        ny = (ny - 1) // 2 + 1
        dx, dy = dx * 2, dy * 2
        if is_3d:
            nz = (nz - 1) // 2 + 1
            dz = dz * 2
    if len(levels) < 2:
        return None
    return levels


def raise_not_coarsenable(what: str):
    """The error of a multigrid maker that returned None."""
    raise CFDError(Status.ERROR_UNSUPPORTED,
                   f"{what}: grid not coarsenable (needs (n-1) divisible "
                   f"by 2 per active axis)")


def _A(x, problem: PoissonProblem):
    """A = −∇² on the Dirichlet-0 interior."""
    return problem.zero_boundary(-problem.laplacian(x))


def _sweep(plain: bool):
    return mgk.rb_sweep_inplace_plain if plain else mgk.rb_sweep


def _check_smoothing(pre: int, post: int):
    if pre < 1 or post < 1:
        raise ValueError("multigrid needs pre, post >= 1 (the last sweep "
                         "of each emits the residual)")


def _mg_result(x, init_res, res_f, it_f, tol, abs_tol, already, max_iter):
    """The reference's closing rules (`:347-357`): CONVERGED or MAX_ITER,
    iterations 0 when converged before the loop."""
    converged = (res_f < tol) | (res_f < abs_tol) | already
    dev = x.device

    def code(s):
        return torch.full((), int(s), dtype=torch.int32, device=dev)

    status = torch.where(converged, code(PoissonStatus.CONVERGED),
                         code(PoissonStatus.MAX_ITER))
    iterations = torch.where(already, torch.zeros_like(it_f),
                             torch.clamp_max(it_f, max_iter))
    return PoissonResult(x=x, iterations=iterations.to(torch.int32),
                         initial_residual=init_res,
                         final_residual=torch.where(already, init_res,
                                                    res_f),
                         status=status)


def make_multigrid(problem: PoissonProblem, params: PoissonParams,
                   dtype=None, device=None, plain: bool = False,
                   pre: int = 2, post: int = 2):
    """The standalone V-cycle iteration solving ∇²x = rhs (`:262-359`),
    3D (nz ≥ 3) and 2D; None when the grid is not coarsenable.
    ``dtype`` and ``device`` are accepted for the makers' common
    signature (the sweep follows its tensors); ``plain=True`` runs the
    plain sweep on a CUDA device too (a reference switch for checks on
    the card)."""
    levels = _build_levels(problem)
    if levels is None:
        return None
    _check_smoothing(pre, post)
    ci = max(1, int(params.check_interval))
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance
    sweep = _sweep(plain)
    lv0 = levels[0]

    def solve(x, rhs):
        x = problem.neumann_bc(x)
        b = problem.zero_boundary(-(rhs - problem.laplacian(x)))
        # A e = b with A = −∇² Dirichlet-0; x* = x + e
        init_res = torch.sqrt(problem.dot_interior(b, b))
        tol = problem.tolerance_for(params, init_res)
        already = init_res < abs_tol
        e = torch.zeros_like(b)
        r = torch.empty_like(b)
        res, it, syncs = init_res, 0, 1
        running = not bool(already)
        while running and it < max_iter:
            for _ in range(pre - 1):
                sweep(e, b, lv0)
            sweep(e, b, lv0, residual=r)
            de_c = mgk.v_cycle(levels, 1, mgk.restrict(r, levels[1].shape),
                               pre, post, False, sweep)
            e.add_(mgk.prolong(de_c))
            for _ in range(post - 1):
                sweep(e, b, lv0)
            sweep(e, b, lv0, residual=r)
            res_new = torch.sqrt(problem.dot_interior(r, r))
            if it % ci == 0:
                syncs += 1
                running = not bool((res_new < tol) | (res_new < abs_tol))
            it, res = it + 1, res_new
        solve.host_syncs = syncs
        return _mg_result(
            problem.neumann_bc(x + e), init_res, res,
            torch.tensor(it, dtype=torch.int32, device=x.device), tol,
            abs_tol, already, max_iter)

    solve.host_syncs = 0
    return solve


def make_multigrid_vmem(problem: PoissonProblem, params: PoissonParams,
                        dtype=None, device=None, plain: bool = False,
                        pre: int = 2, post: int = 2):
    """The whole 2D multigrid solve in one kernel launch (`:362-401`),
    the same algorithm and status rules as :func:`make_multigrid`; None
    when the grid is 3D or not coarsenable.  ``plain=True`` runs its
    plain version on the card too."""
    levels = _build_levels(problem)
    if levels is None or problem.nz > 1:
        return None
    fn = make_mg_vmem_solve(levels, pre, post, params.tolerance,
                            params.absolute_tolerance,
                            params.max_iterations, params.check_interval,
                            plain=plain)
    abs_tol = params.absolute_tolerance
    max_iter = int(params.max_iterations)

    def solve(x, rhs):
        x_f, init_res, res_f, it_f, _ = fn(x, rhs)
        tol = problem.tolerance_for(params, init_res)
        already = init_res < abs_tol
        return _mg_result(x_f, init_res, res_f, it_f, tol, abs_tol,
                          already, max_iter)

    return solve


def make_mg_cg(problem: PoissonProblem, params: PoissonParams, dtype=None,
               device=None, plain: bool = False, pre: int = 1,
               post: int = 1):
    """CG preconditioned by one symmetric V-cycle (`:404-476`); None when
    the grid is not coarsenable.  ``plain=True`` as in
    :func:`make_multigrid`."""
    levels = _build_levels(problem)
    if levels is None:
        return None
    _check_smoothing(pre, post)
    ci = max(1, int(params.check_interval))
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance
    sweep = _sweep(plain)

    def precond(r):
        return mgk.v_cycle(levels, 0, r, pre, post, True, sweep)

    def solve(x, rhs):
        x = problem.neumann_bc(x)
        r = problem.zero_boundary(problem.laplacian(x) - rhs)
        z = precond(r)
        p = z
        rho = problem.dot_interior(r, z)
        init_res = torch.sqrt(problem.dot_interior(r, r))
        tol = problem.tolerance_for(params, init_res)
        already = init_res < abs_tol
        res, it, running = init_res, 0, not bool(already)
        one = torch.ones_like(rho)
        while running and it < max_iter:
            Ap = _A(p, problem)
            pAp = problem.dot_interior(p, Ap)
            bd = pAp.abs() < BREAKDOWN
            alpha = torch.where(bd, torch.zeros_like(rho),
                                rho / torch.where(bd, one, pAp))
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rho_new = problem.dot_interior(r, z)
            res_new = torch.sqrt(problem.dot_interior(r, r))
            converged = ((res_new < tol) | (res_new < abs_tol)) \
                & (it % ci == 0)
            bd2 = rho.abs() < BREAKDOWN
            beta = rho_new / torch.where(bd2, one, rho)
            stop = converged | bd | bd2
            p = torch.where(stop, p, z + beta * p)
            rho, it, res = rho_new, it + 1, res_new
            running = not bool(stop)
        return _mg_result(
            problem.neumann_bc(x), init_res, res,
            torch.tensor(it, dtype=torch.int32, device=x.device), tol,
            abs_tol, already, max_iter)

    return solve
