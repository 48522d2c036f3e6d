"""The CG pressure solve (counterpart of `cfd_tpu/solvers/poisson/krylov.py`,
`make_cg` `:36-117`, `make_cg_fused` `:120-203`, `make_cg_vmem`
`:206-244`).

Semantics kept exactly (`krylov.py:6-17`):

* operator A = −∇² on the interior with the correction space held at zero
  on the boundary (the reference's calloc'd work vectors,
  `linear_solver_cg.c:103-123`): a symmetric positive-definite Dirichlet-0
  operator, while x keeps Neumann boundaries;
* Neumann BCs applied to x only, before and after the loop;
* convergence on the L2 norm of the recursion residual, relative
  tolerance floored by the absolute one, checked every
  ``check_interval`` iterations;
* breakdown at 1e-30 → STAGNATED;
* the Jacobi preconditioner as the constant diagonal ``inv_factor``.

Three makers, each ``make_*(problem, params, dtype, device, plain=False)``
returning ``solve(x, rhs) -> PoissonResult`` (0-d tensors on the device):

* :func:`make_cg` — the plain twin of the reference's jnp loop;
* :func:`make_cg_fused` — the rotated two-pass loop on the ``lap_dot``
  and ``cg_update`` kernels (3D grids, nz ≥ 3);
* :func:`make_cg_vmem` — the whole solve in one kernel (2D grids).

The reference's loop is a ``lax.while_loop`` on the device.  Here the
fused loop runs on the host, but its scalars stay on the card (see
`ops.kernels.cg_kernels`): the host queues ``CHUNK`` iterations, then
reads the running flag of the chunk before the last one, so the card
never waits for the host and the host waits at most once per chunk.
Iterations queued past the stop are no-ops.  ``solve.host_syncs`` holds
the count of the last solve.

``Precond.MULTIGRID`` runs plain (unpreconditioned) CG in all three
makers, as the reference's do (`krylov.py:37`, `:136-137`; its
``make_cg_vmem`` falls back to ``make_cg``): only the Poisson front end
turns it into ``multigrid.make_mg_cg``.
"""

from __future__ import annotations

import torch

from ...core.status import CFDError, Status
from ...ops.kernels import cg_kernels as cgk
from ...ops.kernels.vmem_small import make_cg_vmem_solve
from .base import (PoissonParams, PoissonProblem, PoissonResult,
                   PoissonStatus, Precond)

BREAKDOWN = cgk.BREAKDOWN
CHUNK = 16  # iterations queued between two reads of the running flag


def _scale(problem: PoissonProblem, params: PoissonParams) -> float:
    return (problem.inv_factor
            if params.preconditioner == Precond.JACOBI else 1.0)


def _result(x, init_res, res_f, it_f, running_f, tol, abs_tol, already,
            max_iter):
    """The reference's closing rules: a last convergence check, the
    iteration count, CONVERGED / STAGNATED / MAX_ITER."""
    converged = (res_f < tol) | (res_f < abs_tol) | already
    iterations = torch.where(already, torch.zeros_like(it_f),
                             torch.clamp_max(it_f, max_iter))
    stagnated = (~converged) & (it_f < max_iter) & (~running_f)

    def code(s):
        return torch.full((), int(s), dtype=torch.int32, device=x.device)

    status = torch.where(converged, code(PoissonStatus.CONVERGED),
                         torch.where(stagnated, code(PoissonStatus.STAGNATED),
                                     code(PoissonStatus.MAX_ITER)))
    return PoissonResult(x=x, iterations=iterations.to(torch.int32),
                         initial_residual=init_res,
                         final_residual=torch.where(already, init_res, res_f),
                         status=status)


def make_cg(problem: PoissonProblem, params: PoissonParams, dtype=None,
            device=None, plain: bool = False):
    """CG / Jacobi-PCG as plain tensor code, the reference's jnp loop
    (`krylov.py:36-117`) step for step; reads the stop flag on the host
    once per iteration.  It has no kernel: ``dtype``, ``device`` and
    ``plain`` are accepted for the makers' common signature."""
    use_precond = params.preconditioner == Precond.JACOBI
    diag_inv = problem.inv_factor
    ci = max(1, int(params.check_interval))
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance

    def A(p):
        return problem.zero_boundary(-problem.laplacian(p))

    def precond(r):
        return diag_inv * r if use_precond else r

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
            Ap = A(p)
            p_dot_Ap = problem.dot_interior(p, Ap)
            bd1 = p_dot_Ap.abs() < BREAKDOWN
            alpha = rho / torch.where(bd1, one, p_dot_Ap)
            x = torch.where(bd1, x, x + alpha * p)
            r = torch.where(bd1, r, r - alpha * Ap)
            z = precond(r)
            rho_new = problem.dot_interior(r, z)
            check = it % ci == 0
            if use_precond:
                # ⟨r, r⟩ is an extra sweep here: only on check iterations
                res_new = (torch.sqrt(problem.dot_interior(r, r)) if check
                           else res)
            else:
                res_new = torch.sqrt(rho_new)
            conv = ((res_new < tol) | (res_new < abs_tol)) & check
            bd2 = rho.abs() < BREAKDOWN
            beta = rho_new / torch.where(bd2, one, rho)
            stop = conv | bd1 | bd2
            p = torch.where(stop, p, z + beta * p)
            rho, it = rho_new, it + 1
            res = torch.where(bd1, res, res_new)
            running = not bool(stop)
        dev = x.device
        return _result(problem.neumann_bc(x), init_res, res,
                       torch.tensor(it, dtype=torch.int32, device=dev),
                       torch.tensor(running, device=dev), tol, abs_tol,
                       already, max_iter)

    return solve


def make_cg_fused(problem: PoissonProblem, params: PoissonParams,
                  dtype=None, device=None, plain: bool = False):
    """CG on the two fused passes (`krylov.py:120-203`): the same
    recursion with the loop rotated so the search-direction update rides
    the operator pass.  3D grids (nz ≥ 3).  On a CUDA device the passes
    launch the kernels; on the CPU, or with ``plain=True`` on the card,
    their plain versions run in the same loop."""
    nz, ny, nx = problem.shape
    if nz < 3:
        raise CFDError(Status.ERROR_INVALID,
                       "the fused CG passes need a 3D grid (nz >= 3)")
    scale = _scale(problem, params)
    consts = cgk.CGConsts(nz, ny, nx, problem.inv_dx2, problem.inv_dy2,
                          problem.inv_dz2, scale, params.check_interval)
    max_iter = int(params.max_iterations)
    abs_tol = params.absolute_tolerance

    def solve(x, rhs):
        dev = x.device
        ops = cgk.CGPasses(consts, dev, plain=plain)
        x = problem.neumann_bc(x)            # the solver's own buffer
        r = problem.zero_boundary(problem.laplacian(x) - rhs)
        rr0 = problem.dot_interior(r, r)
        init_res = torch.sqrt(rr0)
        tol = problem.tolerance_for(params, init_res)
        already = init_res < abs_tol
        abs_t = torch.full((), abs_tol, dtype=rr0.dtype, device=dev)
        st = cgk.new_state(scale * rr0, init_res, tol, abs_t, ~already)
        p, pn, ap = torch.zeros_like(r), torch.empty_like(r), \
            torch.empty_like(r)

        syncs, launched, pending = 0, 0, None
        while launched < max_iter:
            n = min(CHUNK, max_iter - launched)
            for _ in range(n):
                ops.lap_dot(r, p, pn, ap, st)
                ops.update(x, r, pn, ap, st)
                p, pn = pn, p
            launched += n
            if dev.type != "cuda":
                if not bool(st[cgk.RUNNING] > 0):
                    break
                continue
            # read the previous chunk's flag while this one runs
            flag = torch.empty((), dtype=st.dtype, pin_memory=True)
            flag.copy_(st[cgk.RUNNING], non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            if pending is not None:
                pending[0].synchronize()
                syncs += 1
                if not pending[1].item() > 0:
                    break
            pending = (event, flag)
        solve.host_syncs = syncs

        return _result(problem.neumann_bc(x), init_res, st[cgk.RES],
                       st[cgk.IT].to(torch.int32), st[cgk.RUNNING] > 0,
                       tol, abs_tol, already, max_iter)

    solve.host_syncs = 0
    return solve


def make_cg_vmem(problem: PoissonProblem, params: PoissonParams,
                 dtype=None, device=None, plain: bool = False):
    """The whole CG/PCG solve in one kernel launch
    (`krylov.py:206-244`), for 2D grids (and any nz ≥ 3).  ``plain=True``
    runs its plain version on the card too."""
    nz, ny, nx = problem.shape
    fn = make_cg_vmem_solve(nz, ny, nx, problem.inv_dx2, problem.inv_dy2,
                            problem.inv_dz2, _scale(problem, params),
                            params.tolerance, params.absolute_tolerance,
                            params.max_iterations, params.check_interval,
                            plain=plain)
    abs_tol = params.absolute_tolerance
    max_iter = int(params.max_iterations)

    def solve(x, rhs):
        x_f, init_res, res_f, it_f, running_f = fn(x, rhs)
        tol = problem.tolerance_for(params, init_res)
        already = init_res < abs_tol
        return _result(x_f, init_res, res_f, it_f, running_f, tol,
                       abs_tol, already, max_iter)

    return solve
